"""Encrypted dataframes and the p_error search of tfhe_tpu_torch.ml against
the JAX package, on the CPU.

One JAX shortint keygen at TOY_SHORTINT (a JAX DataFrameClient, seed 0,
4-bit values) and the frames of tests/test_api_extended.py (3 rows each),
encrypted by JAX; the keys and ciphertexts are carried to the port, and the
port's DataFrameClient takes the carried keys by patching its si.keygen:
* merge (left and right): the output blocks bit-exact, the degree tuples
  and the PBS counts equal;
* decrypt_to_pandas gives JAX's frame and pandas' own merge;
* save writes JAX's bytes, and each package loads the other's file;
* the port's own keys merge right too;
* binary_search_p_error gives the same history, search_p_error_for_module
  on a QuantizedModule (DISABLE and SIMULATE, no keygen) the same result,
  select_crypto_params the same set from 2^-40 to 2^-5.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from tfhe_tpu import params as jp
from tfhe_tpu.ml import p_error_search as jpe
from tfhe_tpu.ml import pandas as jpd
from tfhe_tpu.ml.quantized_module import QuantizedGemm as JaxGemm
from tfhe_tpu.ml.quantized_module import QuantizedModule as JaxModule
from tfhe_tpu.ml.quantized_module import QuantizedTLU as JaxTLU
from tfhe_tpu.models import integer as jri
from tfhe_tpu_torch import _u64, convert
from tfhe_tpu_torch import params as tp
from tfhe_tpu_torch.ml import p_error_search as tpe
from tfhe_tpu_torch.ml import pandas as tpd
from tfhe_tpu_torch.ml.quantized_module import QuantizedGemm, QuantizedModule, QuantizedTLU
from tfhe_tpu_torch.models import integer as tri
from tfhe_tpu_torch.models import shortint as tsi

LEFT = {"k": [1, 2, 3], "a": [5, 6, 7]}
RIGHT = {"k": [2, 3, 9], "b": [10, 11, 12]}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several test processes side by side; the port's many
    small tensor ops run fastest, and slow the other processes least, on
    one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_port(edf, sk):
    cols = {
        name: tri.RadixCiphertext(blocks=convert.u64_tensor(c.blocks), params=tp.TOY_SHORTINT, degrees=c.degrees)
        for name, c in edf.columns.items()
    }
    return tpd.EncryptedDataFrame(columns=cols, n_rows=edf.n_rows, value_bits=edf.value_bits, sk=sk)


@pytest.fixture(scope="module")
def frames():
    """The JAX client and frames, the port client on the carried keys and
    the carried frames."""
    jc = jpd.DataFrameClient(seed=0, value_bits=4)
    tck, tsk = convert.keys_from_reference(jc.ck, jc.sk, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsi, "keygen", lambda *a, **k: (tck, tsk))
        tc = tpd.DataFrameClient(value_bits=4, device="cpu")
    jl, jr = jc.encrypt_from_pandas(pd.DataFrame(LEFT)), jc.encrypt_from_pandas(pd.DataFrame(RIGHT))
    return jc, tc, jl, jr, _to_port(jl, tc.sk), _to_port(jr, tc.sk)


@pytest.fixture(scope="module")
def merges(frames):
    """Left and right merges in both packages, with their PBS counts."""
    jc, tc, jl, jr, tl, tr = frames
    count = [0]
    orig = jri._pbs

    def counted(sk, ct, lut):
        count[0] += int(np.prod(ct.shape[:-1]))
        return orig(sk, ct, lut)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jri, "_pbs", counted)
        for how in ("left", "right"):
            count[0] = 0
            tri._pbs.rows = 0
            jm = jl.merge(jr, on="k", how=how)
            tm = tl.merge(tr, on="k", how=how)
            out[how] = (jm, count[0], tm, tri._pbs.rows)
    return out


@pytest.mark.parametrize("how", ["left", "right"])
def test_merge_matches_reference(merges, how):
    jm, jcount, tm, tcount = merges[how]
    assert tm.column_names == jm.column_names and tm.n_rows == jm.n_rows
    for name in jm.column_names:
        np.testing.assert_array_equal(_u64.u64_to_numpy(tm.columns[name].blocks), np.asarray(jm.columns[name].blocks))
        assert tm.columns[name].degrees == jm.columns[name].degrees, name
    assert tcount == jcount > 0


@pytest.mark.parametrize("how", ["left", "right"])
def test_decrypt_to_pandas_matches_reference(frames, merges, how):
    jc, tc = frames[:2]
    jm, _, tm, _ = merges[how]
    got = tc.decrypt_to_pandas(tm)
    pd.testing.assert_frame_equal(got, jc.decrypt_to_pandas(jm))
    left, right = (LEFT, RIGHT) if how == "left" else (RIGHT, LEFT)
    want = pd.DataFrame(left).merge(pd.DataFrame(right), on="k", how="left").fillna(0).astype(int)
    for col in want.columns:
        np.testing.assert_array_equal(got[col].values, want[col].values)


def test_save_bytes_and_cross_load(frames, tmp_path):
    jc, tc, jl, _, tl, _ = frames
    jpath, tpath = tmp_path / "jax.edf", tmp_path / "port.edf"
    jl.save(str(jpath))
    tl.save(str(tpath))
    assert tpath.read_bytes() == jpath.read_bytes()
    port_loaded = tpd.EncryptedDataFrame.load(str(jpath), tc.sk)
    jax_loaded = jpd.EncryptedDataFrame.load(str(tpath), jc.sk)
    assert port_loaded.n_rows == 3 and port_loaded.value_bits == 4
    pd.testing.assert_frame_equal(tc.decrypt_to_pandas(port_loaded), jc.decrypt_to_pandas(jax_loaded))
    np.testing.assert_array_equal(tc.decrypt_to_pandas(port_loaded)["a"].values, LEFT["a"])


def test_merge_with_the_port_s_own_keys():
    """A port client keys and encrypts on its own (TOY_SHORTINT by
    default), and the merge decrypts to pandas' merge."""
    cl = tpd.DataFrameClient(seed=3, value_bits=4, device="cpu")
    assert cl.params.name == "TOY_SHORTINT"
    merged = cl.encrypt_from_pandas(pd.DataFrame(LEFT)).merge(cl.encrypt_from_pandas(pd.DataFrame(RIGHT)), on="k")
    want = pd.DataFrame(LEFT).merge(pd.DataFrame(RIGHT), on="k", how="left").fillna(0).astype(int)
    got = cl.decrypt_to_pandas(merged)
    for col in ("k", "a", "b"):
        np.testing.assert_array_equal(got[col].values, want[col].values)


def test_client_needs_a_device_when_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpd.DataFrameClient()


def test_value_out_of_range_raises(frames):
    tc = frames[1]
    with pytest.raises(ValueError, match="4-bit"):
        tc.encrypt_from_pandas(pd.DataFrame({"k": [16]}))


# -- p_error search --------------------------------------------------------------


def test_binary_search_history_matches_reference():
    def eval_fn(p_error):
        return 0.99 if p_error < 2**-10 else 0.8

    want = jpe.binary_search_p_error(eval_fn, target_accuracy=0.99, tolerance=0.005)
    got = tpe.binary_search_p_error(eval_fn, target_accuracy=0.99, tolerance=0.005)
    assert (got.p_error, got.accuracy, got.history) == (want.p_error, want.accuracy, want.history)


def _module(pkg):
    gemm, tlu, module = (JaxGemm, JaxTLU, JaxModule) if pkg == "jax" else (QuantizedGemm, QuantizedTLU, QuantizedModule)
    rng = np.random.default_rng(4)
    w = rng.normal(0, 1.0, (8, 2))
    qm = module([gemm(weights=w, bias=None), tlu(fn=lambda v: np.maximum(v, 0), n_bits=4)], n_bits=4)
    x = rng.normal(0, 1, (64, 8))
    y = (x @ w).argmax(axis=-1)
    qm.calibrate(x)
    return qm, x, y


def test_search_p_error_for_module_matches_reference():
    jqm, x, y = _module("jax")
    tqm, _, _ = _module("port")
    for mode in ("disable", "simulate"):
        np.testing.assert_array_equal(tqm.forward(x, mode), jqm.forward(x, mode))
    want = jpe.search_p_error_for_module(jqm, x, y, tolerance=0.05)
    got = tpe.search_p_error_for_module(tqm, x, y, tolerance=0.05)
    assert (got.p_error, got.accuracy, got.history) == (want.p_error, want.accuracy, want.history)
    assert len(got.history) >= 2


# a ladder with TOY_SHORTINT (failure probability ~2^-30) at its cheap end, so
# the pick moves across the range
LADDER = ["TOY_SHORTINT", "PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128",
          "PARAM_MULTI_BIT_GROUP_3_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128"]


@pytest.mark.parametrize("log2_p", list(range(-40, -4)))
def test_select_crypto_params_matches_reference(log2_p):
    def pick(mod, params, p_error, ladder):
        try:
            chosen, pf = mod.select_crypto_params(p_error, candidates=ladder and [params.by_name(n) for n in ladder])
        except ValueError:
            return None
        return chosen.name, pf

    for ladder in (None, LADDER):
        assert pick(tpe, tp, 2.0**log2_p, ladder) == pick(jpe, jp, 2.0**log2_p, ladder)
    assert pick(tpe, tp, 2.0**log2_p, LADDER)[0] == ("TOY_SHORTINT" if log2_p >= -29 else LADDER[1])


def test_pbs_cost_matches_reference():
    for name in tp.registry():
        p = tp.by_name(name)
        if hasattr(p, "lwe_dimension") and hasattr(p, "pbs"):
            assert tpe.pbs_cost(p) == jpe.pbs_cost(jp.by_name(name)), name
