"""The shortint slice of tfhe_tpu_torch as a whole, on the CPU.

* The loop path at k=2 (a k=2, level-1 toy set shaped like
  PARAM_MESSAGE_1_CARRY_1_KS_PBS_TUNIFORM_2M128): with JAX keys carried
  across, the port's blind_rotate and keyswitch_pbs equal JAX's lax.scan
  of external products bit for bit; the port's own k=2 keys decrypt right.
  (The fused level-1 k=1 form against the JAX package is tested in
  test_torch_port_blind_rotate.py, on the same carried keys as its other
  tests.)
* With its own keygen, apply_lut, bivariate_pbs and mul decrypt to the
  clear results, and degree bookkeeping matches the JAX package.
* The package imports neither jax nor tfhe_tpu, and its entry points
  refuse to fall back to the CPU when no device is named.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu import params as jp
from tfhe_tpu.core import bootstrap as jbt
from tfhe_tpu.core.lwe import keyswitch as jax_keyswitch
from tfhe_tpu.core.lwe import sample_extract as jax_sample_extract
from tfhe_tpu.models import shortint as jsi
from tfhe_tpu.rng import FheRng as JaxRng
from tfhe_tpu_torch import _u64, convert
from tfhe_tpu_torch import params as tp
from tfhe_tpu_torch.core import bootstrap as tbt
from tfhe_tpu_torch.ml.linear import GlweLinearLayerExecutor
from tfhe_tpu_torch.models import boolean as tbo
from tfhe_tpu_torch.models import glwe_matmul as tgm
from tfhe_tpu_torch.models import integer as ti
from tfhe_tpu_torch.models import shortint as tsi
from tfhe_tpu_torch.ops.folded_ntt import get_folded_engine
from tfhe_tpu_torch.rng import FheRng


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several test processes side by side; the port's many
    small tensor ops run fastest, and slow the other processes least, on
    one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = Path(__file__).resolve().parents[1]
N = 256


def _loop_k2_params(pk):
    """A k=2, level-1 variant of TOY_SHORTINT (test data only): the shape of
    PARAM_MESSAGE_1_CARRY_1_KS_PBS_TUNIFORM_2M128 (k=2, level 1, base_log 17)
    at N = 128, which takes the loop of external products."""
    return dataclasses.replace(
        pk.TOY_SHORTINT, name="LOOP_K2", glwe_dimension=2, pbs=pk.GadgetParams(base_log=17, level=1)
    )


@pytest.fixture(scope="module")
def loop_k2():
    """JAX keys of the k=2 set carried across, six ciphertexts, a LUT and
    JAX keyswitch -> blind_rotate (its lax.scan of external products)."""
    params = _loop_k2_params(jp)
    ck, sk = jsi.keygen(params, seed=11)
    tck, tsk = convert.keys_from_reference(ck, sk, device="cpu")
    vals = jnp.asarray([0, 1, 2, 3, 2, 1], dtype=jnp.uint64)
    ct = jsi.encrypt(ck, vals, JaxRng(12))
    lut = jsi.generate_lut(params, np.asarray([(3 * v + 1) % 4 for v in range(16)], dtype=np.uint64))
    small = jax_keyswitch(ct.ct, sk.ksk)
    rotated = np.asarray(jbt.blind_rotate(lut, small, sk.bsk, jsi.engine_for(params)))
    return params, ck, tck, tsk, vals, ct, lut, small, rotated


def test_loop_k2_blind_rotate_matches_reference(loop_k2):
    _, _, tck, tsk, _, _, lut, small, rotated = loop_k2
    assert tsk.bsk.bsk_ntt.shape[1:3] == (3, 3) and not tbt.uses_fused_cmux(tsk.bsk, 3)
    got = tbt.blind_rotate(
        convert.u64_tensor(lut), convert.u64_tensor(small), tsk.bsk, tsi.engine_for(tck.params, "cpu")
    )
    np.testing.assert_array_equal(_u64.u64_to_numpy(got), rotated)


def test_loop_k2_keyswitch_pbs_matches_reference(loop_k2):
    params, ck, tck, tsk, vals, ct, lut, _, rotated = loop_k2
    want = np.asarray(jax_sample_extract(jnp.asarray(rotated), 0))
    got = tbt.keyswitch_pbs(
        convert.u64_tensor(ct.ct), convert.u64_tensor(lut), tsk.bsk, tsk.ksk, get_folded_engine(128, device="cpu")
    )
    np.testing.assert_array_equal(_u64.u64_to_numpy(got), want)
    out = tsi.Ciphertext(ct=got, params=tck.params, degree=3, noise_level=1)
    np.testing.assert_array_equal(tsi.decrypt(tck, out).numpy(), (3 * np.asarray(vals) + 1) % 4)


def test_loop_k2_own_keygen_decrypts():
    params = _loop_k2_params(tp)
    ck, sk = tsi.keygen(params, seed=13, device="cpu")
    assert sk.bsk.bsk_ntt.shape[1:3] == (3, 3) and not tbt.uses_fused_cmux(sk.bsk, 3)
    vals = torch.tensor([0, 1, 2, 3, 3, 2, 1, 0])
    c = tsi.encrypt(ck, vals, FheRng(14, device="cpu"))
    ident = tsi.apply_lut(sk, c, tsi.generate_lut(params, lambda v: v, device="cpu"), 3)
    assert torch.equal(tsi.decrypt(ck, ident), vals)
    flip = tsi.apply_function(sk, c, lambda v: (1 - v) % 4)
    assert torch.equal(tsi.decrypt(ck, flip), (1 - vals) % 4)


@pytest.fixture(scope="module")
def own_keys():
    params = dataclasses.replace(
        tp.TOY_SHORTINT, name="FUSED_TEST", lwe_dimension=12, polynomial_size=N,
        pbs=tp.GadgetParams(base_log=23, level=1),
    )
    ck, sk = tsi.keygen(params, seed=7, device="cpu")
    return params, ck, sk


def test_own_keygen_ops_decrypt(own_keys):
    params, ck, sk = own_keys
    rng = FheRng(8, device="cpu")
    a_vals = torch.tensor([0, 1, 2, 3, 3, 2, 1, 0])
    b_vals = torch.tensor([0, 0, 1, 1, 2, 3, 3, 2])
    a = tsi.encrypt(ck, a_vals, rng)
    b = tsi.encrypt(ck, b_vals, rng)
    assert torch.equal(tsi.decrypt(ck, a), a_vals)
    ident = tsi.apply_lut(sk, a, tsi.generate_lut(params, lambda v: v, device="cpu"), 3)
    assert torch.equal(tsi.decrypt(ck, ident), a_vals)
    tri = tsi.apply_function(sk, a, lambda v: (3 * v) % 4)
    assert torch.equal(tsi.decrypt(ck, tri), (3 * a_vals) % 4)
    bi = tsi.bivariate_pbs(sk, a, b, lambda x, y: (x - y) % 4)
    assert torch.equal(tsi.decrypt(ck, bi), (a_vals - b_vals) % 4)
    prod = tsi.mul(sk, a, b)
    assert torch.equal(tsi.decrypt(ck, prod), (a_vals * b_vals) % 16)
    s = tsi.add(a, b)
    assert torch.equal(tsi.decrypt(ck, tsi.message_extract(sk, s)), (a_vals + b_vals) % 4)
    assert torch.equal(tsi.decrypt(ck, tsi.carry_extract(sk, s)), (a_vals + b_vals) // 4)
    assert torch.equal(tsi.decrypt_message(ck, tsi.sub(a, b)), (a_vals - b_vals) % 4)


def test_loop_branch_decrypts():
    """Level-2 gadget (TOY_SHORTINT): the external-product loop path."""
    ck, sk = tsi.keygen(tp.TOY_SHORTINT, seed=9, device="cpu")
    a_vals = torch.tensor([0, 1, 2, 3])
    a = tsi.encrypt(ck, a_vals, FheRng(10, device="cpu"))
    out = tsi.apply_function(sk, a, lambda v: (v * v) % 4)
    assert torch.equal(tsi.decrypt(ck, out), (a_vals * a_vals) % 4)


def test_degree_bookkeeping_and_luts_match_reference():
    jp_, tp_ = jp.TOY_SHORTINT, tp.TOY_SHORTINT
    ja = jsi.trivial_encrypt(jp_, jnp.asarray([1, 2, 3], dtype=jnp.uint64))
    jb = jsi.trivial_encrypt(jp_, jnp.asarray([3, 0, 2], dtype=jnp.uint64))
    ta = tsi.trivial_encrypt(tp_, torch.tensor([1, 2, 3]), device="cpu")
    tb = tsi.trivial_encrypt(tp_, torch.tensor([3, 0, 2]), device="cpu")
    pairs = [
        (jsi.add(ja, jb), tsi.add(ta, tb)),
        (jsi.scalar_add(ja, 2), tsi.scalar_add(ta, 2)),
        (jsi.scalar_mul(ja, 3), tsi.scalar_mul(ta, 3)),
        (jsi.neg(ja), tsi.neg(ta)),
        (jsi.sub(ja, jb), tsi.sub(ta, tb)),
        (jsi.neg(jsi.add(ja, jb)), tsi.neg(tsi.add(ta, tb))),
    ]
    for j, t in pairs:
        assert (t.degree, t.noise_level) == (j.degree, j.noise_level)
        np.testing.assert_array_equal(_u64.u64_to_numpy(t.ct), np.asarray(j.ct))
    f = lambda v: (5 * v + 1) % 16
    np.testing.assert_array_equal(
        _u64.u64_to_numpy(tsi.generate_lut(tp_, f, device="cpu")), np.asarray(jsi.generate_lut(jp_, f))
    )
    g = lambda x, y: x * y + 1
    np.testing.assert_array_equal(
        _u64.u64_to_numpy(tsi.generate_lut_bivariate(tp_, g, device="cpu")),
        np.asarray(jsi.generate_lut_bivariate(jp_, g)),
    )


def test_package_imports_no_jax():
    """Every module of the port, found by a walk of the tree (later ones
    too), imports in a fresh process without jax, tfhe_tpu, sklearn or
    pandas."""
    pkg = REPO / "tfhe_tpu_torch"
    mods = sorted(
        ".".join(("tfhe_tpu_torch", *f.relative_to(pkg).with_suffix("").parts)).removesuffix(".__init__")
        for f in pkg.rglob("*.py")
        if "_build" not in f.relative_to(pkg).parts
    )
    assert len(mods) > 80 and "tfhe_tpu_torch.parallel._comm" in mods and "tfhe_tpu_torch.core" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tfhe_tpu', 'sklearn', 'pandas'))\n"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_need_a_device_when_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsi.keygen(tp.TOY_SHORTINT, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_folded_engine(N)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsi.generate_lut(tp.TOY_SHORTINT, lambda v: v)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsi.trivial_encrypt(tp.TOY_SHORTINT, [1])
    with pytest.raises(RuntimeError, match="CUDA"):
        tsi.keygen(tp.TOY_SHORTINT, seed=0, multibit_group=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsi.keygen(tp.PARAM_MULTI_BIT_GROUP_3_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ti.trivial_radix(tp.TOY_SHORTINT, [1], 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        ti.trivial_radix_bigint(tp.TOY_SHORTINT, [1], 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbo.keygen(tp.TOY_BOOLEAN, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgm.create_private_key(tp.TOY_MATMUL, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgm.prepare_clear_weights(tp.TOY_MATMUL, np.ones((4, 2), dtype=np.int64))
    with pytest.raises(RuntimeError, match="CUDA"):
        GlweLinearLayerExecutor(np.ones((4, 2)), params=tp.TOY_MATMUL).keygen(seed=0)
