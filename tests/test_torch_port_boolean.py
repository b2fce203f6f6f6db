"""tfhe_tpu_torch.models.boolean against tfhe_tpu.models.boolean, on the CPU.

* With the JAX package's TOY_BOOLEAN keys and ciphertexts carried across
  (one JAX keygen for the file), every gate, not_ and mux equals the JAX
  gate bit for bit (u64).
* With the port's own keys, the truth tables and a chained gate decrypt
  right, at TOY_BOOLEAN and at a k=2, level-3 toy set shaped like
  BOOLEAN_PARAMS_128 (the loop of external products).
* At that k=2, level-3 shape the GGSW rows of encrypt_ggsw_bits, 9 per
  secret, hold the JAX package's gadget values in the JAX row order.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu import params as jp
from tfhe_tpu.core import ggsw as jggsw
from tfhe_tpu.core.glwe import decrypt_glwe as jax_decrypt_glwe
from tfhe_tpu.core.keys import GlweSecretKey as JaxGlweSecretKey
from tfhe_tpu.models import boolean as jb
from tfhe_tpu.ops.folded_ntt import get_folded_engine as jax_engine
from tfhe_tpu.rng import FheRng as JaxRng
from tfhe_tpu_torch import _u64, convert
from tfhe_tpu_torch import params as tp
from tfhe_tpu_torch.core import bootstrap as tbt
from tfhe_tpu_torch.core import ggsw as tggsw
from tfhe_tpu_torch.core.glwe import decrypt_glwe
from tfhe_tpu_torch.core.keys import GlweSecretKey
from tfhe_tpu_torch.models import boolean as tb
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


A = [0, 0, 1, 1, 0, 0, 1, 1]
B = [0, 1, 0, 1, 0, 1, 0, 1]
C = [0, 0, 0, 0, 1, 1, 1, 1]
TRUTH = {
    "and_": lambda a, b: a & b,
    "or_": lambda a, b: a | b,
    "nand": lambda a, b: 1 - (a & b),
    "nor": lambda a, b: 1 - (a | b),
    "xor_": lambda a, b: a ^ b,
    "xnor": lambda a, b: 1 - (a ^ b),
}


def _k2_level3(pk):
    """TOY_BOOLEAN at BOOLEAN_PARAMS_128's GLWE shape (k=2, PBS level 3 /
    base_log 9), N = 128 (test data only)."""
    return dataclasses.replace(
        pk.TOY_BOOLEAN, name="TOY_BOOLEAN_K2_L3", glwe_dimension=2, pbs=pk.GadgetParams(base_log=9, level=3)
    )


GATES = [*TRUTH, "not_", "mux"]


def _gate(mod, sk, name, a, b, c):
    """Gate `name` of package `mod`: not_(a), mux(c, a, b), else gate(a, b)."""
    if name == "not_":
        return mod.not_(sk, a)
    if name == "mux":
        return mod.mux(sk, c, a, b)
    return getattr(mod, name)(sk, a, b)


def _expected(name):
    a, b, c = (np.asarray(v, dtype=np.int64) for v in (A, B, C))
    if name == "not_":
        return 1 - a
    if name == "mux":
        return np.where(c == 1, a, b)
    return TRUTH[name](a, b)


@pytest.fixture(scope="module")
def carried():
    """JAX TOY_BOOLEAN keys (seed 31) carried across, three JAX-encrypted
    bit vectors covering the input combinations, and every JAX gate on them."""
    ck, sk = jb.keygen(jp.TOY_BOOLEAN, seed=31)
    tck, tsk = convert.boolean_keys_from_reference(ck, sk, device="cpu")
    rng = JaxRng(32)
    cts = [jb.encrypt(ck, jnp.asarray(v, dtype=jnp.uint64), rng) for v in (A, B, C)]
    want = {name: np.asarray(_gate(jb, sk, name, *cts)) for name in GATES}
    return tck, tsk, [convert.u64_tensor(np.asarray(x)) for x in cts], want


def _dec(ck, ct):
    return tb.decrypt(ck, ct).numpy().astype(np.int64)


@pytest.mark.parametrize("gate", GATES)
def test_gate_matches_reference(carried, gate):
    tck, tsk, cts, want = carried
    got = _gate(tb, tsk, gate, *cts)
    np.testing.assert_array_equal(_u64.u64_to_numpy(got), want[gate])
    np.testing.assert_array_equal(_dec(tck, got), _expected(gate))


def test_carried_keys_take_the_loop(carried):
    _, tsk, _, _ = carried
    assert not tbt.uses_fused_cmux(tsk.bsk, tsk.params.glwe_dimension + 1)


@pytest.fixture(scope="module", params=["TOY_BOOLEAN", "TOY_BOOLEAN_K2_L3"])
def own(request):
    params = tp.TOY_BOOLEAN if request.param == "TOY_BOOLEAN" else _k2_level3(tp)
    ck, sk = tb.keygen(params, seed=3, device="cpu")
    rng = FheRng(4, "cpu")
    return ck, sk, [tb.encrypt(ck, v, rng) for v in (A, B, C)]


def test_own_keys_truth_tables(own):
    ck, sk, cts = own
    np.testing.assert_array_equal(_dec(ck, cts[0]), np.asarray(A))
    for name in GATES:
        np.testing.assert_array_equal(_dec(ck, _gate(tb, sk, name, *cts)), _expected(name), err_msg=name)


def test_own_keys_chained_gate(own):
    """xnor(and(a, b), or(not c, b)): gate outputs feed gates."""
    ck, sk, (a, b, c) = own
    got = tb.xnor(sk, tb.and_(sk, a, b), tb.or_(sk, tb.not_(sk, c), b))
    a_, b_, c_ = (np.asarray(v) for v in (A, B, C))
    np.testing.assert_array_equal(_dec(ck, got), 1 - ((a_ & b_) ^ ((1 - c_) | b_)))


def test_ggsw_rows_match_reference_at_k2_level3():
    """encrypt_ggsw_bits at (k+1)*level = 9 rows, noiseless, on a JAX GLWE
    key carried across: each row decrypts to the JAX row's phase, so the
    rows hold the same gadget values in the same order."""
    params_j = _k2_level3(jp)
    n, k = params_j.polynomial_size, params_j.glwe_dimension
    key = np.random.default_rng(7).integers(0, 2, size=(k, n), dtype=np.uint64)
    m = np.array([0, 1, 1, 3], dtype=np.uint64)
    zero_j = jp.NoiseDistribution.zero()
    g_j = jggsw.encrypt_ggsw_bits(
        JaxGlweSecretKey(key=jnp.asarray(key)), jnp.asarray(m), params_j.pbs, JaxRng(8), zero_j, jax_engine(n)
    )
    want = np.asarray(jax_decrypt_glwe(JaxGlweSecretKey(key=jnp.asarray(key)), g_j, jax_engine(n)))
    eng = get_folded_engine(n, device="cpu")
    tkey = GlweSecretKey(key=convert.u64_tensor(key))
    g_t = tggsw.encrypt_ggsw_bits(
        tkey, convert.u64_tensor(m), tp.GadgetParams(base_log=9, level=3), FheRng(9, "cpu"), tp.NoiseDistribution.zero(), eng
    )
    assert tuple(g_t.shape) == (4, (k + 1) * 3, k + 1, n)
    np.testing.assert_array_equal(_u64.u64_to_numpy(decrypt_glwe(tkey, g_t, eng)), want)
