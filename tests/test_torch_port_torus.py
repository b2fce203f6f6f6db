"""tfhe_tpu_torch torus / u64 helpers / params vs the JAX package, bit for bit.

Inputs are random u64 from numpy (a quarter of them >= 2^63, where a
signed shift or division would differ); both packages run on the CPU.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu import params as jp
from tfhe_tpu import torus as jt
from tfhe_tpu.core import lwe as jl
from tfhe_tpu_torch import _u64
from tfhe_tpu_torch import params as tp
from tfhe_tpu_torch import torus as tt
from tfhe_tpu_torch.convert import params_from_reference, u64_tensor
from tfhe_tpu_torch.core import lwe as tl
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


def _rand_u64(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**64, size=shape, dtype=np.uint64)
    x.flat[:4] = [0, 2**63, 2**64 - 1, 2**63 - 1]
    return x


def _same(t: torch.Tensor, j):
    np.testing.assert_array_equal(_u64.u64_to_numpy(t), np.asarray(j).astype(np.uint64))


@pytest.mark.parametrize("delta,modulus", [(2**59, 16), (2**60, 8), (2**63, 2)])
def test_encode_decode(delta, modulus):
    x = _rand_u64(0, (4, 64))
    _same(tt.decode(u64_tensor(x), delta, modulus), jt.decode(jnp.asarray(x), delta, modulus))
    m = np.arange(64, dtype=np.uint64) % modulus
    _same(tt.encode(torch.from_numpy(m.astype(np.int64)), delta), jt.encode(jnp.asarray(m), delta))
    got = tt.decode_signed(u64_tensor(x), delta, modulus).numpy()
    np.testing.assert_array_equal(got, np.asarray(jt.decode_signed(jnp.asarray(x), delta, modulus)))


@pytest.mark.parametrize("msb", [1, 9, 12, 23, 53, 63, 64])
def test_round_to_msb(msb):
    x = _rand_u64(1, (256,))
    _same(tt.round_to_msb(u64_tensor(x), msb), jt.round_to_msb(jnp.asarray(x), msb))


@pytest.mark.parametrize("base_log,level", [(23, 1), (3, 5), (12, 2), (4, 3)])
def test_signed_decompose_and_recompose(base_log, level):
    x = _rand_u64(2, (3, 128))
    g_t = tp.GadgetParams(base_log=base_log, level=level)
    g_j = jp.GadgetParams(base_log=base_log, level=level)
    d_t = tt.signed_decompose(u64_tensor(x), g_t)
    d_j = jt.signed_decompose(jnp.asarray(x), g_j)
    _same(d_t, d_j)
    _same(tt.recompose(d_t, g_t), jt.recompose(d_j, g_j))


@pytest.mark.parametrize("log2_target", [9, 12, 39])
def test_mod_switch(log2_target):
    x = _rand_u64(3, (512,))
    _same(tt.mod_switch(u64_tensor(x), log2_target), jt.mod_switch(jnp.asarray(x), log2_target))


def test_negacyclic_monomial_rotate():
    n = 64
    x = _rand_u64(4, (5, 2, n))
    r = np.random.default_rng(5).integers(0, 4 * n, size=(5, 1))
    r[0, 0], r[1, 0] = 0, n
    got = tt.negacyclic_monomial_rotate(u64_tensor(x), torch.from_numpy(r))
    want = jt.negacyclic_monomial_rotate(jnp.asarray(x), jnp.asarray(r, dtype=jnp.uint64))
    _same(got, want)


@pytest.mark.parametrize("d", [3, 16, 1000003, 2**31 - 1, 2**40])
def test_unsigned_div_mod(d):
    x = _rand_u64(6, (1000,))
    t = u64_tensor(x)
    np.testing.assert_array_equal(_u64.u64_to_numpy(_u64.udiv(t, d)), x // np.uint64(d))
    np.testing.assert_array_equal(_u64.u64_to_numpy(_u64.umod(t, d)), x % np.uint64(d))


def test_unsigned_compare_and_shift():
    a, b = _rand_u64(7, (1000,)), _rand_u64(8, (1000,))
    np.testing.assert_array_equal(_u64.ult(u64_tensor(a), u64_tensor(b)).numpy(), a < b)
    for k in (1, 4, 32, 63):
        np.testing.assert_array_equal(_u64.u64_to_numpy(_u64.srl(u64_tensor(a), k)), a >> np.uint64(k))
    lo = (a & np.uint64(0xFFFFFFFF)).astype(np.int64)
    hi = (b & np.uint64(0xFFFFFFFF)).astype(np.int64)
    want = ((lo.astype(object) * hi.astype(object)) >> 32).astype(np.int64)
    np.testing.assert_array_equal(_u64.mulhi_u32(torch.from_numpy(lo), torch.from_numpy(hi)).numpy(), want)


# Reference sets whose modules are not ported yet: none since the boolean
# and GLWE matmul sets joined the port.
PENDING_PARAMS = set()


def test_params_missing_are_exactly_the_pending_sets():
    assert set(jp.registry()) - set(tp.registry()) == PENDING_PARAMS
    assert set(tp.registry()) <= set(jp.registry())


@pytest.mark.parametrize("name", sorted(jp.registry()))
def test_params_match_reference(name):
    if name in PENDING_PARAMS:
        with pytest.raises(KeyError):
            tp.by_name(name)
        return
    ours = tp.by_name(name)
    ref = jp.by_name(name)
    assert ours == params_from_reference(ref)
    assert ours.to_json() == ref.to_json()
    assert ours.hash == ref.hash
    if hasattr(ref, "delta"):
        assert ours.delta == ref.delta
    if hasattr(ref, "big_lwe_dimension"):
        assert ours.big_lwe_dimension == ref.big_lwe_dimension
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def test_trees_matmul_matches_reference():
    """TREES_MATMUL stays outside both registries."""
    assert tp.TREES_MATMUL == params_from_reference(jp.TREES_MATMUL)
    assert tp.TREES_MATMUL.hash == jp.TREES_MATMUL.hash
    assert "TREES_MATMUL" not in tp.registry()


def test_lwe_helpers_match_reference():
    a, b = _rand_u64(9, (3, 17)), _rand_u64(10, (3, 17))
    ta, tb_ = u64_tensor(a), u64_tensor(b)
    ja, jb_ = jnp.asarray(a), jnp.asarray(b)
    _same(tl.lwe_add(ta, tb_), jl.lwe_add(ja, jb_))
    _same(tl.lwe_sub(ta, tb_), jl.lwe_sub(ja, jb_))
    for c in (3, 2**63 + 5, 2**64 - 1):
        _same(tl.lwe_scalar_mul(ta, c), jl.lwe_scalar_mul(ja, c))
    pt = _rand_u64(11, (3,))
    _same(tl.lwe_add_plain(ta, u64_tensor(pt)), jl.lwe_add_plain(ja, jnp.asarray(pt)))
    _same(ta, a)  # lwe_add_plain returns a new tensor


@pytest.mark.parametrize("k", [1, 2])
def test_sample_extract_all_matches_reference(k):
    g = _rand_u64(12 + k, (2, k + 1, 32))
    got = tl.sample_extract_all(u64_tensor(g))
    _same(got, jl.sample_extract_all(jnp.asarray(g)))
    for t in (0, 5, 31):
        _same(got[..., t, :], jl.sample_extract(jnp.asarray(g), t))


def test_rng_split_and_fork_are_deterministic():
    a, b = FheRng(9, "cpu"), FheRng(9, "cpu")
    ca, cb = a.split(3), b.split(3)
    draws = [c.uniform_torus((5,)) for c in ca]
    assert all(torch.equal(x, c.uniform_torus((5,))) for x, c in zip(draws, cb))
    assert not torch.equal(draws[0], draws[1])
    fa, fb = a.fork(), b.fork()  # the parents advanced past the split's seeds
    fork_draw = fa.uniform_torus((5,))
    assert torch.equal(fork_draw, fb.uniform_torus((5,)))
    assert not any(torch.equal(fork_draw, d) for d in draws)
    assert torch.equal(a.uniform_torus((4,)), b.uniform_torus((4,)))
