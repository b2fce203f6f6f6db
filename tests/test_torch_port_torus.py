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
from tfhe_tpu_torch import _u64
from tfhe_tpu_torch import params as tp
from tfhe_tpu_torch import torus as tt
from tfhe_tpu_torch.convert import params_from_reference, u64_tensor


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


@pytest.mark.parametrize("name", sorted(tp.registry()))
def test_params_match_reference(name):
    ours = tp.by_name(name)
    ref = jp.by_name(name)
    assert ours == params_from_reference(ref)
    assert ours.to_json() == ref.to_json()
    assert ours.hash == ref.hash
    assert ours.delta == ref.delta
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
