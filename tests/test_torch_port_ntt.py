"""tfhe_tpu_torch folded CRT-NTT engine vs the JAX engine and its Pallas
kernels (interpret mode on the CPU).

The plain engine mirrors the JAX math step by step, so its lazy residues
equal the JAX engine's bit for bit; the Pallas kernels agree mod p. The
CUDA kernels K1/K2 cannot run here: their algorithm (radix-2 butterflies
over the twiddle tables they are given, read and written in the folded
layout) is replayed in numpy from the same tables and held against the
plain engine, and the wrappers are checked to refuse CPU tensors.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu.ops.folded_ntt import get_folded_engine as jax_engine
from tfhe_tpu.ops.pallas_ntt import make_pallas_ntt
from tfhe_tpu_torch import _u64
from tfhe_tpu_torch.convert import u32_tensor, u64_tensor
from tfhe_tpu_torch.ops import ntt_cuda
from tfhe_tpu_torch.ops.folded_ntt import get_folded_engine


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several test processes side by side; the port's many
    small tensor ops run fastest, and slow the other processes least, on
    one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    n = 256
    je = jax_engine(n)
    return n, je, get_folded_engine(n, "cpu"), make_pallas_ntt(je, tm=8, nb=3), make_pallas_ntt(je, tm=8, nb=4)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _eq_mod_p(a, b, primes):
    a, b = np.asarray(a).astype(np.int64), np.asarray(b).astype(np.int64)
    for i, p in enumerate(primes):
        np.testing.assert_array_equal(a[..., i, :] % p, b[..., i, :] % p)


def test_forward_small_nb3(engines):
    n, je, te, (fwd3, _), _ = engines
    x = np.random.default_rng(0).integers(-(2**23), 2**23 + 1, size=(5, n))
    got = _u32(te.forward_small(torch.from_numpy(x)))
    np.testing.assert_array_equal(got, np.asarray(je.forward_small(jnp.asarray(x))))
    _eq_mod_p(got, fwd3(jnp.asarray(x, dtype=jnp.int32)), te.primes)


def test_forward_i32_nb4(engines):
    n, je, te, _, (fwd4, _) = engines
    x = np.random.default_rng(1).integers(-(2**31) + 1, 2**31, size=(3, n))
    got = _u32(te.forward_i32_plain(torch.from_numpy(x)))
    _eq_mod_p(got, fwd4(jnp.asarray(x, dtype=jnp.int32)), te.primes)


def test_forward_u64(engines):
    n, je, te, _, _ = engines
    b = np.random.default_rng(2).integers(0, 2**64, size=(2, 3, n), dtype=np.uint64)
    got = _u32(te.forward_u64(u64_tensor(b)))
    np.testing.assert_array_equal(got, np.asarray(je.forward_u64(jnp.asarray(b))))


def test_inverse_and_backward(engines):
    n, je, te, _, (_, inv) = engines
    x = np.random.default_rng(3).integers(-(2**20), 2**20, size=(3, n))
    f = np.asarray(je.forward_small(jnp.asarray(x)))
    got = _u32(te.inverse_plain(u32_tensor(f)))
    np.testing.assert_array_equal(got, np.asarray(inv(jnp.asarray(f))))
    for i, p in enumerate(te.primes):
        np.testing.assert_array_equal(got[:, i], x % p)
    back = te.backward(u32_tensor(f), shift=11)
    np.testing.assert_array_equal(_u64.u64_to_numpy(back), np.asarray(je.backward(jnp.asarray(f), shift=11)))


def test_crt_reconstruct(engines):
    n, je, te, _, _ = engines
    rng = np.random.default_rng(4)
    res = [rng.integers(0, p, size=(4, n)).astype(np.uint32) for p in te.primes]
    got = te.crt_reconstruct([u32_tensor(r) for r in res])
    want = je.crt_reconstruct([jnp.asarray(r) for r in res])
    np.testing.assert_array_equal(_u64.u64_to_numpy(got), np.asarray(want))


def test_shoup_pointwise_and_polymul(engines):
    n, je, te, _, _ = engines
    rng = np.random.default_rng(5)
    a = rng.integers(-(2**9), 2**9, size=(2, n))
    b = rng.integers(0, 2**64, size=(2, n), dtype=np.uint64)
    fb_j = je.forward_u64(jnp.asarray(b))
    fb_t = te.forward_u64(u64_tensor(b))
    key_t = te.make_shoup(fb_t)
    np.testing.assert_array_equal(_u32(key_t), np.asarray(je.make_shoup(fb_j)))
    fa_t = te.forward_small(torch.from_numpy(a))
    fa_j = je.forward_small(jnp.asarray(a))
    np.testing.assert_array_equal(_u32(te.pointwise_shoup(fa_t, key_t)), np.asarray(je.pointwise_shoup(fa_j, je.make_shoup(fb_j))))
    np.testing.assert_array_equal(_u32(te.pointwise_mul(fa_t, fb_t)), np.asarray(je.pointwise_mul(fa_j, fb_j)))
    np.testing.assert_array_equal(_u32(te.add_domain(fa_t, fb_t)), np.asarray(je.add_domain(fa_j, fb_j)))
    s = rng.integers(0, 2**40, size=(2, 3, n), dtype=np.uint64)
    np.testing.assert_array_equal(
        _u32(te.reduce_u64_domain(u64_tensor(s), canonical=True)),
        np.asarray(je.reduce_u64_domain(jnp.asarray(s), canonical=True)),
    )
    got = te.polymul(torch.from_numpy(a), u64_tensor(b))
    np.testing.assert_array_equal(_u64.u64_to_numpy(got), np.asarray(je.polymul(jnp.asarray(a), jnp.asarray(b))))


def test_forward_n2048():
    """One full-size forward (nb=3) against the JAX engine."""
    n = 2048
    x = np.random.default_rng(6).integers(-(2**23), 2**23 + 1, size=(2, n))
    got = _u32(get_folded_engine(n, "cpu").forward_small(torch.from_numpy(x)))
    np.testing.assert_array_equal(got, np.asarray(jax_engine(n).forward_small(jnp.asarray(x))))


# -- the CUDA kernels' algorithm, replayed in numpy --------------------------


def _folded_slots(n, c_dim):
    logn, logc = n.bit_length() - 1, c_dim.bit_length() - 1
    k = np.arange(n)
    j = np.zeros(n, dtype=np.int64)
    for bit in range(logn):
        j |= ((k >> bit) & 1) << (logn - 1 - bit)
    return (j & (c_dim - 1)) * (n // c_dim) + (j >> logc)


def _mul_shoup(a, w, ws, p):
    q = (a * ws) >> 32
    r = a * w - q * p
    return np.where(r >= p, r - p, r)


def _butterflies(n):
    """(m, i, j, t) of each butterfly stage, the kernel's thread mapping."""
    logn = n.bit_length() - 1
    b = np.arange(n // 2)
    for logt in range(logn - 1, -1, -1):
        t = 1 << logt
        i = b >> logt
        yield n // (2 * t), i, (i << (logt + 1)) + (b & (t - 1)), t


def _kernel_forward(x, tw, p, slots):
    a = x % p
    for m, i, j, t in _butterflies(a.shape[-1]):
        u = a[:, j]
        v = _mul_shoup(a[:, j + t], tw[0][m + i], tw[1][m + i], p)
        a[:, j], a[:, j + t] = (u + v) % p, (u - v) % p
    out = np.empty_like(a)
    out[:, slots] = a
    return out


def _kernel_inverse(f, tw, pp, slots):
    p, ninv, ninv_s = pp[:3]
    a = f[:, slots] % p
    for m, i, j, t in reversed(list(_butterflies(a.shape[-1]))):
        h = m  # GS stage with h = (current m) / 2 groups: index h + i
        u, v = a[:, j].copy(), a[:, j + t].copy()
        a[:, j] = (u + v) % p
        a[:, j + t] = _mul_shoup((u - v) % p, tw[2][h + i], tw[3][h + i], p)
    return _mul_shoup(a, ninv, ninv_s, p)


def test_kernel_algorithm_matches_plain(engines):
    n, _, te, _, _ = engines
    tw, pp = ntt_cuda.kernel_tables(te)
    tw = tw.numpy().view(np.uint32).astype(np.int64)
    pp = pp.numpy().view(np.uint32).astype(np.int64)
    slots = _folded_slots(n, te.ntts[0].c_dim)
    x = np.random.default_rng(7).integers(-(2**31) + 1, 2**31, size=(3, n))
    want = _u32(te.forward_i32_plain(torch.from_numpy(x))).astype(np.int64)
    for i, p in enumerate(te.primes):
        got = _kernel_forward(x.copy(), tw[i], p, slots)
        np.testing.assert_array_equal(got, want[:, i] % p)
        np.testing.assert_array_equal(_kernel_inverse(got, tw[i], pp[i], slots), x % p)


def test_wrappers_refuse_cpu_tensors(engines):
    n, _, te, _, _ = engines
    with pytest.raises(ValueError, match="CUDA"):
        ntt_cuda.forward(te, torch.zeros(1, n, dtype=torch.int64), small=True)
    with pytest.raises(ValueError, match="CUDA"):
        ntt_cuda.inverse(te, torch.zeros(1, 3, n, dtype=torch.int32))
