"""tfhe_tpu_torch folded CRT-NTT engine vs the JAX engine and its Pallas
kernels (interpret mode on the CPU).

The plain engine mirrors the JAX math step by step, so its lazy residues
equal the JAX engine's bit for bit; the Pallas kernels agree mod p. The
CUDA kernels K1/K2 (csrc/ntt.cu) cannot run here, so their own order is
replayed in numpy from the tables they are given: the %-free reductions
of int32, u64 and lazy u32 inputs (against Python's x mod p at the
extremes), the folded-slot map their quads read and write (inverting the
layout's, one bank per lane), the lazy Harvey rounds on padded rows with
their constant padded offsets, and ragged row pairs, all held against the
plain forward mod p and the plain inverse exactly at N = 256, 1024 and
2048. The wrappers are checked to refuse CPU tensors and sizes the
kernels are not built for.
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
from test_torch_port_multibit import _mul_shoup


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
    return n, je, get_folded_engine(n, device="cpu"), make_pallas_ntt(je, tm=8, nb=3), make_pallas_ntt(je, tm=8, nb=4)


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
    got = _u32(get_folded_engine(n, device="cpu").forward_small(torch.from_numpy(x)))
    np.testing.assert_array_equal(got, np.asarray(jax_engine(n).forward_small(jnp.asarray(x))))


# -- the CUDA kernels' algorithm, replayed in numpy --------------------------

M32 = np.uint64(0xFFFFFFFF)


def _tables(te):
    tw, pp = (t.numpy().view(np.uint32).astype(np.uint64) for t in ntt_cuda.kernel_tables(te))
    return tw, pp, ntt_cuda.garner_consts_shoup(te).numpy().view(np.uint32).astype(np.uint64)


def _i32_residue(x, p, ws1):
    """i32_residue (csrc/ntt.cu): |x| by one Shoup quotient against w = 1,
    negated for x < 0."""
    x = np.asarray(x, dtype=np.int64)
    r = _mul_shoup(np.abs(x).astype(np.uint64), 1, ws1, p)
    return np.where((x < 0) & (r != 0), np.uint64(p) - r, r)


def _u64_residue(x, p, ws1, c32s):
    """u64_residue (csrc/ntt.cu): lo + (2^32 mod p) hi, two Shoup multiplies."""
    x = np.asarray(x, dtype=np.uint64)
    c32 = np.uint64((-int(p) * int(ws1)) % 2**32)  # the kernel's 0u - p * ws1
    r = _mul_shoup(x & M32, 1, ws1, p) + _mul_shoup(x >> np.uint64(32), c32, c32s, p)
    return np.where(r >= p, r - np.uint64(p), r)


def _folded_slots(n, c_dim):
    """The engine's folded layout: NTT slot k (evaluation j = bitrev(k)) ->
    folded slot h = (j mod C) R + j / C."""
    logc = c_dim.bit_length() - 1
    j = ntt_cuda._bitrev(n)
    return (j & (c_dim - 1)) * (n // c_dim) + (j >> logc)


def _slot_of_folded(h, logn, logc):
    """slot_of_folded (csrc/ntt.cu): folded slot h = t R + s -> NTT slot
    bitrev(s C + t)."""
    logr = logn - logc
    rev = ntt_cuda._bitrev(1 << logn)
    return rev[((h & ((1 << logr) - 1)) << logc) + (h >> logr)]


def _pad(i):
    return i + (i >> 5)


def _mul_shoup_lazy(a, w, ws, p):
    """mul_shoup_lazy (csrc/ntt.cu): a w - floor(a ws / 2^32) p in u32, in [0, 2p)."""
    a, w, ws, p = (np.asarray(x, dtype=np.uint64) for x in (a, w, ws, p))
    return (a * w - ((a * ws) >> np.uint64(32)) * p) & M32


def _rounds(logn):
    """(first stage, stage count) of each round: threes, then what is left."""
    out, s0 = [], 0
    while s0 < logn:
        k = min(3, logn - s0)
        out.append((s0, k))
        s0 += k
    return out


def _units(logn, k, logs):
    """unit_coords (rotate_device.cuh) for every unit of one row: (b, o)."""
    uu = np.arange(1 << (logn - k))
    if logs >= 5:
        return uu >> logs, uu & ((1 << logs) - 1)
    lognb = logn - k - logs
    return uu & ((1 << lognb) - 1), uu >> lognb


def _unit_index(j0, step, e, n):
    """The unit's element indices j0 + q step in a row pair (both rows), and
    the kernel's padded addresses pad(j0) + q step + (q step) / 32 checked
    against pad(j0 + q step)."""
    q = np.arange(e) * step
    idx = np.concatenate([j0, j0 + n])[:, None] + q
    assert (_pad(idx) == _pad(idx[:, :1]) + q + (q >> 5)).all()
    return idx


def _fwd_lazy(a, psi, psi_s, p, logn):
    """fwd_rounds (csrc/ntt.cu) on a (2N, cols) row pair: Harvey butterflies,
    values in [0, 4p) in and out."""
    n, p2 = 1 << logn, np.uint64(2 * p)
    for s0, k in _rounds(logn):
        logt = logn - 1 - s0
        logd = logt - (k - 1)
        b, o = _units(logn, k, logd)
        idx = _unit_index((b << (logt + 1)) + o, 1 << logd, 1 << k, n)
        bb = np.concatenate([b, b])
        x = a[idx]  # (units, E, cols)
        for l in range(k):
            half = (1 << k) >> (l + 1)
            for sg in range(1 << l):
                w = (((1 << s0) + bb) << l) + sg
                for q in range(2 * sg * half, 2 * sg * half + half):
                    y = np.where(x[:, q] >= p2, x[:, q] - p2, x[:, q])
                    t = _mul_shoup_lazy(x[:, q + half], psi[w][:, None], psi_s[w][:, None], p)
                    x[:, q], x[:, q + half] = y + t, y - t + p2
        assert (x < 2 * p2).all()
        a[idx] = x
    return a


def _inv_lazy(a, ipsi, ipsi_s, p, ninv, ninv_s, logn):
    """inv_rounds (csrc/ntt.cu) on a (2N, cols) row pair: values in [0, 2p),
    the last round scaled by N^-1 to canonical."""
    n, p2 = 1 << logn, np.uint64(2 * p)
    for s0, k in _rounds(logn):
        b, o = _units(logn, k, s0)
        idx = _unit_index((b << (s0 + k)) + o, 1 << s0, 1 << k, n)
        bb = np.concatenate([b, b])
        h = 1 << (logn - 1 - s0)
        x = a[idx]
        for l in range(k):
            d = 1 << l
            for g in range((1 << k) >> (l + 1)):
                w = (h >> l) + (bb << (k - l - 1)) + g
                for qq in range(d):
                    q = g * 2 * d + qq
                    y, v = x[:, q].copy(), x[:, q + d].copy()
                    sm = y + v
                    x[:, q] = np.where(sm >= p2, sm - p2, sm)
                    x[:, q + d] = _mul_shoup_lazy(y - v + p2, ipsi[w][:, None], ipsi_s[w][:, None], p)
        if s0 + k == logn:
            x = _mul_shoup(x, ninv, ninv_s, p)
        assert (x < p2).all()
        a[idx] = x
    return a


def _quad_offsets(logn, logc):
    """quad_offsets (csrc/ntt.cu): padded offsets of folded slots h + e from h."""
    k = _slot_of_folded(np.arange(4), logn, logc)
    return k + (k >> 5)


def _check_quads(rows2, logn, logc):
    """slot_of_folded(h + e) = slot_of_folded(h) + slot_of_folded(e) for h a
    multiple of 4, and the padded offsets add, in both rows of a pair."""
    n = 1 << logn
    h = np.arange(0, n, 4)
    k0 = _slot_of_folded(h, logn, logc)
    off = _quad_offsets(logn, logc)
    for e in range(4):
        assert (_slot_of_folded(h + e, logn, logc) == k0 + _slot_of_folded(np.array([e]), logn, logc)).all()
        for row in range(rows2):
            assert (_pad(row * n + k0 + _slot_of_folded(np.array([e]), logn, logc)) == _pad(row * n + k0) + off[e]).all()


def _k1_replay(te, x, u64):
    """K1 in the kernel's order: per (row pair, prime) block, the pair's 2N
    values (zeros past a ragged tail) reduced mod the block's prime, the lazy
    round NTT, then quads of consecutive folded slots made canonical.
    x (rows, N) -> (rows, P, N)."""
    tw, _, gs = _tables(te)
    logn, logc = ntt_cuda._dims(te)
    n = te.n
    rows = x.shape[0]
    pairs = (rows + 1) // 2
    _check_quads(2, logn, logc)
    flat = np.zeros((pairs * 2 * n,), dtype=x.dtype)
    flat[: rows * n] = x.reshape(-1)
    cols = flat.reshape(pairs, 2 * n).T  # (2N, pairs): every block's row pair
    slots = _slot_of_folded(np.arange(n), logn, logc)
    out = np.zeros((pairs * 2, te.n_primes, n), dtype=np.uint64)
    for r, p in enumerate(te.primes):
        res = _u64_residue(cols, p, gs[52 + r], gs[56 + r]) if u64 else _i32_residue(cols, p, gs[52 + r])
        f = _fwd_lazy(res, tw[r, 0], tw[r, 1], p, logn)
        f = np.where(f >= 2 * p, f - 2 * p, f)
        f = np.where(f >= p, f - p, f)
        out[:, r] = f.T.reshape(pairs * 2, n)[:, slots]
    return out[:rows]


def _k2_replay(te, f):
    """K2 in the kernel's order: quads of consecutive folded slots, each value
    reduced by one Shoup quotient against w = 1 into its NTT slot, the lazy
    round inverse NTT, natural-order stores. f (rows, P, N) any u32 ->
    canonical."""
    tw, pp, gs = _tables(te)
    logn, logc = ntt_cuda._dims(te)
    n = te.n
    rows = f.shape[0]
    pairs = (rows + 1) // 2
    _check_quads(2, logn, logc)
    slots = _slot_of_folded(np.arange(n), logn, logc)
    out = np.empty(f.shape, dtype=np.uint64)
    for r, p in enumerate(te.primes):
        res = np.zeros((pairs * 2, n), dtype=np.uint64)
        res[:rows, slots] = _mul_shoup(f[:, r].astype(np.uint64), 1, gs[52 + r], p)
        cols = res.reshape(pairs, 2 * n).T
        inv = _inv_lazy(cols, tw[r, 2], tw[r, 3], p, pp[r, 1], pp[r, 2], logn)
        out[:, r] = inv.T.reshape(pairs * 2, n)[:rows]
    return out


I32_EXTREMES = [-(2**31), -(2**31) + 1, -1, 0, 1, 2**31 - 1]
U64_EXTREMES = [0, 1, 2**32 - 1, 2**32, 2**63, 2**64 - 1]


@pytest.mark.parametrize("q", range(3))
def test_kernel_reductions_at_extremes(q):
    """The %-free int32 and u64 reductions of K1 and the u32 one of K2
    equal Python's x mod p at the extremes, at multiples of p and at
    random values, for each prime."""
    te = get_folded_engine(256, device="cpu")
    _, _, gs = _tables(te)
    p, ws1, c32s = te.primes[q], gs[52 + q], gs[56 + q]
    rng = np.random.default_rng(q)
    xi = I32_EXTREMES + [s * k * p + o for s in (-1, 1) for k in (1, 2, 3, 4) for o in (-1, 0, 1)]
    xi += rng.integers(-(2**31), 2**31, 64).tolist()
    np.testing.assert_array_equal(_i32_residue(xi, p, ws1), [x % p for x in xi])
    xu = U64_EXTREMES + [k * p + o for k in (1, 2**32, 2**33 + 5) for o in (-1, 0, 1)]
    xu += [int(v) for v in rng.integers(0, 2**64, 64, dtype=np.uint64)]
    np.testing.assert_array_equal(_u64_residue(np.array(xu, dtype=np.uint64), p, ws1, c32s), [x % p for x in xu])
    xl = [0, 1, p - 1, p, 2 * p - 1, 2**31, 2**32 - 1] + rng.integers(0, 2**32, 64).tolist()
    np.testing.assert_array_equal(_mul_shoup(np.array(xl, dtype=np.uint64), 1, ws1, p), [x % p for x in xl])


@pytest.mark.parametrize("n", (256, 1024, 2048))
def test_slot_of_folded_inverts_folded_slot(n):
    """K1's store and K2's load map h -> k inverts the folded layout's
    k -> h, and the four accesses of a warp (32 lanes, one quad each) fall
    in 32 distinct banks of the padded rows."""
    te = get_folded_engine(n, device="cpu")
    logn, logc = ntt_cuda._dims(te)
    k = np.arange(n)
    h = _folded_slots(n, te.ntts[0].c_dim)
    np.testing.assert_array_equal(_slot_of_folded(h, logn, logc), k)
    pad = lambda i: i + (i >> 5)
    for w0 in range(0, n // 4, 32):
        for e in range(4):
            banks = pad(_slot_of_folded(4 * (w0 + np.arange(32)) + e, logn, logc)) % 32
            assert len(set(banks.tolist())) == 32


def _kernel_check(te, rows, seed):
    """K1 (int32 and u64 input) and K2 replayed on `rows` rows with the
    extreme inputs in the first row, against the plain versions."""
    n = te.n
    rng = np.random.default_rng(seed)
    x = rng.integers(-(2**31), 2**31, size=(rows, n))
    x[0, :6] = I32_EXTREMES
    got = _k1_replay(te, x, u64=False)
    want = _u32(te.forward_i32_plain(torch.from_numpy(x))).astype(np.uint64)
    primes = np.array(te.primes, dtype=np.uint64)[:, None]
    np.testing.assert_array_equal(got, want % primes)
    xu = rng.integers(0, 2**64, size=(rows, n), dtype=np.uint64)
    xu[0, :6] = U64_EXTREMES
    got_u = _k1_replay(te, xu, u64=True)
    want_u = _u32(te.forward_u64_plain(u64_tensor(xu))).astype(np.uint64)
    np.testing.assert_array_equal(got_u, want_u % primes)
    # K2 on the plain forward's lazy residues: exactly the plain inverse
    np.testing.assert_array_equal(_k2_replay(te, want), _u32(te.inverse_plain(u32_tensor(want.astype(np.uint32)))))
    np.testing.assert_array_equal(_k2_replay(te, want), x[:, None] % np.array(te.primes)[:, None])


def test_kernel_algorithm_matches_plain(engines):
    """K1 and K2 in the kernel's order at N = 256, three rows (a ragged
    row pair)."""
    _kernel_check(engines[2], 3, 7)


@pytest.mark.parametrize("n", (1024, 2048))
def test_kernel_algorithm_matches_plain_at(n):
    """The same at the loop path's N = 1024 and the keygen N = 2048."""
    _kernel_check(get_folded_engine(n, device="cpu"), 3, n)


def test_aligned_copies_only_misaligned_tensors():
    x = torch.zeros(4 * 256 + 1, dtype=torch.int32)
    whole = x[:1024].view(4, 256)
    assert ntt_cuda._aligned(whole).data_ptr() == whole.data_ptr()
    odd = x[1:].view(4, 256)
    fixed = ntt_cuda._aligned(odd)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, odd)


def test_wrappers_refuse_cpu_tensors(engines):
    n, _, te, _, _ = engines
    with pytest.raises(ValueError, match="CUDA"):
        ntt_cuda.forward(te, torch.zeros(1, n, dtype=torch.int64), small=True)
    with pytest.raises(ValueError, match="CUDA"):
        ntt_cuda.inverse(te, torch.zeros(1, 3, n, dtype=torch.int32))


def test_wrappers_refuse_unsupported_n():
    te = get_folded_engine(128, device="cpu")
    with pytest.raises(ValueError, match="256, 4096"):
        ntt_cuda.forward(te, torch.zeros(1, 128, dtype=torch.int64), small=True)
    with pytest.raises(ValueError, match="256, 4096"):
        ntt_cuda.inverse(te, torch.zeros(1, 3, 128, dtype=torch.int32))
