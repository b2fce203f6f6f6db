"""tfhe_tpu_torch multi-bit blind rotation vs the JAX package, bit for bit.

* group_exponents and the BSK step layout equal JAX's.
* With JAX multi-bit keys carried across (convert.py; N = 256, n = 12,
  level 1 / base_log 23), the port's multibit_blind_rotate (plain K4 on the
  CPU) equals JAX's multibit_blind_rotate (its lax.scan path on the CPU)
  for g = 2, 3, 4, and once the Pallas kernel multibit_rotate_fused in
  interpret mode for g = 2.
* The kernel's Horner order (csrc/multibit.cu, replayed in numpy) equals
  the plain `_horner` mod p.
* The kernel's own arithmetic, replayed in numpy: the monomial rows it
  reads as powers of psi equal `monomial_x_table`; `garner_u32` on the
  `garner_consts_shoup` constants equals `crt_reconstruct`; the %-free
  digit reduction equals d mod p; bitrev(unfold(h))
  inverts the folded layout; the Garner shares of a cluster cover every
  coefficient once.
* From the fixture's key the port's FheRng draws the fixture's secret
  keys, multi-bit BSKs and ciphertexts bit for bit, with no `convert`.
* Keys from the port's own keygen decrypt right, with the shift and msb of
  JAX's; the level-2 loop form decrypts right; keygen reads g from the
  parameter-set name.
"""

import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu import params as jp
from tfhe_tpu.core import multibit as jmb
from tfhe_tpu.core.keys import gen_glwe_secret_key, gen_lwe_secret_key
from tfhe_tpu.core.lwe import encrypt_lwe
from tfhe_tpu.models import shortint as jsi
from tfhe_tpu.ops.pallas_multibit import multibit_bsk_to_step_layout as jax_step_layout
from tfhe_tpu.ops.pallas_multibit import multibit_rotate_fused
from tfhe_tpu.rng import FheRng as JaxRng
from tfhe_tpu.torus import encode, mod_switch, negacyclic_monomial_rotate
from tfhe_tpu_torch import _u64, convert
from tfhe_tpu_torch import params as tp
from tfhe_tpu_torch import torus as ttorus
from tfhe_tpu_torch.core import keys as tkeys
from tfhe_tpu_torch.core import lwe as tlwe
from tfhe_tpu_torch.core import multibit as tmb
from tfhe_tpu_torch.models import shortint as tsi
from tfhe_tpu_torch.ops import multibit_cuda as mbc
from tfhe_tpu_torch.ops import ntt_cuda
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


N = 256
N_LWE = 12
GROUPS = (2, 3, 4)
LUT_TABLE = np.asarray([(3 * v + 1) % 4 for v in range(16)], dtype=np.uint64)


def _jax_params():
    return dataclasses.replace(
        jp.TOY_SHORTINT, name="MB_TEST", lwe_dimension=N_LWE, polynomial_size=N,
        pbs=jp.GadgetParams(base_log=23, level=1),
    )


@pytest.fixture(scope="module")
def carried():
    """One secret key pair, a multi-bit BSK per g (carried across), and 6
    small-key ciphertexts of 0..5."""
    params = _jax_params()
    engine = jsi.engine_for(params)
    rng = JaxRng(jax.random.key(3))
    glwe_sk = gen_glwe_secret_key(rng, 1, N)
    lwe_sk = gen_lwe_secret_key(rng, N_LWE)
    keys = {}
    for g in GROUPS:
        bsk = jmb.gen_multibit_bootstrap_key(lwe_sk, glwe_sk, params.pbs, g, rng, params.glwe_noise, engine)
        keys[g] = (bsk, convert.multibit_bootstrap_key_from_reference(bsk, device="cpu"))
    msgs = jnp.arange(6, dtype=jnp.uint64)
    ct = encrypt_lwe(lwe_sk, encode(msgs, params.delta), rng, params.lwe_noise)
    lut = jsi.generate_lut(params, LUT_TABLE)
    return params, engine, keys, ct, lut


def test_port_draws_the_carried_keys(carried):
    """The port's FheRng is the JAX package's threefry stream: from the
    same key it draws the fixture's secret keys, every multi-bit BSK and
    the ciphertexts, bit for bit, with no `convert`."""
    params, engine, keys, ct, lut = carried
    rng = FheRng(np.asarray(jax.random.key_data(jax.random.key(3))), "cpu")
    eng = get_folded_engine(N, device="cpu")
    glwe_sk = tkeys.gen_glwe_secret_key(rng, 1, N)
    lwe_sk = tkeys.gen_lwe_secret_key(rng, N_LWE)
    tparams = tp.TOY_SHORTINT
    for g in GROUPS:
        bsk = tmb.gen_multibit_bootstrap_key(
            lwe_sk, glwe_sk, tp.GadgetParams(base_log=23, level=1), g, rng, tparams.glwe_noise, eng
        )
        assert torch.equal(bsk.bsk_ntt, keys[g][1].bsk_ntt) and bsk.shift == keys[g][1].shift
    mine = tlwe.encrypt_lwe(lwe_sk, ttorus.encode(torch.arange(6), params.delta), rng, tparams.lwe_noise)
    np.testing.assert_array_equal(_u64.u64_to_numpy(mine), np.asarray(ct))


@pytest.mark.parametrize("g", GROUPS)
def test_group_exponents_match_reference(g):
    a = np.random.default_rng(g).integers(0, 2 * N, size=(5, N_LWE), dtype=np.uint64)
    want = np.asarray(jmb.group_exponents(jnp.asarray(a), g, 2 * N))
    got = tmb.group_exponents(torch.from_numpy(a.astype(np.int64)), g, 2 * N)
    np.testing.assert_array_equal(got.numpy(), want)


def test_step_layout_matches_reference():
    bsk = torch.from_numpy(np.random.default_rng(1).integers(0, 2**31, size=(2, 8, 2, 2, 3, 2, 16), dtype=np.int64))
    v, s = mbc.multibit_bsk_to_step_layout(bsk.to(torch.int32))
    jv, js = jax_step_layout(jnp.asarray(bsk.numpy().astype(np.uint32)))
    np.testing.assert_array_equal(v.numpy().view(np.uint32), np.asarray(jv))
    np.testing.assert_array_equal(s.numpy().view(np.uint32), np.asarray(js))


@pytest.mark.parametrize("g", GROUPS)
def test_blind_rotate_matches_reference(carried, g):
    params, engine, keys, ct, lut = carried
    jbsk, tbsk = keys[g]
    assert tmb.uses_fused_group_steps(tbsk, 2)
    want = jmb.multibit_blind_rotate(lut, ct, jbsk, engine)
    got = tmb.multibit_blind_rotate(
        convert.u64_tensor(lut), convert.u64_tensor(ct), tbsk, get_folded_engine(N, device="cpu")
    )
    np.testing.assert_array_equal(_u64.u64_to_numpy(got), np.asarray(want))


def test_blind_rotate_takes_a_table_by_position(carried):
    """`table`, the fifth parameter as in the JAX package, replaces
    bsk.rot_table: the key's own table and one built from the engine give
    the default call's accumulator, which test_blind_rotate_matches_reference
    holds against JAX's (whose default is the same bsk.rot_table)."""
    _, _, keys, ct, lut = carried
    tbsk = keys[2][1]
    eng = get_folded_engine(N, device="cpu")
    tlut, tct = convert.u64_tensor(lut), convert.u64_tensor(ct[:2])
    default = tmb.multibit_blind_rotate(tlut, tct, tbsk, eng)
    for table in (tbsk.rot_table, tmb.monomial_x_table(eng)):
        assert torch.equal(tmb.multibit_blind_rotate(tlut, tct, tbsk, eng, table), default)
    assert not torch.equal(tmb.multibit_blind_rotate(tlut, tct, tbsk, eng, tbsk.rot_table.roll(1, 0)), default)


def test_plain_steps_match_pallas_kernel(carried):
    """g = 2 against multibit_rotate_fused in interpret mode (the Pallas
    kernel K4 replaces), from the same accumulators and exponents."""
    params, engine, keys, ct, lut = carried
    jbsk, tbsk = keys[2]
    ms = mod_switch(ct, int(np.log2(2 * N)))
    acc = negacyclic_monomial_rotate(lut, (jnp.uint64(2 * N) - ms[..., -1])[..., None])
    acc = jnp.broadcast_to(acc, ms[..., -1].shape + (2, N))
    e_all = jmb.group_exponents(ms[..., :-1], 2, 2 * N)
    want = multibit_rotate_fused(acc, e_all, jbsk, engine, jbsk.rot_table)
    a = torch.from_numpy(np.asarray(ms[..., :-1]).astype(np.int64)).t()
    got = mbc.group_steps_plain(
        convert.u64_tensor(acc), a, tbsk.bsk_ntt, tbsk.rot_table, get_folded_engine(N, device="cpu"),
        23, tbsk.shift, 2,
    )
    np.testing.assert_array_equal(_u64.u64_to_numpy(got), np.asarray(want))


def test_monomial_x_table_matches_reference(carried):
    _, _, keys, _, _ = carried
    got = tmb.monomial_x_table(get_folded_engine(N, device="cpu"))
    assert torch.equal(got, keys[2][1].rot_table)


@pytest.mark.parametrize("g", GROUPS)
def test_kernel_horner_order_matches_plain(g):
    """csrc/multibit.cu folds x[v] += m_b * x[v + 2^b] bottom-up with
    canonical add_mod / mul_shoup; the plain `_horner` folds top-down on
    lazy residues. Both give the same value mod p."""
    te = get_folded_engine(N, device="cpu")
    p = te.primes[0]
    rng = np.random.default_rng(10 + g)
    inners = rng.integers(0, 2 * p, size=(1 << g, N))
    m = rng.integers(0, p, size=(g, N))
    ms = (m << 32) // p
    x = [v % p for v in inners]
    for b in range(g):
        for v in range(0, 1 << g, 2 << b):
            x[v] = (x[v] + x[v + (1 << b)] * m[b] % p) % p
    plain = mbc._horner(
        {v: torch.from_numpy(inners[v]) for v in range(1 << g)},
        [torch.from_numpy(r) for r in m], [torch.from_numpy(r) for r in ms], p, tuple(range(g)),
    )
    np.testing.assert_array_equal(plain.numpy() % p, x[0])


# -- csrc/multibit.cu and ntt_device.cuh arithmetic, replayed in numpy ---------

M32 = np.uint64(0xFFFFFFFF)


def _mul_shoup(a, w, ws, p):
    """mul_shoup on uint64 lanes holding u32 values (u32 wrapping)."""
    a, w, ws, p = (np.asarray(x, dtype=np.uint64) for x in (a, w, ws, p))
    q = (a * ws) >> np.uint64(32)
    r = (a * w - q * p) & M32
    return np.where(r >= p, r - p, r)


def _unfold(h, logn, logc):
    logr = logn - logc
    return ((h & ((1 << logr) - 1)) << logc) + (h >> logr)


def _bitrev(j, logn):
    return np.array([int(format(int(x), f"0{logn}b")[::-1], 2) for x in np.atleast_1d(j)])


def _folded_slot(k, logn, logc):
    j = _bitrev(k, logn)
    return ((j & ((1 << logc) - 1)) << (logn - logc)) + (j >> logc)


def _shoup_companion(w, p, ws1, c1s):
    """shoup_companion (csrc/multibit.cu) in numpy: floor(w 2^32 / p)."""
    w = np.asarray(w, dtype=np.uint64)
    c1 = np.uint64((-int(p) * int(ws1)) % 2**32)  # the kernel's 0u - p * ws1
    q = (w * np.uint64(c1s)) >> np.uint64(32)
    rem = (w * c1 - q * np.uint64(p)) & M32
    return (w * np.uint64(ws1) + q + (rem >= p)) & M32


def _monomial_rows(te, e, x):
    """K4's product x . NTT(X^e) at every folded slot h = tq R + s, (P, N):
    m = omega^(s e mod R) . psi^((2 tq + 1) e mod 2N), omega = psi^(2C),
    then one mul_shoup by m with its exact companion."""
    logn, logc = ntt_cuda._dims(te)
    logr = logn - logc
    psi = mbc.psi_powers(te).numpy().view(np.uint32)  # (P, 2, 2N)
    gs = mbc.garner_consts_shoup(te).numpy().view(np.uint32)
    h = np.arange(te.n)
    s, tq = h & ((1 << logr) - 1), h >> logr
    ta = ((2 * tq + 1) * e) % (2 * te.n)
    tb = ((s * e) % (1 << logr)) << (logc + 1)  # omega^u is psi^(2 C u)
    out = []
    for i, p in enumerate(te.primes):
        m = _mul_shoup(psi[i, 0, tb], psi[i, 0, ta], psi[i, 1, ta], p)
        out.append(_mul_shoup(x, m, _shoup_companion(m, p, gs[52 + i], gs[56 + i]), p))
    return np.stack(out)


def test_shoup_companion_is_exact():
    te = get_folded_engine(N, device="cpu")
    gs = mbc.garner_consts_shoup(te).numpy().view(np.uint32)
    rng = np.random.default_rng(8)
    for i, p in enumerate(te.primes):
        w = np.concatenate([[0, 1, 2, p // 2, p - 2, p - 1], rng.integers(0, p, 4096)]).astype(np.uint64)
        want = np.array([(int(v) << 32) // p for v in w], dtype=np.uint64)
        np.testing.assert_array_equal(_shoup_companion(w, p, gs[52 + i], gs[56 + i]), want)


def test_psi_powers_give_the_monomial_table():
    te = get_folded_engine(N, device="cpu")
    table = tmb.monomial_x_table(te).numpy().view(np.uint32)  # (2N, P, 2, N)
    x = np.random.default_rng(3).integers(0, 2**32, N, dtype=np.uint64)
    want_psi = mbc.psi_powers(te).numpy().view(np.uint32)
    for i, (ntt, p) in enumerate(zip(te.ntts, te.primes)):
        assert [int(v) for v in want_psi[i, 0, :4]] == [pow(ntt.psi, k, p) for k in range(4)]
    for e in range(2 * N):
        np.testing.assert_array_equal(_monomial_rows(te, e, np.ones(N, np.uint64)), table[e, :, 0], err_msg=f"e={e}")
        want = np.stack([(x % p) * table[e, i, 0].astype(np.uint64) % p for i, p in enumerate(te.primes)])
        np.testing.assert_array_equal(_monomial_rows(te, e, x), want, err_msg=f"e={e}")


def test_psi_powers_give_monomial_rows_at_2048():
    n = 2048
    te = get_folded_engine(n, device="cpu")
    es = [0, 1, n - 1, n, 2 * n - 1, *np.random.default_rng(4).integers(0, 2 * n, 5).tolist()]
    polys = np.zeros((len(es), n), dtype=np.int64)  # the rows monomial_x_table builds
    for r, e in enumerate(es):
        polys[r, e % n] = 1 if e < n else -1
    rows = te.make_shoup(te.forward_small(torch.from_numpy(polys))).numpy().view(np.uint32)
    x = np.random.default_rng(6).integers(0, 2**32, n, dtype=np.uint64)
    for r, e in enumerate(es):
        want = np.stack([(x % p) * rows[r, i, 0].astype(np.uint64) % p for i, p in enumerate(te.primes)])
        np.testing.assert_array_equal(_monomial_rows(te, e, x), want, err_msg=f"e={e}")


def _garner_u32(res, gs):
    """garner_u32 (csrc/ntt_device.cuh) in numpy; res: per prime, canonical."""
    gs = gs.astype(np.uint64)
    n_pr = len(res)
    v = [res[0].astype(np.uint64)]
    for q in range(1, n_pr):
        pq = gs[q]
        t = v[q - 1]
        for j in range(q - 2, -1, -1):
            t = _mul_shoup(t, gs[12 + 4 * q + j], gs[28 + 4 * q + j], pq) + v[j]
            t = np.where(t >= pq, t - pq, t)
        rq = res[q].astype(np.uint64)
        d = np.where(rq >= t, rq - t, rq + pq - t)
        v.append(_mul_shoup(d, gs[4 + q], gs[8 + q], pq))
    x = np.zeros_like(v[0])
    neg = np.zeros(v[0].shape, dtype=bool)
    eq = np.ones(v[0].shape, dtype=bool)
    for j in range(n_pr - 1, -1, -1):
        x = v[j] + gs[j] * x
        neg = neg | (eq & (v[j] > gs[44 + j]))
        eq = eq & (v[j] == gs[44 + j])
    return np.where(neg, x - ((gs[49] << np.uint64(32)) | gs[48]), x)


def test_garner_u32_matches_crt_reconstruct():
    te = get_folded_engine(N, device="cpu")
    prod = te.garner.prod
    # the extremes: prod/2 (the largest positive value) and one above it
    # (the most negative), 0, 1, -1, then random values
    vals = [prod // 2, prod // 2 + 1, 0, 1, prod - 1]
    vals += [int(x) * 2**60 + int(y) for x, y in np.random.default_rng(5).integers(0, 2**28, (59, 2))]
    res = [np.array([v % p for v in vals], dtype=np.uint32) for p in te.primes]
    want = _u64.u64_to_numpy(te.crt_reconstruct([convert.u32_tensor(r) for r in res]))
    signed = np.array([(v if v <= prod // 2 else v - prod) % 2**64 for v in vals], dtype=np.uint64)
    np.testing.assert_array_equal(want, signed)
    got = _garner_u32(res, mbc.garner_consts_shoup(te).numpy().view(np.uint32))
    np.testing.assert_array_equal(got, want)
    # the re-exported tables are ntt_cuda's, which K3 reads too
    assert mbc.garner_consts_shoup(te) is ntt_cuda.garner_consts_shoup(te)
    assert mbc.psi_powers(te) is ntt_cuda.psi_powers(te)


def test_garner_consts_shoup_need_ascending_primes():
    from tfhe_tpu_torch.ops.folded_ntt import GarnerConsts

    te = get_folded_engine(N, device="cpu")
    shuffled = types.SimpleNamespace(garner=GarnerConsts(tuple(reversed(te.primes))), device=te.device)
    with pytest.raises(ValueError, match="ascending"):
        mbc.garner_consts_shoup(shuffled)


def _digit_residue(x, base_log, p):
    """digit_residue (csrc/multibit.cu) in numpy."""
    b = np.uint64(base_log)
    state = (x + np.uint64(1 << (63 - base_log))) >> (np.uint64(64) - b)
    neg = state >= np.uint64(1 << (base_log - 1))
    mag = np.where(neg, np.uint64(1 << base_log) - state, state)
    r = _mul_shoup(mag, 1, 2**32 // p, p)  # the kernel's floor(2^32 / p)
    return np.where(neg & (r != 0), np.uint64(p) - r, r)


@pytest.mark.parametrize("base_log", (1, 23, 30, 31))
def test_digit_residue_is_d_mod_p(base_log):
    from tfhe_tpu.ops.folded_ntt import FOLDED_PRIMES_4

    half = 1 << (base_log - 1)
    rng = np.random.default_rng(base_log)
    for p in (*get_folded_engine(N, device="cpu").primes, *FOLDED_PRIMES_4):
        # the extreme digits, multiples of p near them, and random ones
        d = [-half, -half + 1, -1, 0, 1, half - 1]
        d += [s * k * p + o for s in (-1, 1) for k in range(1, 4) for o in (-1, 0, 1)]
        d += rng.integers(-half, half, 16).tolist()
        d = np.array([x for x in d if -half <= x < half], dtype=np.int64)
        # torus values whose level-1 digit is d, with low bits under the rounding half
        low = rng.integers(0, 1 << (63 - base_log), d.size).astype(np.uint64)
        x = ((d % (1 << base_log)).astype(np.uint64) << np.uint64(64 - base_log)) + low
        np.testing.assert_array_equal(_digit_residue(x, base_log, p), d % p, err_msg=f"p={p}")


def _rounds(logn):
    """The stage counts of K4's NTT rounds: threes, then what is left."""
    out = []
    while logn:
        out.append(min(3, logn))
        logn -= out[-1]
    return out


def _unit_coords(uu, logunits, logs):
    """unit_coords (csrc/multibit.cu): unit -> (block, offset)."""
    if logs >= 5:
        return uu >> logs, uu & ((1 << logs) - 1)
    lognb = logunits - logs
    return uu & ((1 << lognb) - 1), uu >> lognb


def _k4_ntt_forward(x, psi, psi_s, p, logn):
    """fwd_round (csrc/multibit.cu) over one row, in numpy: (N,) canonical
    -> NTT slot order."""
    a = x.copy()
    m, logt = 1, logn - 1
    for k in _rounds(logn):
        logd = logt - (k - 1)
        for uu in range(1 << (logn - k)):
            b, o = _unit_coords(uu, logn - k, logd)
            idx = (b << (logt + 1)) + o + (np.arange(1 << k) << logd)
            v = a[idx]
            for l in range(k):
                half = (1 << k) >> (l + 1)
                for sg in range(1 << l):
                    w = ((m + b) << l) + sg
                    q = np.arange(2 * sg * half, 2 * sg * half + half)
                    t = _mul_shoup(v[q + half], psi[w], psi_s[w], p)
                    y = v[q]
                    v[q], v[q + half] = (y + t) % p, (y + p - t) % p
            a[idx] = v
        m, logt = m << k, logt - k
    return a


def _k4_ntt_inverse(f, ipsi, ipsi_s, p, ninv, ninv_s, logn):
    """inv_round over one row, in numpy: NTT slot order -> (N,) canonical."""
    a = f.copy()
    h, logt = 1 << (logn - 1), 0
    rounds = _rounds(logn)
    for r, k in enumerate(rounds):
        for uu in range(1 << (logn - k)):
            b, o = _unit_coords(uu, logn - k, logt)
            idx = (b << (logt + k)) + o + (np.arange(1 << k) << logt)
            v = a[idx]
            for l in range(k):
                d = 1 << l
                for g in range((1 << k) >> (l + 1)):
                    w = (h >> l) + (b << (k - l - 1)) + g
                    q = g * 2 * d + np.arange(d)
                    y, z = v[q].copy(), v[q + d].copy()
                    v[q] = (y + z) % p
                    v[q + d] = _mul_shoup((y + p - z) % p, ipsi[w], ipsi_s[w], p)
            if r == len(rounds) - 1:
                v = _mul_shoup(v, ninv, ninv_s, p)
            a[idx] = v
        h, logt = h >> k, logt + k
    return a


@pytest.mark.parametrize("n", (256, 1024, 2048))
def test_k4_ntt_rounds_match_plain(n):
    """K4's NTT in rounds of three stages (all round sizes 1, 2, 3 occur)
    equals the plain forward transform at every folded slot, and its
    inverse gives the input back."""
    te = get_folded_engine(n, device="cpu")
    logn, logc = ntt_cuda._dims(te)
    tw, pp = (t.numpy().view(np.uint32).astype(np.uint64) for t in ntt_cuda.kernel_tables(te))
    x = np.random.default_rng(n).integers(-(2**22), 2**22, n)
    want = te.forward_small_plain(torch.from_numpy(x)).numpy().view(np.uint32)  # (P, N), [0, 2p)
    slots = _folded_slot(np.arange(n), logn, logc)
    for i, p in enumerate(te.primes):
        got = _k4_ntt_forward((x % p).astype(np.uint64), tw[i, 0], tw[i, 1], p, logn)
        np.testing.assert_array_equal(got, want[i, slots] % p)
        back = _k4_ntt_inverse(got, tw[i, 2], tw[i, 3], p, pp[i, 1], pp[i, 2], logn)
        np.testing.assert_array_equal(back, x % p)


def test_k4_padding_spreads_the_strided_accesses():
    """pad(i) = i + i / 32 and unit_coords put the 32 lanes of a warp on at
    least 16 banks (at most 2-way conflicts) for every access of the NTT
    rounds and of the pointwise step at N = 2048."""
    pad = lambda i: i + (i >> 5)
    logn, logc = 11, 4
    lanes = np.arange(32)

    def banks(idx):
        return len(set((pad(idx) % 32).tolist()))

    # pointwise: one tq, 32 consecutive s
    assert banks(_bitrev(_unfold(lanes, logn, logc), logn)) == 32
    m, logt = 1, logn - 1
    for k in _rounds(logn):  # forward rounds
        logd = logt - (k - 1)
        for w0 in range(0, 1 << (logn - k), 32):
            b, o = _unit_coords(w0 + lanes, logn - k, logd)
            for q in range(1 << k):
                assert banks((b << (logt + 1)) + o + (q << logd)) >= 16
        logt -= k
    logt = 0
    for k in _rounds(logn):  # inverse rounds
        for w0 in range(0, 1 << (logn - k), 32):
            b, o = _unit_coords(w0 + lanes, logn - k, logt)
            for q in range(1 << k):
                assert banks((b << (logt + k)) + o + (q << logt)) >= 16
        logt += k


@pytest.mark.parametrize("n", (256, 2048))
def test_bitrev_unfold_inverts_folded_slot(n):
    logn, logc = ntt_cuda._dims(get_folded_engine(n, device="cpu"))
    h = np.arange(n)
    k = _bitrev(_unfold(h, logn, logc), logn)
    np.testing.assert_array_equal(_folded_slot(k, logn, logc), h)
    np.testing.assert_array_equal(np.sort(k), h)


@pytest.mark.parametrize("n_primes", (3, 4))
def test_cluster_garner_shares_cover_each_coefficient_once(n_primes):
    """Block r of a cluster reconstructs coefficients [r s, min(2N, (r+1) s)),
    s = ceil(2N / P), of the two accumulator rows."""
    for n in (256, 2048):
        share = (2 * n + n_primes - 1) // n_primes
        covered = np.concatenate([np.arange(r * share, min(2 * n, (r + 1) * share)) for r in range(n_primes)])
        np.testing.assert_array_equal(covered, np.arange(2 * n))


@pytest.mark.parametrize("g", GROUPS)
def test_own_keygen_decrypts(carried, g):
    _, _, keys, _, _ = carried
    params = dataclasses.replace(
        tp.TOY_SHORTINT, name="MB_TEST", lwe_dimension=N_LWE, polynomial_size=N,
        pbs=tp.GadgetParams(base_log=23, level=1),
    )
    ck, sk = tsi.keygen(params, seed=20 + g, multibit_group=g, device="cpu")
    assert isinstance(sk.bsk, tmb.MultiBitBootstrapKey) and sk.bsk.group_size == g
    engine = get_folded_engine(N, device="cpu")
    assert sk.bsk.shift == keys[g][0].shift == 64 - tmb.multibit_msb(params.pbs, g, engine)
    vals = torch.tensor([0, 1, 2, 3, 2, 1])
    c = tsi.encrypt(ck, vals, FheRng(30 + g, device="cpu"))
    out = tsi.apply_function(sk, c, lambda v: (3 * v + 1) % 4)
    assert torch.equal(tsi.decrypt(ck, out), (3 * vals + 1) % 4)


def test_loop_form_decrypts():
    """Level-2 gadget (TOY_SHORTINT): the aggregate-then-external-product loop."""
    ck, sk = tsi.keygen(tp.TOY_SHORTINT, seed=9, multibit_group=2, device="cpu")
    assert not tmb.uses_fused_group_steps(sk.bsk, 2)
    vals = torch.tensor([0, 1, 2, 3])
    out = tsi.apply_function(sk, tsi.encrypt(ck, vals, FheRng(10, device="cpu")), lambda v: (v * v) % 4)
    assert torch.equal(tsi.decrypt(ck, out), (vals * vals) % 4)


def test_keygen_reads_group_from_name():
    for g in GROUPS:
        name = f"PARAM_MULTI_BIT_GROUP_{g}_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128"
        assert tsi.multibit_group_of(tp.by_name(name)) == g
    assert tsi.multibit_group_of(tp.PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128) is None
    assert tp.by_name("PARAM_MULTI_BIT_GROUP_3_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128").lwe_dimension == 882
    params = dataclasses.replace(tp.TOY_SHORTINT, name="TOY_MULTI_BIT_GROUP_4_TEST")
    _, sk = tsi.keygen(params, seed=1, device="cpu")
    assert isinstance(sk.bsk, tmb.MultiBitBootstrapKey) and sk.bsk.group_size == 4


def test_group_steps_checks_shapes():
    te = get_folded_engine(N, device="cpu")
    acc = torch.zeros(2, 2, N, dtype=torch.int64)
    table = torch.zeros(2 * N, 3, 2, N, dtype=torch.int32)
    bsk = torch.zeros(1, 8, 2, 2, 3, 2, N, dtype=torch.int32)
    with pytest.raises(ValueError, match="group size"):
        mbc.group_steps(acc, torch.zeros(5, 2, dtype=torch.int32), bsk, table, te, 23, 10, 5)
    with pytest.raises(ValueError, match="bsk_ntt"):
        mbc.group_steps(acc, torch.zeros(3, 2, dtype=torch.int32), bsk[:, :4], table, te, 23, 10, 3)
    with pytest.raises(ValueError, match="a must be"):
        mbc.group_steps(acc, torch.zeros(4, 2, dtype=torch.int32), bsk, table, te, 23, 10, 3)
