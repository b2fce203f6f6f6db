"""tfhe_tpu_torch blind rotation vs the JAX package, bit for bit.

* the plain K3 steps (ops/blind_rotate_cuda.cmux_steps_plain) against the
  JAX Pallas kernel make_pallas_blind_rotate (interpret mode) on random
  accumulators, monomial-table rows and BSK rows;
* the port's Garner against FoldedCrtEngine.crt_reconstruct, and the
  CUDA kernels' `garner_u32`, replayed in numpy from the constants it is
  given;
* K3's own arithmetic (csrc/blind_rotate.cu), replayed in numpy: NTT(X^a - 1)
  from powers of psi, with its Shoup companion, equals `monomial_ntt_table`
  word for word for every a in [0, 2N); one step in the kernel's order
  (digits per prime, register-round NTTs, EP x (m - 1) at folded slots,
  inverse rounds, the cluster's Garner shares, acc +=) equals
  `one_step_plain` bit for bit;
* with JAX keys carried across (convert.py), the port's blind_rotate and
  keyswitch_pbs against JAX keyswitch -> bt._blind_rotate_fused (->
  sample_extract), computed once (the test_fused_blind_rotate setup:
  N=256, n=12, k=1, level 1 / base_log 23, 6 ciphertexts); apply_function
  decrypting like the JAX package's; the external-product loop of other
  shapes against the JAX scan; the carried keys land on the card unless
  the CPU is asked for.
"""

import dataclasses
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu import params as jp
from tfhe_tpu.core import bootstrap as jbt
from tfhe_tpu.core.lwe import keyswitch as jax_keyswitch
from tfhe_tpu.core.lwe import sample_extract as jax_sample_extract
from tfhe_tpu.models import shortint as jsi
from tfhe_tpu.ops.folded_ntt import get_folded_engine as jax_engine
from tfhe_tpu.ops.pallas_blind_rotate import bsk_to_step_layout as jax_step_layout
from tfhe_tpu.ops.pallas_blind_rotate import make_pallas_blind_rotate
from tfhe_tpu.rng import FheRng as JaxRng
from tfhe_tpu.torus import mod_switch, negacyclic_monomial_rotate
from tfhe_tpu_torch import _u64, convert
from tfhe_tpu_torch.core import bootstrap as tbt
from tfhe_tpu_torch.core.lwe import keyswitch
from tfhe_tpu_torch.models import shortint as tsi
from tfhe_tpu_torch.ops import blind_rotate_cuda as brc
from tfhe_tpu_torch.ops import ntt_cuda
from tfhe_tpu_torch.ops.folded_ntt import get_folded_engine
from test_torch_port_multibit import (
    _bitrev, _digit_residue, _garner_u32, _k4_ntt_forward, _k4_ntt_inverse, _mul_shoup, _shoup_companion, _unfold,
)


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
SHIFT = 11


def _random_shoup_rows(te, rng, lead):
    res = np.stack([rng.integers(0, p, size=lead + (N,)) for p in te.primes], axis=-2)
    return te.make_shoup(torch.from_numpy(res))


def test_plain_steps_match_pallas_kernel():
    je, te = jax_engine(N), get_folded_engine(N, device="cpu")
    rng = np.random.default_rng(0)
    b, steps = 8, 2
    acc = rng.integers(0, 2**64, size=(b, 2, N), dtype=np.uint64)
    table = _random_shoup_rows(te, rng, (2 * N,))  # (2N, P, 2, N)
    bsk = _random_shoup_rows(te, rng, (steps, 2, 2))  # (steps, 2, 2, P, 2, N)
    exps = rng.integers(0, 2 * N, size=(steps, b))
    got = brc.cmux_steps_plain(
        convert.u64_tensor(acc), torch.from_numpy(exps), bsk, table, te, 23, SHIFT
    )
    # the public wrapper takes the plain version for CPU tensors
    again = brc.cmux_steps(convert.u64_tensor(acc), torch.from_numpy(exps), bsk, table, te, 23, SHIFT)
    assert torch.equal(got, again)

    table_np = table.numpy().view(np.uint32)
    rows = table_np[exps]  # (steps, B, P, 2, N)
    rv = jnp.asarray(rows[..., 0, :].reshape(steps, b * te.n_primes, N))
    rs = jnp.asarray(rows[..., 1, :].reshape(steps, b * te.n_primes, N))
    bv, bs = jax_step_layout(jnp.asarray(bsk.numpy().view(np.uint32)))
    flat = acc.reshape(b * 2, N)
    lo = jnp.asarray((flat & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    hi = jnp.asarray((flat >> np.uint64(32)).astype(np.uint32))
    step = make_pallas_blind_rotate(je, 23, SHIFT, tm=8, steps=steps)
    olo, ohi = step(lo, hi, rv, rs, bv, bs)
    want = np.asarray(olo).astype(np.uint64) | (np.asarray(ohi).astype(np.uint64) << np.uint64(32))
    np.testing.assert_array_equal(_u64.u64_to_numpy(got), want.reshape(b, 2, N))


def test_step_layout_matches_reference():
    te = get_folded_engine(N, device="cpu")
    bsk = _random_shoup_rows(te, np.random.default_rng(1), (3, 2, 2))
    v, s = brc.bsk_to_step_layout(bsk)
    jv, js = jax_step_layout(jnp.asarray(bsk.numpy().view(np.uint32)))
    np.testing.assert_array_equal(v.numpy().view(np.uint32), np.asarray(jv))
    np.testing.assert_array_equal(s.numpy().view(np.uint32), np.asarray(js))


def test_garner_matches_reference():
    je, te = jax_engine(N), get_folded_engine(N, device="cpu")
    rng = np.random.default_rng(2)
    res = [rng.integers(0, p, size=(3, N)).astype(np.uint32) for p in te.primes]
    # extremes of the signed range around prod/2 and 0
    for i, h in enumerate(te.garner.h):
        res[i][0, :3] = (h, h, 0)
    res[0][0, 1] = te.garner.h[0] + 1
    got = _u64.u64_to_numpy(te.crt_reconstruct([convert.u32_tensor(r) for r in res]))
    want = np.asarray(je.crt_reconstruct([jnp.asarray(r) for r in res]))
    np.testing.assert_array_equal(got, want)
    gs = ntt_cuda.garner_consts_shoup(te).numpy().view(np.uint32)
    np.testing.assert_array_equal(_garner_u32(res, gs) << np.uint64(SHIFT), want << np.uint64(SHIFT))


# -- csrc/blind_rotate.cu arithmetic, replayed in numpy ------------------------


def _k3_monomial(te, r, e):
    """K3's NTT(X^e - 1) at every folded slot h = tq R + s for prime r:
    m = psi^((2 tq + 1) e mod 2N) . omega^(s e mod R) - 1 (omega = psi^(2C))
    and its exact Shoup companion; e (E, 1) -> two (E, N) arrays."""
    logn, logc = ntt_cuda._dims(te)
    logr = logn - logc
    p = te.primes[r]
    psi = ntt_cuda.psi_powers(te).numpy().view(np.uint32)[r]  # (2, 2N)
    gs = ntt_cuda.garner_consts_shoup(te).numpy().view(np.uint32)
    h = np.arange(te.n)
    s, tq = h & ((1 << logr) - 1), h >> logr
    ta = ((2 * tq + 1) * e) & (2 * te.n - 1)
    omega = psi[0, ((s * e) & ((1 << logr) - 1)) << (logc + 1)]
    m = _mul_shoup(omega, psi[0, ta], psi[1, ta], p)
    m = np.where(m >= 1, m - 1, m + p - 1)  # sub_mod(m, 1, p)
    return m, _shoup_companion(m, p, gs[52 + r], gs[56 + r])


def test_k3_monomials_give_the_rot_table():
    """Every a in [0, 2N), a = 0 (the zero row) and a >= N (X^(N+j) = -X^j)
    included: values and Shoup companions word for word."""
    te = get_folded_engine(N, device="cpu")
    table = brc.monomial_ntt_table(te).numpy().view(np.uint32)  # (2N, P, 2, N)
    for r in range(te.n_primes):
        m, ms = _k3_monomial(te, r, np.arange(2 * N)[:, None])
        assert not m[0].any()
        np.testing.assert_array_equal(m, table[:, r, 0])
        np.testing.assert_array_equal(ms, table[:, r, 1])


def _k3_step(te, acc, e, bsk, base_log, shift):
    """One K3 step in the kernel's order, in numpy: acc (B, 2, N) uint64,
    e (B,) exponents, bsk (2, 2, P, 2, N) uint32 the step's GGSW rows
    (d, c, prime, value / Shoup) -> the new accumulators."""
    logn, logc = ntt_cuda._dims(te)
    tw, pp = (t.numpy().view(np.uint32).astype(np.uint64) for t in ntt_cuda.kernel_tables(te))
    gs = ntt_cuda.garner_consts_shoup(te).numpy().view(np.uint32)
    b, n = acc.shape[0], te.n
    k = _bitrev(_unfold(np.arange(n), logn, logc), logn)  # NTT slot of folded slot h
    res = []
    for r, p in enumerate(te.primes):
        # the digit rows of all ciphertexts as the columns of one (N, 2B) array
        d = _digit_residue(acc, base_log, p).reshape(2 * b, n).T
        f = _k4_ntt_forward(d, tw[r, 0], tw[r, 1], p, logn).T.reshape(b, 2, n)[:, :, k]
        m, ms = _k3_monomial(te, r, e[:, None])
        out = np.empty((b, 2, n), dtype=np.uint64)
        for c in range(2):
            ep = (_mul_shoup(f[:, 0], bsk[0, c, r, 0], bsk[0, c, r, 1], p)
                  + _mul_shoup(f[:, 1], bsk[1, c, r, 0], bsk[1, c, r, 1], p)) % p
            out[:, c, k] = _mul_shoup(ep, m, ms, p)
        inv = _k4_ntt_inverse(out.reshape(2 * b, n).T, tw[r, 2], tw[r, 3], p, pp[r, 1], pp[r, 2], logn)
        res.append(inv.T.reshape(b, 2 * n))
    # block r of the cluster adds the Garner of coefficients [lo, hi)
    new = acc.reshape(b, 2 * n).copy()
    share = -(-2 * n // te.n_primes)
    for r in range(te.n_primes):
        sl = slice(r * share, min(2 * n, (r + 1) * share))
        new[:, sl] += _garner_u32([x[:, sl] for x in res], gs) << np.uint64(shift)
    return new.reshape(b, 2, n)


def test_k3_step_order_matches_plain():
    """Three steps on random accumulators and key rows, exponents 0 and
    >= N among them: the kernel's order equals one_step_plain bit for bit,
    and the next step's digits come from the new accumulator."""
    te = get_folded_engine(N, device="cpu")
    rng = np.random.default_rng(12)
    b, steps = 3, 3
    acc = rng.integers(0, 2**64, size=(b, 2, N), dtype=np.uint64)
    bsk = _random_shoup_rows(te, rng, (steps, 2, 2))
    exps = rng.integers(0, 2 * N, size=(steps, b))
    exps[0, 0], exps[1, 1], exps[2, 2] = 0, N, 2 * N - 1
    table = brc.monomial_ntt_table(te)
    bv, bs = brc.bsk_to_step_layout(bsk)
    want = convert.u64_tensor(acc)
    got = acc
    for j in range(steps):
        rows = table[torch.from_numpy(exps[j])]  # (B, P, 2, N)
        want = brc.one_step_plain(want, rows[..., 0, :], rows[..., 1, :], bv[j], bs[j], te, 23, SHIFT)
        got = _k3_step(te, got, exps[j], bsk[j].numpy().view(np.uint32), 23, SHIFT)
        np.testing.assert_array_equal(got, _u64.u64_to_numpy(want), err_msg=f"step {j}")


@pytest.fixture(scope="module")
def fused_setup():
    params = dataclasses.replace(
        jp.TOY_SHORTINT,
        name="FUSED_TEST",
        lwe_dimension=12,
        glwe_dimension=1,
        polynomial_size=N,
        pbs=jp.GadgetParams(base_log=23, level=1),
    )
    ck, sk = jsi.keygen(params, seed=2)
    tck, tsk = convert.keys_from_reference(ck, sk, device="cpu")
    return params, ck, sk, tck, tsk


@pytest.fixture(scope="module")
def fused_reference(fused_setup):
    """Six big-key ciphertexts, a LUT, and the JAX package's keyswitch ->
    _blind_rotate_fused of them (the Pallas kernel in interpret mode, run
    once for the tests below)."""
    params, ck, sk, _, _ = fused_setup
    vals = jnp.asarray([0, 1, 2, 3, 1, 2], dtype=jnp.uint64)
    ct = jsi.encrypt(ck, vals, JaxRng(6))
    lut = jsi.generate_lut(params, np.asarray([(3 * v) % 4 for v in range(16)], dtype=np.uint64))
    small = jax_keyswitch(ct.ct, sk.ksk)
    two_n = 2 * N
    ms = mod_switch(small, int(math.log2(two_n)))
    acc = negacyclic_monomial_rotate(lut, (jnp.uint64(two_n) - ms[..., -1])[..., None])
    acc = jnp.broadcast_to(acc, ms[..., -1].shape + (2, N))
    rotated = jbt._blind_rotate_fused(acc, jnp.moveaxis(ms[..., :-1], -1, 0), sk.bsk, jsi.engine_for(params))
    return vals, ct, lut, small, np.asarray(rotated)


def test_blind_rotate_matches_fused_reference(fused_setup, fused_reference):
    _, _, _, tck, tsk = fused_setup
    _, _, lut, small, rotated = fused_reference
    assert tbt.uses_fused_cmux(tsk.bsk, 2)
    got = tbt.blind_rotate(
        convert.u64_tensor(lut), convert.u64_tensor(small), tsk.bsk, tsi.engine_for(tck.params, "cpu")
    )
    np.testing.assert_array_equal(_u64.u64_to_numpy(got), rotated)


def test_keyswitch_pbs_matches_reference(fused_setup, fused_reference):
    """The port's keyswitch_pbs equals JAX keyswitch -> _blind_rotate_fused
    -> sample_extract bit for bit."""
    _, _, _, _, tsk = fused_setup
    _, ct, lut, _, rotated = fused_reference
    want = np.asarray(jax_sample_extract(jnp.asarray(rotated), 0))
    got = tbt.keyswitch_pbs(
        convert.u64_tensor(ct.ct), convert.u64_tensor(lut), tsk.bsk, tsk.ksk, get_folded_engine(N, device="cpu")
    )
    np.testing.assert_array_equal(_u64.u64_to_numpy(got), want)


def test_apply_function_decrypts_like_reference(fused_setup, fused_reference):
    """JAX's CPU default (scan branch) and the port (fused form) differ by
    noise only: both decrypt to f(v)."""
    params, ck, sk, tck, tsk = fused_setup
    vals, ct, _, _, _ = fused_reference
    f = lambda v: (v + 1) % 4
    ref = jsi.apply_function(sk, ct, f)
    ours = tsi.apply_function(
        tsk, tsi.Ciphertext(ct=convert.u64_tensor(ct.ct), params=tck.params, degree=ct.degree, noise_level=1), f
    )
    assert ours.degree == ref.degree
    want = np.asarray(jsi.decrypt(ck, ref))
    np.testing.assert_array_equal(want, (np.asarray(vals) + 1) % 4)
    np.testing.assert_array_equal(tsi.decrypt(tck, ours).numpy(), want)
    as_ref = jsi.Ciphertext(ct=jnp.asarray(_u64.u64_to_numpy(ours.ct)), params=params, degree=3, noise_level=1)
    np.testing.assert_array_equal(np.asarray(jsi.decrypt(ck, as_ref)), want)


def test_keys_from_reference_default_to_the_card(fused_setup):
    """Without a device the carried keys go to the card: they land on cuda
    where there is one, and the call raises where there is none."""
    _, ck, sk, _, _ = fused_setup
    if torch.cuda.is_available():
        tck, tsk = convert.keys_from_reference(ck, sk)
        assert tck.lwe_key.key.is_cuda and tsk.bsk.bsk_ntt.is_cuda and tsk.ksk.ksk.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            convert.keys_from_reference(ck, sk)


def test_rot_table_matches_reference(fused_setup):
    _, _, sk, _, tsk = fused_setup
    got = brc.monomial_ntt_table(get_folded_engine(N, device="cpu"))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(sk.bsk.rot_table))
    assert torch.equal(got, tsk.bsk.rot_table)


def test_external_product_loop_matches_scan():
    """Level-2 gadget (TOY_SHORTINT): the Python loop of external
    products against the JAX lax.scan branch."""
    params = jp.TOY_SHORTINT
    ck, sk = jsi.keygen(params, seed=3)
    tck, tsk = convert.keys_from_reference(ck, sk, device="cpu")
    small = jax_keyswitch(jsi.encrypt(ck, jnp.asarray([0, 1, 2, 3], dtype=jnp.uint64), JaxRng(5)).ct, sk.ksk)
    lut = jsi.generate_lut(params, np.arange(16, dtype=np.uint64))
    want = jbt.blind_rotate(lut, small, sk.bsk, jsi.engine_for(params))
    assert not tbt.uses_fused_cmux(tsk.bsk, 2)
    got = tbt.blind_rotate(
        convert.u64_tensor(lut), convert.u64_tensor(small), tsk.bsk, tsi.engine_for(tck.params, "cpu")
    )
    np.testing.assert_array_equal(_u64.u64_to_numpy(got), np.asarray(want))


def test_cmux_wrapper_checks_shapes():
    te = get_folded_engine(N, device="cpu")
    acc = torch.zeros(2, 2, N, dtype=torch.int64)
    with pytest.raises(ValueError, match="bsk_ntt"):
        brc.cmux_steps(acc, torch.zeros(1, 2, dtype=torch.int32), torch.zeros(1, 2, dtype=torch.int32),
                       torch.zeros(2 * N, 3, 2, N, dtype=torch.int32), te, 23, SHIFT)
