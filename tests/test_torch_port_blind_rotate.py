"""tfhe_tpu_torch blind rotation vs the JAX package, bit for bit.

* the plain K3 steps (ops/blind_rotate_cuda.cmux_steps_plain) against the
  JAX Pallas kernel make_pallas_blind_rotate (interpret mode) on random
  accumulators, monomial-table rows and BSK rows;
* the port's Garner against FoldedCrtEngine.crt_reconstruct, and the
  CUDA kernel's native-u64 Garner, replayed in numpy from the constants
  it is given;
* with JAX keys carried across (convert.py), the port's blind_rotate
  against bt._blind_rotate_fused (the test_fused_blind_rotate setup:
  N=256, n=12, k=1, level 1 / base_log 23, 5 ciphertexts), and the
  external-product loop of other shapes against the JAX scan.
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


N = 256
SHIFT = 11


def _random_shoup_rows(te, rng, lead):
    res = np.stack([rng.integers(0, p, size=lead + (N,)) for p in te.primes], axis=-2)
    return te.make_shoup(torch.from_numpy(res))


def test_plain_steps_match_pallas_kernel():
    je, te = jax_engine(N), get_folded_engine(N, "cpu")
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
    te = get_folded_engine(N, "cpu")
    bsk = _random_shoup_rows(te, np.random.default_rng(1), (3, 2, 2))
    v, s = brc.bsk_to_step_layout(bsk)
    jv, js = jax_step_layout(jnp.asarray(bsk.numpy().view(np.uint32)))
    np.testing.assert_array_equal(v.numpy().view(np.uint32), np.asarray(jv))
    np.testing.assert_array_equal(s.numpy().view(np.uint32), np.asarray(js))


def _kernel_garner(res, gc, n_pr, shift):
    """csrc/blind_rotate.cu's Garner in numpy uint64 (wrapping) arithmetic."""
    gc = gc.astype(np.uint64)
    v = [res[0].astype(np.uint64)]
    for q in range(1, n_pr):
        pq = gc[q]
        tq = v[q - 1]
        for j in range(q - 2, -1, -1):
            tq = (tq * gc[8 + 4 * q + j] + v[j]) % pq
        d = (res[q].astype(np.uint64) + pq - tq % pq) % pq
        v.append(d * gc[4 + q] % pq)
    x = v[-1]
    for j in range(n_pr - 2, -1, -1):
        x = v[j] + gc[j] * x
    neg = v[-1] > gc[24 + n_pr - 1]
    eq = v[-1] == gc[24 + n_pr - 1]
    for j in range(n_pr - 2, -1, -1):
        neg = neg | (eq & (v[j] > gc[24 + j]))
        eq = eq & (v[j] == gc[24 + j])
    x = np.where(neg, x - gc[28], x)
    return x << np.uint64(shift)


def test_garner_matches_reference():
    je, te = jax_engine(N), get_folded_engine(N, "cpu")
    rng = np.random.default_rng(2)
    res = [rng.integers(0, p, size=(3, N)).astype(np.uint32) for p in te.primes]
    # extremes of the signed range around prod/2 and 0
    for i, h in enumerate(te.garner.h):
        res[i][0, :3] = (h, h, 0)
    res[0][0, 1] = te.garner.h[0] + 1
    got = _u64.u64_to_numpy(te.crt_reconstruct([convert.u32_tensor(r) for r in res]))
    want = np.asarray(je.crt_reconstruct([jnp.asarray(r) for r in res]))
    np.testing.assert_array_equal(got, want)
    gc = _u64.u64_to_numpy(brc.garner_consts(te))
    np.testing.assert_array_equal(_kernel_garner(res, gc, te.n_primes, SHIFT), want << np.uint64(SHIFT))


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
    tck, tsk = convert.keys_from_reference(ck, sk)
    return params, ck, sk, tck, tsk


def test_blind_rotate_matches_fused_reference(fused_setup):
    params, ck, sk, tck, tsk = fused_setup
    vals = jnp.arange(5, dtype=jnp.uint64) % jnp.uint64(4)
    small = jax_keyswitch(jsi.encrypt(ck, vals, JaxRng(4)).ct, sk.ksk)
    lut = jsi.generate_lut(params, np.arange(16, dtype=np.uint64))
    two_n = 2 * N
    ms = mod_switch(small, int(math.log2(two_n)))
    acc = negacyclic_monomial_rotate(lut, (jnp.uint64(two_n) - ms[..., -1])[..., None])
    acc = jnp.broadcast_to(acc, ms[..., -1].shape + (2, N))
    want = jbt._blind_rotate_fused(acc, jnp.moveaxis(ms[..., :-1], -1, 0), sk.bsk, jsi.engine_for(params))
    t_lut = tsi.generate_lut(tck.params, np.arange(16, dtype=np.uint64), device="cpu")
    assert tbt.uses_fused_cmux(tsk.bsk, 2)
    got = tbt.blind_rotate(t_lut, convert.u64_tensor(small), tsk.bsk, tsi.engine_for(tck.params, "cpu"))
    np.testing.assert_array_equal(_u64.u64_to_numpy(got), np.asarray(want))


def test_rot_table_matches_reference(fused_setup):
    _, _, sk, _, tsk = fused_setup
    got = brc.monomial_ntt_table(get_folded_engine(N, "cpu"))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(sk.bsk.rot_table))
    assert torch.equal(got, tsk.bsk.rot_table)


def test_external_product_loop_matches_scan():
    """Level-2 gadget (TOY_SHORTINT): the Python loop of external
    products against the JAX lax.scan branch."""
    params = jp.TOY_SHORTINT
    ck, sk = jsi.keygen(params, seed=3)
    tck, tsk = convert.keys_from_reference(ck, sk)
    small = jax_keyswitch(jsi.encrypt(ck, jnp.asarray([0, 1, 2, 3], dtype=jnp.uint64), JaxRng(5)).ct, sk.ksk)
    lut = jsi.generate_lut(params, np.arange(16, dtype=np.uint64))
    want = jbt.blind_rotate(lut, small, sk.bsk, jsi.engine_for(params))
    assert not tbt.uses_fused_cmux(tsk.bsk, 2)
    got = tbt.blind_rotate(
        convert.u64_tensor(lut), convert.u64_tensor(small), tsk.bsk, tsi.engine_for(tck.params, "cpu")
    )
    np.testing.assert_array_equal(_u64.u64_to_numpy(got), np.asarray(want))


def test_cmux_wrapper_checks_shapes():
    te = get_folded_engine(N, "cpu")
    acc = torch.zeros(2, 2, N, dtype=torch.int64)
    with pytest.raises(ValueError, match="bsk_ntt"):
        brc.cmux_steps(acc, torch.zeros(1, 2, dtype=torch.int32), torch.zeros(1, 2, dtype=torch.int32),
                       torch.zeros(2 * N, 3, 2, N, dtype=torch.int32), te, 23, SHIFT)
