"""The classic shortint slice of tfhe_tpu_torch as a whole, on the CPU.

* With JAX keys carried across, the port's keyswitch_pbs equals, bit for
  bit, JAX keyswitch -> _blind_rotate_fused -> sample_extract; the JAX
  CPU default (the lax.scan branch, equal to the fused form up to noise)
  decrypts to the same values as the port.
* With its own keygen, apply_lut, bivariate_pbs and mul decrypt to the
  clear results, and degree bookkeeping matches the JAX package.
* The package imports neither jax nor tfhe_tpu, and its entry points
  refuse to fall back to the CPU when no device is named.
"""

import dataclasses
import math
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
from tfhe_tpu.torus import mod_switch, negacyclic_monomial_rotate
from tfhe_tpu_torch import _u64, convert
from tfhe_tpu_torch import params as tp
from tfhe_tpu_torch.core import bootstrap as tbt
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


@pytest.fixture(scope="module")
def carried():
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
    vals = jnp.asarray([0, 1, 2, 3, 1, 2], dtype=jnp.uint64)
    ct = jsi.encrypt(ck, vals, JaxRng(6))
    return params, ck, sk, tck, tsk, vals, ct


def test_keyswitch_pbs_matches_reference(carried):
    params, ck, sk, tck, tsk, vals, ct = carried
    lut = jsi.generate_lut(params, np.asarray([(3 * v) % 4 for v in range(16)], dtype=np.uint64))
    small = jax_keyswitch(ct.ct, sk.ksk)
    ms = mod_switch(small, int(math.log2(2 * N)))
    acc = negacyclic_monomial_rotate(lut, (jnp.uint64(2 * N) - ms[..., -1])[..., None])
    acc = jnp.broadcast_to(acc, ms[..., -1].shape + (2, N))
    rotated = jbt._blind_rotate_fused(acc, jnp.moveaxis(ms[..., :-1], -1, 0), sk.bsk, jsi.engine_for(params))
    want = np.asarray(jax_sample_extract(rotated, 0))
    got = tbt.keyswitch_pbs(
        convert.u64_tensor(ct.ct), convert.u64_tensor(lut), tsk.bsk, tsk.ksk, get_folded_engine(N, "cpu")
    )
    np.testing.assert_array_equal(_u64.u64_to_numpy(got), want)


def test_apply_function_decrypts_like_reference(carried):
    """JAX's CPU default (scan branch) and the port (fused form) differ by
    noise only: both decrypt to f(v)."""
    params, ck, sk, tck, tsk, vals, ct = carried
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
    code = (
        "import sys, tfhe_tpu_torch.models.shortint, tfhe_tpu_torch.convert, "
        "tfhe_tpu_torch.ops.ntt_cuda, tfhe_tpu_torch.ops.blind_rotate_cuda, "
        "tfhe_tpu_torch.core.multibit, tfhe_tpu_torch.ops.multibit_cuda, "
        "tfhe_tpu_torch.models.integer, tfhe_tpu_torch.parallel.dispatch; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tfhe_tpu')); "
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
