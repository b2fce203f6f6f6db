"""The 4-prime CRT set (FOLDED_PRIMES_4) of tfhe_tpu_torch.ops.folded_ntt
against the JAX package's.

The cases of tests/test_four_prime.py on the port's plain engine, each
held against the Python-int ground truth and, on the same inputs, against
the JAX engine (the lazy residues of the forward transforms included: the
port runs the same three-digit-plane arithmetic). The fused rotations at
P = 4 (K3's and K4's plain versions on the CPU) run on keys the port draws
itself from the seed the JAX test uses, carried to the JAX package, and
are held against the JAX package's XLA scans
(`bt.blind_rotate`, `multibit_blind_rotate`): the multi-bit form bit for
bit; the classic form as the JAX test holds it, by its decryption, with
the port's scan form bit for bit. Engines take `primes=`
explicitly; one subprocess shows the TFHE_TPU_PRIMES=4 switch, and the
consumers of the prime set (`noise._crt_prod`, `keycache.cache_path`)
follow it.
"""

import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu import noise as jnoise
from tfhe_tpu import params as jp
from tfhe_tpu.core import bootstrap as jbt
from tfhe_tpu.core import keys as jkeys
from tfhe_tpu.core import multibit as jmb
from tfhe_tpu.core.lwe import encrypt_lwe as jax_encrypt_lwe
from tfhe_tpu.models import shortint as jsi
from tfhe_tpu.ops import folded_ntt as jfn
from tfhe_tpu.rng import FheRng as JaxRng
from tfhe_tpu.torus import encode as jax_encode
from tfhe_tpu.utils import keycache as jkc
from tfhe_tpu_torch import noise as tnoise
from tfhe_tpu_torch import params as tp
from tfhe_tpu_torch.core import bootstrap as tbt
from tfhe_tpu_torch.core import multibit as tmb
from tfhe_tpu_torch.core.ggsw import external_product
from tfhe_tpu_torch.core.keys import gen_glwe_secret_key, gen_lwe_secret_key, glwe_to_lwe_secret_key
from tfhe_tpu_torch.core.lwe import decrypt_lwe, encrypt_lwe, sample_extract
from tfhe_tpu_torch.models import shortint as tsi
from tfhe_tpu_torch.ops import folded_ntt as tfn
from tfhe_tpu_torch.ops.folded_ntt import FOLDED_PRIMES, FOLDED_PRIMES_4, FoldedNtt, get_folded_engine
from tfhe_tpu_torch.ops.polynomial import _is_prime, negacyclic_polymul_reference
from tfhe_tpu_torch.rng import FheRng
from tfhe_tpu_torch.torus import decode, encode, mod_switch, negacyclic_monomial_rotate
from tfhe_tpu_torch.utils import keycache as tkc

PRIME_SETS = [FOLDED_PRIMES, FOLDED_PRIMES_4]
PRIME_IDS = ["3p", "4p"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several test processes side by side; the port's many
    small tensor ops run fastest, and slow the other processes least, on
    one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t64(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64 else a.astype(np.int64))


def u64(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint64)


def u32(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def test_prime_set_is_valid():
    """The JAX package's set: ascending, prime, 2^13 | p-1, three digit
    planes, CRT range above 2^95; the process default is the 3-prime set."""
    assert FOLDED_PRIMES_4 == jfn.FOLDED_PRIMES_4 and FOLDED_PRIMES == jfn.FOLDED_PRIMES
    assert tuple(FOLDED_PRIMES_4) == tuple(sorted(FOLDED_PRIMES_4))
    for p in FOLDED_PRIMES_4:
        assert _is_prime(p)
        assert (p - 1) % (1 << 13) == 0
        assert p <= 16580352
    assert math.prod(FOLDED_PRIMES_4) > 2**95
    assert tfn.default_primes() == tfn.DEFAULT_PRIMES == FOLDED_PRIMES
    with pytest.raises(AssertionError):
        tfn.FoldedCrtEngine(64, primes=FOLDED_PRIMES_4[::-1], device="cpu")
    with pytest.raises(AssertionError):  # mixed digit planes
        tfn.FoldedCrtEngine(64, primes=(FOLDED_PRIMES_4[0], FOLDED_PRIMES[0]), device="cpu")


@pytest.mark.parametrize("p", list(FOLDED_PRIMES_4))
def test_roundtrip_single_prime_4p(p):
    ntt = FoldedNtt(p, 256, torch.device("cpu"))
    assert ntt.na == 3
    x = np.random.default_rng(0).integers(0, p, size=(3, 256), dtype=np.uint64).astype(np.int64)
    f = ntt.forward_signed(torch.from_numpy(x))
    np.testing.assert_array_equal(ntt.inverse(f).numpy(), x)
    # the lazy [0, 2p) residues are the JAX engine's
    jf = jfn.FoldedNtt(p, 256).forward_signed(jnp.asarray(x, dtype=jnp.int32))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf).astype(np.int64))


@pytest.mark.parametrize("primes", PRIME_SETS, ids=PRIME_IDS)
@pytest.mark.parametrize("n", [64, 256])
def test_polymul_mod_2_64(n, primes):
    eng = get_folded_engine(n, primes=primes, device="cpu")
    assert eng.primes == tuple(primes) and eng.n_primes == len(primes)
    assert get_folded_engine(n, primes=list(primes), device="cpu") is eng  # cached by (n, device, primes)
    rng = np.random.default_rng(2)
    a = rng.integers(-(2**9), 2**9, size=(n,))
    b = rng.integers(0, 2**64, size=(n,), dtype=np.uint64)
    out = u64(eng.polymul(t64(a), t64(b)))
    np.testing.assert_array_equal(out, np.array([int(v) for v in negacyclic_polymul_reference(a, b)], dtype=np.uint64))
    if n == 64:  # the JAX engine's transforms compile per N
        jeng = jfn.get_folded_engine(n, primes)
        np.testing.assert_array_equal(u32(eng.forward_small(t64(a))), np.asarray(jeng.forward_small(jnp.asarray(a))))
        np.testing.assert_array_equal(u32(eng.forward_u64(t64(b))), np.asarray(jeng.forward_u64(jnp.asarray(b))))


def test_folded_engine_takes_primes_by_position():
    """primes is the second parameter, as in the JAX package, and device is
    keyword-only: the positional call gives the keyword call's cached
    engine, and a constructed one the same tables."""
    eng = get_folded_engine(64, FOLDED_PRIMES_4, device="cpu")
    assert eng is get_folded_engine(64, primes=FOLDED_PRIMES_4, device="cpu") and eng.primes == FOLDED_PRIMES_4
    own = tfn.FoldedCrtEngine(64, FOLDED_PRIMES_4, device="cpu")
    assert own.primes == eng.primes and own.device == eng.device == torch.device("cpu")
    x = t64(np.arange(64) - 32)
    assert torch.equal(own.forward_small(x), eng.forward_small(x))
    with pytest.raises(TypeError):
        get_folded_engine(64, FOLDED_PRIMES_4, "cpu")


def test_shoup_key_path_4p():
    n = 256
    eng = get_folded_engine(n, primes=FOLDED_PRIMES_4, device="cpu")
    rng = np.random.default_rng(4)
    a = rng.integers(-(2**10), 2**10, size=(3, n))
    b = rng.integers(0, 2**64, size=(n,), dtype=np.uint64)
    fa = eng.forward_small(t64(a))
    fb = eng.forward_u64(t64(b))
    key = eng.make_shoup(fb)
    out_shoup = eng.backward(eng.pointwise_shoup(fa, key))
    assert torch.equal(out_shoup, eng.backward(eng.pointwise_mul(fa, fb)))
    jeng = jfn.get_folded_engine(n, FOLDED_PRIMES_4)
    np.testing.assert_array_equal(u32(key), np.asarray(jeng.make_shoup(jeng.forward_u64(jnp.asarray(b)))))


def test_backward_shift_4p():
    n = 64
    eng = get_folded_engine(n, primes=FOLDED_PRIMES_4, device="cpu")
    rng = np.random.default_rng(5)
    a = rng.integers(-(2**10), 2**10, size=(n,))
    b = rng.integers(0, 2**44, size=(n,), dtype=np.uint64)
    f = eng.pointwise_mul(eng.forward_small(t64(a)), eng.forward_u64(t64(b)))
    out = u64(eng.backward(f, shift=20))
    want = np.array([int(x) << 20 & (2**64 - 1) for x in negacyclic_polymul_reference(a, b)], dtype=np.uint64)
    np.testing.assert_array_equal(out, want)


def test_max_product_bits_improves():
    """76 -> 83 bits at N = 2048, as the JAX engines; the classic and the
    g = 3 multi-bit key keep 55 bits (53 and 51 at three primes)."""
    e3 = get_folded_engine(2048, primes=FOLDED_PRIMES, device="cpu")
    e4 = get_folded_engine(2048, primes=FOLDED_PRIMES_4, device="cpu")
    assert (e3.max_product_bits, e4.max_product_bits) == (76, 83)
    g = tp.PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128.pbs
    assert [tmb.multibit_msb(g, 3, e) for e in (e3, e4)] == [51, 55]
    assert [min(55, e.max_product_bits - (g.base_log - 1) - 1) for e in (e3, e4)] == [53, 55]


def test_crt_prod_and_cache_tag_follow_the_prime_set(monkeypatch, tmp_path):
    """noise._crt_prod and keycache.cache_path read the process's set: at
    three primes the JAX package's values, at four the product of
    FOLDED_PRIMES_4 and a `_p4` file name, both as the JAX package's."""
    p = tp.PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128
    jpar = jp.PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128
    d = str(tmp_path)
    assert tnoise._crt_prod() == jnoise._crt_prod() == math.prod(FOLDED_PRIMES)
    assert os.path.basename(tkc.cache_path(p, 3, None, d)) == os.path.basename(jkc.cache_path(jpar, 3, None, d))
    monkeypatch.setattr(tfn, "DEFAULT_PRIMES", FOLDED_PRIMES_4)
    monkeypatch.setattr(jfn, "DEFAULT_PRIMES", jfn.FOLDED_PRIMES_4)
    assert tnoise._crt_prod() == jnoise._crt_prod() == math.prod(FOLDED_PRIMES_4)
    name = os.path.basename(tkc.cache_path(p, 3, None, d))
    assert name.endswith("_s3_g0_p4.tfhekeys")
    assert name == os.path.basename(jkc.cache_path(jpar, 3, None, d))


def test_env_switch_selects_four_primes():
    """TFHE_TPU_PRIMES=4, read once at import, makes FOLDED_PRIMES_4 the
    process's set: the default engine and shortint keys take it."""
    code = (
        "from tfhe_tpu_torch.ops import folded_ntt as f\n"
        "from tfhe_tpu_torch import params as tp\n"
        "from tfhe_tpu_torch.models import shortint as si\n"
        "assert f.default_primes() == f.DEFAULT_PRIMES == f.FOLDED_PRIMES_4\n"
        "e = si.engine_for(tp.TOY_SHORTINT, 'cpu')\n"
        "ck, sk = si.keygen(tp.TOY_SHORTINT, seed=7, device='cpu')\n"
        "print(e.n_primes, sk.bsk.bsk_ntt.shape[-3])\n"
    )
    env = dict(os.environ, TFHE_TPU_PRIMES="4", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["4", "4"]


# -- fused rotations at 4 primes against the JAX package's XLA scans -------------

P_L1 = dataclasses.replace(tp.TOY_SHORTINT_NOISELESS, name="TOY_SHORTINT_L1_4P", pbs=tp.GadgetParams(base_log=23, level=1))
JP_L1 = dataclasses.replace(jp.TOY_SHORTINT_NOISELESS, name="TOY_SHORTINT_L1_4P", pbs=jp.GadgetParams(base_log=23, level=1))


def _keys(seed: int, primes, group: int | None):
    """The JAX test's draws (small key, GLWE key, a fork for the BSK) in
    the port, equal to the JAX package's draws from the same seed; the BSK
    is carried to the JAX package, which saves its keygen's compile (the
    port's keygen is held against the JAX package's at P = 3 by the golden
    vectors and test_torch_port_multibit, and its P = 4 transforms and
    Shoup pairs by the engine cases above)."""
    n_poly = P_L1.polynomial_size
    eng = get_folded_engine(n_poly, primes=primes, device="cpu")
    jeng = jfn.get_folded_engine(n_poly, primes)
    rng, jrng = FheRng(seed, "cpu"), JaxRng(seed)
    lwe_sk, jlwe_sk = gen_lwe_secret_key(rng, P_L1.lwe_dimension), jkeys.gen_lwe_secret_key(jrng, P_L1.lwe_dimension)
    glwe_sk = gen_glwe_secret_key(rng, P_L1.glwe_dimension, n_poly)
    jglwe_sk = jkeys.gen_glwe_secret_key(jrng, P_L1.glwe_dimension, n_poly)
    np.testing.assert_array_equal(u64(lwe_sk.key), np.asarray(jlwe_sk.key))
    np.testing.assert_array_equal(u64(glwe_sk.key), np.asarray(jglwe_sk.key))
    jrng.fork()
    if group is None:
        bsk = tbt.gen_bootstrap_key(lwe_sk, glwe_sk, P_L1.pbs, rng.fork(), P_L1.glwe_noise, eng)
        jbsk = jbt.BootstrapKey(bsk_ntt=jnp.asarray(u32(bsk.bsk_ntt)), gadget=JP_L1.pbs, shift=bsk.shift)
    else:
        bsk = tmb.gen_multibit_bootstrap_key(lwe_sk, glwe_sk, P_L1.pbs, group, rng.fork(), P_L1.glwe_noise, eng)
        jbsk = jmb.MultiBitBootstrapKey(
            bsk_ntt=jnp.asarray(u32(bsk.bsk_ntt)), gadget=JP_L1.pbs, shift=bsk.shift, group_size=group,
            rot_table=None if bsk.rot_table is None else jnp.asarray(u32(bsk.rot_table)),
        )
    return eng, jeng, rng, jrng, lwe_sk, jlwe_sk, glwe_sk, bsk, jbsk


def _decrypt(glwe_sk, glwe, delta, space):
    return decode(decrypt_lwe(glwe_to_lwe_secret_key(glwe_sk), sample_extract(glwe, 0)), delta, space)


def _scan_rotate(lut, ct, bsk, eng):
    """The JAX package's XLA scan in the port: per step, rotate, then
    acc += EP(BSK_j, X^a acc - acc) (core/ggsw.external_product)."""
    two_n = 2 * bsk.poly_size
    ms = mod_switch(ct, int(math.log2(two_n)))
    acc = negacyclic_monomial_rotate(lut, (two_n - ms[..., -1])[..., None])
    acc = acc.expand(*ms.shape[:-1], *lut.shape[-2:])
    for j in range(bsk.lwe_dim):
        rot = negacyclic_monomial_rotate(acc, ms[..., j][..., None])
        acc = acc + external_product(bsk.bsk_ntt[j], rot - acc, bsk.gadget, eng, shift=bsk.shift)
    return acc


@pytest.mark.parametrize("primes", PRIME_SETS, ids=PRIME_IDS)
def test_fused_blind_rotate_4p_decrypts(primes):
    """With the port's keys from FheRng(7), at both prime sets: the port's
    scan form equals the JAX package's XLA scan bit for bit, and the fused
    classic rotation (K3's plain version, acc += (X^a - 1) EP(BSK_j, acc))
    decrypts as the scan does, to the LUT's values. The two forms decompose
    different accumulators, so their noise, and their bits, differ (the JAX
    package's fused kernel and its scan differ the same way)."""
    eng, jeng, rng, jrng, lwe_sk, jlwe_sk, glwe_sk, bsk, jbsk = _keys(7, primes, None)
    assert tbt.uses_fused_cmux(bsk, P_L1.glwe_dimension + 1)
    table = np.asarray([(3 * v + 1) % 4 for v in range(16)], dtype=np.uint64)
    msgs = np.arange(5) % 4
    ct = encrypt_lwe(lwe_sk, encode(torch.from_numpy(msgs), P_L1.delta), rng.fork(), P_L1.lwe_noise)
    jct = jax_encrypt_lwe(jlwe_sk, jax_encode(jnp.asarray(msgs, dtype=jnp.uint64), JP_L1.delta), jrng.fork(), JP_L1.lwe_noise)
    np.testing.assert_array_equal(u64(ct), np.asarray(jct))
    lut = tsi.generate_lut(P_L1, table, "cpu")
    want = jbt.blind_rotate(jsi.generate_lut(JP_L1, table), jct, jbsk, jeng)
    np.testing.assert_array_equal(u64(_scan_rotate(lut, ct, bsk, eng)), np.asarray(want))
    got = tbt.blind_rotate(lut, ct, bsk, eng)
    space = P_L1.message_modulus * P_L1.carry_modulus * 2
    delta = (1 << 64) // space
    np.testing.assert_array_equal(
        _decrypt(glwe_sk, got, delta, space).numpy(), _decrypt(glwe_sk, t64(np.asarray(want)), delta, space).numpy()
    )
    np.testing.assert_array_equal(_decrypt(glwe_sk, got, P_L1.delta, 16).numpy() % 4, table[msgs] % 4)


def test_fused_multibit_4p_bit_identical():
    """The fused multi-bit group steps (K4's plain version) at 4 primes,
    g = 2, with the port's keys from FheRng(51), equal the JAX package's
    XLA path bit for bit and decrypt to the LUT's values."""
    g = 2
    eng, jeng, rng, jrng, lwe_sk, jlwe_sk, glwe_sk, bsk, jbsk = _keys(51, FOLDED_PRIMES_4, g)
    assert tmb.uses_fused_group_steps(bsk, P_L1.glwe_dimension + 1)
    table = np.asarray([(v * 5 + 2) % 4 for v in range(16)], dtype=np.uint64)
    msgs = np.arange(9) % 4
    ct = encrypt_lwe(lwe_sk, encode(torch.from_numpy(msgs), P_L1.delta), rng.fork(), P_L1.lwe_noise)
    jct = jax_encrypt_lwe(jlwe_sk, jax_encode(jnp.asarray(msgs, dtype=jnp.uint64), JP_L1.delta), jrng.fork(), JP_L1.lwe_noise)
    got = tmb.multibit_blind_rotate(tsi.generate_lut(P_L1, table, "cpu"), ct, bsk, eng)
    want = jmb.multibit_blind_rotate(jsi.generate_lut(JP_L1, table), jct, jbsk, jeng)
    np.testing.assert_array_equal(u64(got), np.asarray(want))
    np.testing.assert_array_equal(_decrypt(glwe_sk, got, P_L1.delta, 16).numpy() % 4, table[msgs] % 4)
