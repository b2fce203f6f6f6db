"""tfhe_tpu_torch.rng against tfhe_tpu.rng: the same threefry2x32 stream.

* `FheRng(seed)` equals the JAX package's `FheRng(seed)` bit for bit for
  `uniform_torus`, `binary` and `tuniform(b)`, at every shape, after any
  chain of `split` and `fork`; its key words equal `jax.random.key_data`.
* `gaussian_torus` follows jax.random.normal's float64 path; torch's erfinv
  is not XLA's, so a sample may differ by one unit after rounding: the
  test holds |port - jax| <= 1 at std 2^-40 and 2^-30 of the torus.
* With no `convert`, the port's keygen(TOY_SHORTINT, seed=7), its
  encryption under FheRng(99), its PBS and the toy radix ops reproduce
  tests/golden_vectors.json's hashes (the port's int64 and int32 read as
  uint64 and uint32; the BSK's layout is the JAX package's already).
* A seeded GLWE encrypted by the JAX package expands in the port to the
  same masks. (The other samplers' draw order is held where their keys
  are: the compact-PKE keys, public key and threshold shares in
  test_torch_port_api.py, the multi-bit key in
  test_torch_port_four_prime.py.)
* Threads sharing one FheRng never draw the same subkey.
"""

import hashlib
import json
import os
import sys
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu import params as jp
from tfhe_tpu.core import seeded as jse
from tfhe_tpu.core.keys import GlweSecretKey as JaxGlweKey
from tfhe_tpu.ops.folded_ntt import get_folded_engine as jax_engine
from tfhe_tpu.rng import FheRng as JaxRng
from tfhe_tpu_torch import _u64
from tfhe_tpu_torch import params as tp
from tfhe_tpu_torch.core import seeded as tse
from tfhe_tpu_torch.core.glwe import decrypt_glwe
from tfhe_tpu_torch.core.keys import GlweSecretKey
from tfhe_tpu_torch.models import integer as tri
from tfhe_tpu_torch.models import shortint as tsi
from tfhe_tpu_torch.ops.folded_ntt import get_folded_engine
from tfhe_tpu_torch.rng import FheRng

VEC = json.load(open(os.path.join(os.path.dirname(__file__), "golden_vectors.json")))
SEEDS = [0, 7, 1234, 2**40 + 3]
SHAPES = [(), (5,), (3, 7), (2, 0)]
BOUNDS = [0, 10, 17, 61]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several test processes side by side; the port's many
    small tensor ops run fastest, and slow the other processes least, on
    one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_of(x):
    """A port tensor as numpy with the JAX dtype's bits (int64 -> uint64,
    int32 -> uint32)."""
    a = x.detach().cpu().numpy()
    if a.dtype == np.int64:
        return a.view(np.uint64)
    if a.dtype == np.int32:
        return a.view(np.uint32)
    return a


def same(jax_arr, port_tensor):
    a = np.asarray(jax_arr)
    b = np_of(port_tensor)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def sha(arr) -> str:
    """tests/test_golden_vectors.py's hash, of the JAX dtype's bits."""
    a = np_of(arr) if isinstance(arr, torch.Tensor) else np.asarray(arr)
    return hashlib.sha256(a.tobytes() + str(a.shape).encode() + str(a.dtype).encode()).hexdigest()


def draw_all(jr, tr):
    """Every sampler at every shape, in one order, from both generators."""
    for shape in SHAPES:
        same(jr.uniform_torus(shape), tr.uniform_torus(shape))
        same(jr.binary(shape), tr.binary(shape))
        for b in BOUNDS:
            same(jr.tuniform(b, shape), tr.tuniform(b, shape))


@pytest.mark.parametrize("seed", SEEDS)
def test_samplers_match_jax(seed):
    jr, tr = JaxRng(seed), FheRng(seed, "cpu")
    assert tr.key == tuple(int(w) for w in np.asarray(jax.random.key_data(jr._key)))
    draw_all(jr, tr)


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_fork_chains_match_jax(seed):
    jr, tr = JaxRng(seed), FheRng(seed, "cpu")
    jc, tc = jr.split(3), tr.split(3)
    assert len(tc) == 3
    for a, b in zip(jc, tc):
        same(a.uniform_torus((4, 3)), b.uniform_torus((4, 3)))
    # the parent goes on from keys[0]; a fork of a split child, a split of a fork
    same(jr.uniform_torus((6,)), tr.uniform_torus((6,)))
    jf, tf = jc[1].fork(), tc[1].fork()
    draw_all(jf, tf)
    jg, tg = jr.fork().split(2)[1], tr.fork().split(2)[1]
    same(jg.binary((9,)), tg.binary((9,)))
    same(jg.fork().fork().tuniform(17, (2, 5)), tg.fork().fork().tuniform(17, (2, 5)))
    same(jr.uniform_torus((1,)), tr.uniform_torus((1,)))


def test_seed_key_words():
    """jax.random.key(seed) is the int64 seed's high and low 32-bit words;
    a key given as two words is taken as is."""
    for s in [0, 1, 2**32, 2**40 + 3, 2**63 - 1, -1, -(2**63)]:
        want = tuple(int(w) for w in np.asarray(jax.random.key_data(jax.random.key(s))))
        assert FheRng(s, "cpu").key == want, s
    k = jax.random.key_data(jax.random.split(jax.random.key(5), 3)[2])
    same(JaxRng(jax.random.wrap_key_data(k)).uniform_torus((7,)), FheRng(np.asarray(k), "cpu").uniform_torus((7,)))
    with pytest.raises(OverflowError):
        FheRng(2**63, "cpu")


@pytest.mark.parametrize("std_log2", [-40, -30])
def test_gaussian_within_one(std_log2):
    jr, tr = JaxRng(99), FheRng(99, "cpu")
    std = 2.0**std_log2
    a = np.asarray(jr.gaussian_torus(std, (20000,))).view(np.int64)
    b = tr.gaussian_torus(std, (20000,)).numpy()
    assert np.abs(a - b).max() <= 1
    same(jr.noise(jp.NoiseDistribution.gaussian(std), (3,)), tr.noise(tp.NoiseDistribution.gaussian(std), (3,)))


def test_golden_rng_stream():
    rng = FheRng(1234, "cpu")
    assert [int(x) for x in np_of(rng.uniform_torus((8,)))] == VEC["rng"]["uniform_torus_8"]
    assert [int(x) for x in np_of(rng.binary((16,)))] == VEC["rng"]["binary_16"]
    assert [int(x) for x in np_of(rng.tuniform(10, (8,)))] == VEC["rng"]["tuniform10_8"]


def test_golden_toy_keys_encrypt_and_pbs():
    ck, sk = tsi.keygen(tp.TOY_SHORTINT, seed=7, device="cpu")
    assert sha(ck.lwe_key.key) == VEC["toy_keys"]["lwe_key_sha"]
    assert sha(ck.glwe_key.key) == VEC["toy_keys"]["glwe_key_sha"]
    assert sha(sk.bsk.bsk_ntt) == VEC["toy_keys"]["bsk_sha"]  # int32 read as uint32: JAX's layout
    assert sha(sk.ksk.ksk) == VEC["toy_keys"]["ksk_sha"]
    c = tsi.encrypt(ck, torch.arange(4), FheRng(99, "cpu"))
    assert sha(c.ct) == VEC["toy_encrypt"]["ct_sha"]
    assert tsi.decrypt(ck, c).tolist() == VEC["toy_encrypt"]["decrypt"]
    boot = tsi.apply_function(sk, c, lambda v: (v * 3 + 1) % 4)
    assert sha(boot.ct) == VEC["toy_pbs"]["ct_sha"]
    assert tsi.decrypt(ck, boot).tolist() == VEC["toy_pbs"]["decrypt"]


def test_golden_toy_radix_ops():
    ck, sk = tsi.keygen(tp.TOY_SHORTINT_NOISELESS, seed=8, device="cpu")
    a8 = tri.encrypt_radix(ck, torch.tensor([177, 23]), 8, FheRng(5, "cpu"))
    b8 = tri.encrypt_radix(ck, torch.tensor([99, 201]), 8, FheRng(6, "cpu"))
    assert sha(tri.add(sk, a8, b8).blocks) == VEC["toy_radix"]["add_sha"]
    assert tri.decrypt_radix(ck, tri.mul(sk, a8, b8)).tolist() == VEC["toy_radix"]["mul_decrypt"]


def test_seeded_glwe_from_jax_expands_in_port():
    """A seeded GLWE (bodies + seed) made by the JAX package expands in the
    port to the JAX package's masks and decrypts to its plaintext; the
    port's own seeded encryption gives the same bodies."""
    params = jp.TOY_SHORTINT
    n = params.polynomial_size
    key = FheRng(21, "cpu").binary((params.glwe_dimension, n))
    jkey = JaxGlweKey(key=jnp.asarray(np_of(key)))
    pt = (np.arange(2 * n, dtype=np.uint64).reshape(2, n) * np.uint64(0x9E3779B97F4A7C15))
    j_ct = jse.encrypt_glwe_seeded(jkey, jnp.asarray(pt), 77, params.glwe_noise, jax_engine(n))
    t_in = tse.SeededGlweCiphertext(bodies=_u64.u64_from_numpy(np.asarray(j_ct.bodies)), seed=77, k=jkey.k)
    expanded = tse.expand_seeded_glwe(t_in)
    same(jse.expand_seeded_glwe(j_ct), expanded)
    tkey = GlweSecretKey(key=key)
    eng = get_folded_engine(n, "cpu")
    err = decrypt_glwe(tkey, expanded, eng) - _u64.u64_from_numpy(pt)
    assert int(err.abs().max()) <= 2**params.glwe_noise.bound_log2
    mine = tse.encrypt_glwe_seeded(tkey, _u64.u64_from_numpy(pt), 77, tp.TOY_SHORTINT.glwe_noise, eng)
    same(j_ct.bodies, mine.bodies)


def test_threads_never_share_a_subkey():
    """The key step is atomic: 16 threads (more than the cores) forking one
    FheRng 50 times each, with a short switch interval, get 800 distinct
    keys, the same set as 800 forks in one thread."""
    shared = FheRng(5, "cpu")
    got = []
    lock = threading.Lock()

    def work():
        mine = [shared.fork().key for _ in range(50)]
        with lock:
            got.extend(mine)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    serial = FheRng(5, "cpu")
    assert len(set(got)) == 800
    assert set(got) == {serial.fork().key for _ in range(800)}
