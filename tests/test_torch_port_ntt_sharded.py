"""parallel/ntt_sharded of tfhe_tpu_torch against the JAX package, on the CPU.

A world of 2 ranks and one of 4 (gloo, spawned by
tfhe_tpu_torch.parallel.launch, one torch thread a rank) each run:
  * make_sharded_ntt forward and inverse of one polynomial at N = 2048
    and 4096, whose values include 0, 2^63 and 2^64 - 1 (the unsigned
    remainder path): the gathered forward equals mod p the port's
    forward_u64 (and JAX's at N = 2048: building the JAX engine at 4096
    alone takes ~9 s here), and the inverse gives back x mod each prime;
    the stage tables equal those of the JAX function, run on the port's
    engine (it reads n, and p, r_dim and c_dim of each prime's NTT);
  * make_key_sharded_blind_rotate with the port's own seed-51
    TOY_SHORTINT keys (equal to JAX's seed-51 keys carried across) on
    small-key ciphertexts JAX keyswitched: every rank's accumulator equals
    JAX's blind_rotate bit for bit and decrypts to the LUT.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu import params as jp
from tfhe_tpu.core.bootstrap import blind_rotate as jax_blind_rotate
from tfhe_tpu.core.lwe import keyswitch as jax_keyswitch
from tfhe_tpu.models import shortint as jsi
from tfhe_tpu.models.glwe_matmul import get_engine as jax_get_engine
from tfhe_tpu.parallel import ntt_sharded as jns
from tfhe_tpu.rng import FheRng as JaxRng
from tfhe_tpu_torch import _u64, convert
from tfhe_tpu_torch import params as tp
from tfhe_tpu_torch.core.lwe import decrypt_lwe, sample_extract
from tfhe_tpu_torch.models import shortint as tsi
from tfhe_tpu_torch.ops.folded_ntt import get_folded_engine
from tfhe_tpu_torch.parallel import launch
from tfhe_tpu_torch.parallel import ntt_sharded as tns
from tfhe_tpu_torch.torus import decode

SIZES = (2048, 4096)
WORLDS = (2, 4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """JAX seed-51 keys, 8 ciphertexts keyswitched to the small key, a
    LUT, JAX's blind_rotate, and one u64 polynomial per N."""
    params = jp.TOY_SHORTINT
    ck, sk = jsi.keygen(params, seed=51)
    msgs = np.asarray([1, 2, 5, 9, 0, 15, 7, 3])
    c = jsi.encrypt(ck, jnp.asarray(msgs, dtype=jnp.uint64), JaxRng(31))
    small = jax_keyswitch(c.ct, sk.ksk)
    table = np.asarray([(v * 3 + 1) % 4 for v in range(16)], dtype=np.uint64)
    lut = jsi.generate_lut(params, table)
    acc = np.asarray(jax_blind_rotate(lut, small, sk.bsk, jsi.engine_for(params)))
    gen = np.random.default_rng(5)
    xs = {}
    for n in SIZES:
        x = gen.integers(0, 2**64, n, dtype=np.uint64)
        x[:4] = [0, 2**64 - 1, 2**63, 2**63 - 1]
        xs[n] = x
    return dict(ck=ck, sk=sk, msgs=msgs, small=np.asarray(small), table=table, acc=acc, xs=xs)


@pytest.fixture(scope="module")
def worlds(ref):
    jobs = [("ntt", dict(n_poly=n, x=ref["xs"][n])) for n in SIZES]
    jobs.append(("rotate", dict(params=tp.TOY_SHORTINT, seed=51, small_cts=ref["small"], lut_table=ref["table"])))
    return {m: launch.launch(launch.run_jobs, m, (jobs,), device="cpu", timeout=300) for m in WORLDS}


def _gathered(ranks, j, key):
    ranks = sorted(ranks, key=lambda r: r[j]["coord"])
    return np.concatenate([r[j][key] for r in ranks], axis=1)


def test_port_keygen_equals_the_reference(ref):
    _, tsk = convert.keys_from_reference(ref["ck"], ref["sk"], device="cpu")
    _, sk = tsi.keygen(tp.TOY_SHORTINT, seed=51, device="cpu")
    assert torch.equal(sk.bsk.bsk_ntt, tsk.bsk.bsk_ntt) and sk.bsk.shift == tsk.bsk.shift


@pytest.mark.parametrize("n", SIZES)
def test_stage_tables_match_the_reference(n):
    eng = get_folded_engine(n, "cpu")
    got = tns._stage_tables(eng)
    want = jns._stage_tables(eng)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("m", WORLDS)
@pytest.mark.parametrize("j,n", list(enumerate(SIZES)))
def test_sharded_forward_matches_engine(ref, worlds, m, j, n):
    x = ref["xs"][n]
    got = _gathered(worlds[m], j, "f")
    eng = get_folded_engine(n, "cpu")
    port = eng.forward_u64(_u64.u64_from_numpy(x)).to(torch.int64).numpy()
    for i, p in enumerate(eng.primes):
        assert (got[i] >= 0).all() and (got[i] < p).all()
        np.testing.assert_array_equal(got[i], port[i] % p)
    if n == 2048:
        jax_f = np.asarray(jax_get_engine(n).forward_u64(jnp.asarray(x))).astype(np.int64)
        for i, p in enumerate(eng.primes):
            np.testing.assert_array_equal(got[i], jax_f[i] % p)


@pytest.mark.parametrize("m", WORLDS)
@pytest.mark.parametrize("j,n", list(enumerate(SIZES)))
def test_sharded_roundtrip(ref, worlds, m, j, n):
    x = ref["xs"][n]
    back = _gathered(worlds[m], j, "back")
    for i, p in enumerate(get_folded_engine(n, "cpu").primes):
        np.testing.assert_array_equal(back[i], (x % np.uint64(p)).astype(np.int64))


@pytest.mark.parametrize("m", WORLDS)
def test_sharded_ntt_one_reduce_scatter_per_prime_and_direction(worlds, m):
    for j, n in enumerate(SIZES):
        for r in worlds[m]:
            (s,) = r[j]["stats"]
            assert s["op"] == "reduce-scatter" and s["count"] == 2 * 3
            assert s["bytes"] == n * 8 and s["replica_groups"] == [list(range(m))]


@pytest.mark.parametrize("m", WORLDS)
def test_key_sharded_rotation_bit_exact(ref, worlds, m):
    j = len(SIZES)
    for r in worlds[m]:
        np.testing.assert_array_equal(r[j]["acc"], ref["acc"])
    stats = {s["op"]: s for s in worlds[m][0][j]["stats"]}
    assert stats["collective-permute"]["count"] == m and stats["broadcast"]["count"] == 1
    tck, _ = convert.keys_from_reference(ref["ck"], ref["sk"], device="cpu")
    out = sample_extract(_u64.u64_from_numpy(worlds[m][0][j]["acc"]), 0)
    dec = decode(decrypt_lwe(tck.big_lwe_key, out), tp.TOY_SHORTINT.delta, 16)
    np.testing.assert_array_equal(dec.numpy() % 4, ref["table"][ref["msgs"]].astype(np.int64) % 4)
