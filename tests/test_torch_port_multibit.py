"""tfhe_tpu_torch multi-bit blind rotation vs the JAX package, bit for bit.

* group_exponents and the BSK step layout equal JAX's.
* With JAX multi-bit keys carried across (convert.py; N = 256, n = 12,
  level 1 / base_log 23), the port's multibit_blind_rotate (plain K4 on the
  CPU) equals JAX's multibit_blind_rotate (its lax.scan path on the CPU)
  for g = 2, 3, 4, and once the Pallas kernel multibit_rotate_fused in
  interpret mode for g = 2.
* The kernel's Horner order (csrc/multibit.cu, replayed in numpy) equals
  the plain `_horner` mod p.
* Keys from the port's own keygen decrypt right, with the shift and msb of
  JAX's; the level-2 loop form decrypts right; keygen reads g from the
  parameter-set name.
"""

import dataclasses

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
from tfhe_tpu_torch.core import multibit as tmb
from tfhe_tpu_torch.models import shortint as tsi
from tfhe_tpu_torch.ops import multibit_cuda as mbc
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
        keys[g] = (bsk, convert.multibit_bootstrap_key_from_reference(bsk))
    msgs = jnp.arange(6, dtype=jnp.uint64)
    ct = encrypt_lwe(lwe_sk, encode(msgs, params.delta), rng, params.lwe_noise)
    lut = jsi.generate_lut(params, LUT_TABLE)
    return params, engine, keys, ct, lut


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
        convert.u64_tensor(lut), convert.u64_tensor(ct), tbsk, get_folded_engine(N, "cpu")
    )
    np.testing.assert_array_equal(_u64.u64_to_numpy(got), np.asarray(want))


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
        convert.u64_tensor(acc), a, tbsk.bsk_ntt, tbsk.rot_table, get_folded_engine(N, "cpu"),
        23, tbsk.shift, 2,
    )
    np.testing.assert_array_equal(_u64.u64_to_numpy(got), np.asarray(want))


def test_monomial_x_table_matches_reference(carried):
    _, _, keys, _, _ = carried
    got = tmb.monomial_x_table(get_folded_engine(N, "cpu"))
    assert torch.equal(got, keys[2][1].rot_table)


@pytest.mark.parametrize("g", GROUPS)
def test_kernel_horner_order_matches_plain(g):
    """csrc/multibit.cu folds x[v] += m_b * x[v + 2^b] bottom-up with
    canonical add_mod / mul_shoup; the plain `_horner` folds top-down on
    lazy residues. Both give the same value mod p."""
    te = get_folded_engine(N, "cpu")
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


@pytest.mark.parametrize("g", GROUPS)
def test_own_keygen_decrypts(carried, g):
    _, _, keys, _, _ = carried
    params = dataclasses.replace(
        tp.TOY_SHORTINT, name="MB_TEST", lwe_dimension=N_LWE, polynomial_size=N,
        pbs=tp.GadgetParams(base_log=23, level=1),
    )
    ck, sk = tsi.keygen(params, seed=20 + g, multibit_group=g, device="cpu")
    assert isinstance(sk.bsk, tmb.MultiBitBootstrapKey) and sk.bsk.group_size == g
    engine = get_folded_engine(N, "cpu")
    assert sk.bsk.shift == keys[g][0].shift == 64 - tmb.multibit_msb(params.pbs, g, engine)
    vals = torch.tensor([0, 1, 2, 3, 2, 1])
    c = tsi.encrypt(ck, vals, FheRng(30 + g))
    out = tsi.apply_function(sk, c, lambda v: (3 * v + 1) % 4)
    assert torch.equal(tsi.decrypt(ck, out), (3 * vals + 1) % 4)


def test_loop_form_decrypts():
    """Level-2 gadget (TOY_SHORTINT): the aggregate-then-external-product loop."""
    ck, sk = tsi.keygen(tp.TOY_SHORTINT, seed=9, multibit_group=2, device="cpu")
    assert not tmb.uses_fused_group_steps(sk.bsk, 2)
    vals = torch.tensor([0, 1, 2, 3])
    out = tsi.apply_function(sk, tsi.encrypt(ck, vals, FheRng(10)), lambda v: (v * v) % 4)
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
    te = get_folded_engine(N, "cpu")
    acc = torch.zeros(2, 2, N, dtype=torch.int64)
    table = torch.zeros(2 * N, 3, 2, N, dtype=torch.int32)
    bsk = torch.zeros(1, 8, 2, 2, 3, 2, N, dtype=torch.int32)
    with pytest.raises(ValueError, match="group size"):
        mbc.group_steps(acc, torch.zeros(5, 2, dtype=torch.int32), bsk, table, te, 23, 10, 5)
    with pytest.raises(ValueError, match="bsk_ntt"):
        mbc.group_steps(acc, torch.zeros(3, 2, dtype=torch.int32), bsk[:, :4], table, te, 23, 10, 3)
    with pytest.raises(ValueError, match="a must be"):
        mbc.group_steps(acc, torch.zeros(4, 2, dtype=torch.int32), bsk, table, te, 23, 10, 3)
