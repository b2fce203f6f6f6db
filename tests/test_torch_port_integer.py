"""The radix integer layer of tfhe_tpu_torch against tfhe_tpu.models.integer.

* With a multi-bit g = 2 key carried from JAX (the TOY_MB_RADIX set of
  tests/test_multibit.py) and the same input ciphertexts, each listed op
  gives the same ciphertext bits, the same degree tuples and the same PBS
  count at 8 bits (JAX's `_pbs` rows counted through monkeypatch, the
  port's by its own `_pbs.rows`); a 16-bit ERC20 transfer counts the same
  PBS in both packages.
* With the port's own keys: encrypted shifts, div_rem, min/max, the scalar
  variants, the bigint forms and one classic-key add match clear math.
* add_sub_many (one carry chain for the adds and subs of one width) and
  add_sub give the bits and degrees of separate add and sub calls, on
  TOY_SHORTINT, sharing a chain only where the ops' carry steps agree.
* PbsDispatcher groups, pads and scatters, and with the port's PBS as
  run_batch its results decrypt right.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu import params as jp
from tfhe_tpu.models import integer as ri
from tfhe_tpu.models import shortint as jsi
from tfhe_tpu.rng import FheRng as JaxRng
from tfhe_tpu_torch import _u64, convert
from tfhe_tpu_torch import params as tp
from tfhe_tpu_torch.core.lwe import keyswitch
from tfhe_tpu_torch.core.multibit import MultiBitBootstrapKey, multibit_programmable_bootstrap
from tfhe_tpu_torch.models import integer as ti
from tfhe_tpu_torch.models import shortint as tsi
from tfhe_tpu_torch.parallel.dispatch import PbsDispatcher
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


U64 = jnp.uint64
BITS = 8
A_VALS = [177, 23]
B_VALS = [99, 201]


def _jax_params():
    return dataclasses.replace(
        jp.TOY_SHORTINT_CORPUS, name="TOY_MB_RADIX", pbs=jp.GadgetParams(base_log=23, level=1)
    )


def _port_params():
    return dataclasses.replace(
        tp.TOY_SHORTINT_CORPUS, name="TOY_MB_RADIX", pbs=tp.GadgetParams(base_log=23, level=1)
    )


@pytest.fixture(scope="module")
def carried():
    params = _jax_params()
    ck, sk = jsi.keygen(params, seed=3, multibit_group=2)
    tck, tsk = convert.keys_from_reference(ck, sk, device="cpu")
    assert isinstance(tsk.bsk, MultiBitBootstrapKey) and tsk.bsk.group_size == 2
    a = ri.encrypt_radix(ck, jnp.asarray(A_VALS, dtype=U64), BITS, JaxRng(5))
    b = ri.encrypt_radix(ck, jnp.asarray(B_VALS, dtype=U64), BITS, JaxRng(6))
    return params, ck, sk, tck, tsk, a, b


def _to_port(c, tparams):
    if isinstance(c, ri.RadixCiphertext):
        return ti.RadixCiphertext(blocks=convert.u64_tensor(c.blocks), params=tparams, degrees=c.degrees)
    return tsi.Ciphertext(ct=convert.u64_tensor(c.ct), params=tparams, degree=c.degree, noise_level=c.noise_level)


def _parts(c):
    """(u64 bits, degrees) of a radix or shortint result of either package."""
    if isinstance(c, (ri.RadixCiphertext, ti.RadixCiphertext)):
        bits, degrees = c.blocks, c.degrees
    else:
        bits, degrees = c.ct, c.degree
    bits = _u64.u64_to_numpy(bits) if isinstance(bits, torch.Tensor) else np.asarray(bits)
    return bits, degrees


# op name -> f(module, sk, a, b, cond, zero); cond is lt(a, b) made by JAX and
# carried across, zero a trivial zero of the module's own trivial_radix
OPS = {
    "add": lambda m, sk, a, b, c, z: m.add(sk, a, b),
    "sub": lambda m, sk, a, b, c, z: m.sub(sk, a, b),
    "add_sub": lambda m, sk, a, b, c, z: m.add_sub(sk, a, b),
    "mul": lambda m, sk, a, b, c, z: m.mul(sk, a, b),
    "bitxor": lambda m, sk, a, b, c, z: m.bitxor(sk, a, b),
    "eq": lambda m, sk, a, b, c, z: m.eq(sk, a, b),
    "lt": lambda m, sk, a, b, c, z: m.lt(sk, a, b),
    "le": lambda m, sk, a, b, c, z: m.le(sk, a, b),
    "select": lambda m, sk, a, b, c, z: m.select(sk, c, a, b),
    "select_trivial_zero": lambda m, sk, a, b, c, z: m.select(sk, c, a, z),
    "shl": lambda m, sk, a, b, c, z: m.shl(sk, a, 3),
    "rotr": lambda m, sk, a, b, c, z: m.rotr(sk, a, 5),
    "cast": lambda m, sk, a, b, c, z: m.cast(sk, m.add(sk, a, b), 16),
}


def _count_jax_pbs(monkeypatch):
    count = [0]
    orig = ri._pbs

    def counted(sk, ct, lut):
        count[0] += int(np.prod(ct.shape[:-1]))
        return orig(sk, ct, lut)

    monkeypatch.setattr(ri, "_pbs", counted)
    return count


@pytest.mark.parametrize("op", sorted(OPS))
def test_op_matches_reference(carried, monkeypatch, op):
    params, ck, sk, tck, tsk, a, b = carried
    cond = ri.lt(sk, a, b)
    count = _count_jax_pbs(monkeypatch)
    jzero = ri.trivial_radix(params, jnp.zeros((2,), dtype=U64), BITS)
    want = OPS[op](ri, sk, a, b, cond, jzero)
    tzero = ti.trivial_radix(tck.params, np.zeros(2, dtype=np.uint64), BITS, device="cpu")
    assert tzero.degrees == jzero.degrees == (0,) * 4
    ti._pbs.rows = 0
    got = OPS[op](ti, tsk, _to_port(a, tck.params), _to_port(b, tck.params), _to_port(cond, tck.params), tzero)
    assert ti._pbs.rows == count[0]
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    for w, g in zip(want, got):
        w_bits, w_deg = _parts(w)
        g_bits, g_deg = _parts(g)
        assert g_deg == w_deg
        np.testing.assert_array_equal(g_bits, w_bits)


def _erc20(m, sk, balance, amount, zero):
    """scripts/bench_erc20.py's transfer: le, select vs a trivial zero, add_sub."""
    can_pay = m.le(sk, amount, balance)
    moved = m.select(sk, can_pay, amount, zero)
    new_to, new_from = m.add_sub(sk, balance, moved)
    return new_from, new_to


def test_erc20_transfer_counts_match_reference(carried, monkeypatch):
    params, ck, sk, tck, tsk, _, _ = carried
    bal = np.array([40000, 7], dtype=np.uint64)
    amt = np.array([1234, 9], dtype=np.uint64)
    e_bal = ri.encrypt_radix(ck, jnp.asarray(bal), 16, JaxRng(7))
    e_amt = ri.encrypt_radix(ck, jnp.asarray(amt), 16, JaxRng(8))
    count = _count_jax_pbs(monkeypatch)
    jf, jt = _erc20(ri, sk, e_bal, e_amt, ri.trivial_radix(params, jnp.zeros((2,), dtype=U64), 16))
    ti._pbs.rows = 0
    zero = ti.trivial_radix(tck.params, np.zeros(2, dtype=np.uint64), 16, device="cpu")
    tf, tt = _erc20(ti, tsk, _to_port(e_bal, tck.params), _to_port(e_amt, tck.params), zero)
    # per transfer: le 8 + 7 + 1, select 8, add_sub 2 x (7 x 2 + 1)
    assert ti._pbs.rows == count[0] == len(bal) * 54
    moved = np.where(amt <= bal, amt, 0)
    np.testing.assert_array_equal(_u64.u64_to_numpy(ti.decrypt_radix(tck, tf)), bal - moved)
    np.testing.assert_array_equal(_u64.u64_to_numpy(ti.decrypt_radix(tck, tt)), bal + moved)
    np.testing.assert_array_equal(_u64.u64_to_numpy(tf.blocks), np.asarray(jf.blocks))


# -- the port's own keys ---------------------------------------------------------


@pytest.fixture(scope="module")
def own():
    params = _port_params()
    ck, sk = tsi.keygen(params, seed=11, multibit_group=2, device="cpu")
    return params, ck, sk


def _enc(ck, vals, nbits, seed):
    return ti.encrypt_radix(ck, np.asarray(vals, dtype=np.uint64), nbits, FheRng(seed, device="cpu"))


def _dec(ck, c):
    return _u64.u64_to_numpy(ti.decrypt_radix(ck, c)).tolist()


@pytest.mark.parametrize("kind", ["shl", "shr", "rotl", "rotr"])
def test_encrypted_shifts_match_clear(own, kind):
    params, ck, sk = own
    vals, amts = [0b10110101, 0b01100011], [3, 6]
    out = getattr(ti, f"{kind}_enc")(sk, _enc(ck, vals, 8, 1), _enc(ck, amts, 8, 2))
    mask = 0xFF
    clear = {
        "shl": lambda v, r: (v << r) & mask,
        "shr": lambda v, r: v >> r,
        "rotl": lambda v, r: ((v << r) | (v >> (8 - r))) & mask,
        "rotr": lambda v, r: ((v >> r) | (v << (8 - r))) & mask,
    }[kind]
    assert _dec(ck, out) == [clear(v, r) for v, r in zip(vals, amts)]


@pytest.mark.parametrize("nbits,vals,divs", [(4, [13, 6], [3, 0]), (6, [61], [7])])
def test_div_rem_matches_clear(own, nbits, vals, divs):
    params, ck, sk = own
    q, r = ti.div_rem(sk, _enc(ck, vals, nbits, 3), _enc(ck, divs, nbits, 4))
    ones = (1 << nbits) - 1
    assert _dec(ck, q) == [v // d if d else ones for v, d in zip(vals, divs)]
    assert _dec(ck, r) == [v % d if d else v for v, d in zip(vals, divs)]


def test_min_max_match_clear(own):
    params, ck, sk = own
    a_vals, b_vals = [5, 200, 77], [9, 3, 77]
    a, b = _enc(ck, a_vals, 8, 5), _enc(ck, b_vals, 8, 6)
    assert _dec(ck, ti.min_(sk, a, b)) == [min(x, y) for x, y in zip(a_vals, b_vals)]
    assert _dec(ck, ti.max_(sk, a, b)) == [max(x, y) for x, y in zip(a_vals, b_vals)]


SCALAR = 6
SCALAR_OPS = {
    "scalar_add": lambda v: (v + SCALAR) & 0xF,
    "scalar_sub": lambda v: (v - SCALAR) & 0xF,
    "scalar_mul": lambda v: (v * SCALAR) & 0xF,
    "scalar_bitand": lambda v: v & SCALAR,
    "scalar_bitor": lambda v: v | SCALAR,
    "scalar_bitxor": lambda v: v ^ SCALAR,
    "scalar_eq": lambda v: int(v == SCALAR),
    "scalar_ne": lambda v: int(v != SCALAR),
    "scalar_lt": lambda v: int(v < SCALAR),
    "scalar_le": lambda v: int(v <= SCALAR),
    "scalar_gt": lambda v: int(v > SCALAR),
    "scalar_ge": lambda v: int(v >= SCALAR),
    "scalar_min": lambda v: min(v, SCALAR),
    "scalar_max": lambda v: max(v, SCALAR),
    "scalar_div": lambda v: v // SCALAR,
    "scalar_rem": lambda v: v % SCALAR,
}


@pytest.mark.parametrize("op", sorted(SCALAR_OPS))
def test_scalar_ops_match_clear(own, op):
    params, ck, sk = own
    vals = [3, 6, 13]
    out = getattr(ti, op)(sk, _enc(ck, vals, 4, 7), SCALAR)
    if isinstance(out, tsi.Ciphertext):
        got = tsi.decrypt(ck, out).tolist()
    else:
        got = _dec(ck, out)
    assert got == [SCALAR_OPS[op](v) for v in vals]


def test_bigint_forms_and_neg(own):
    params, ck, sk = own
    big = [(1 << 127) + 12345, 3]
    c = ti.encrypt_radix_bigint(ck, big, 128, FheRng(9, device="cpu"))
    assert c.nblocks == 64 and ti.decrypt_radix_bigint(ck, c) == big
    t = ti.trivial_radix_bigint(params, big, 128, device="cpu")
    assert ti.decrypt_radix_bigint(ck, t) == big
    assert _dec(ck, ti.neg(sk, _enc(ck, [5, 0], 4, 10))) == [11, 0]
    assert ti.trivial_radix(params, [0x31], 8, device="cpu").degrees == (1, 0, 3, 0)


def test_classic_key_add_matches_clear():
    params = dataclasses.replace(_port_params(), name="TOY_CLASSIC_RADIX")
    ck, sk = tsi.keygen(params, seed=12, device="cpu")
    assert not isinstance(sk.bsk, MultiBitBootstrapKey)
    out = ti.add(sk, _enc(ck, [250, 17], 8, 11), _enc(ck, [9, 100], 8, 12))
    assert _dec(ck, out) == [3, 117]


# -- add_sub_many: the adds and subs of one width in one carry chain -------------------

# the 4-bit (two-block) operands at TOY_SHORTINT: name -> clear values, and
# a trivial radix for s9 and s4 as the instance lifts a scalar
CHAIN_VALUES = {"a": 11, "b": 6, "A": [3, 15, 8], "B": [9, 15, 0], "s9": 9, "s4": 4}

# case -> (ops, shared chains, radix ciphertexts in them, _stacked_pbs calls).
# Fresh operands give add's pre-carry degrees (6, 6) and sub's (7, 6): both
# flush each block and carry 1 from block 0, so they share a chain; s9's
# degrees (1, 2) leave add's steps the same; s4's (0, 1) leave add's block 0
# unflushed, so that add runs in a chain of its own.
CHAIN_CASES = {
    "add_only": ([("add", "a", "b"), ("add", "A", "B")], 1, 4, 2),
    "sub_only": ([("sub", "A", "B"), ("sub", "a", "b")], 1, 4, 2),
    "mixed": ([("add", "a", "b"), ("sub", "A", "B"), ("sub", "a", "b"), ("add", "A", "B")], 1, 8, 2),
    "scalar_rhs": ([("add", "a", "s9"), ("sub", "A", "s9")], 1, 4, 2),
    "single": ([("sub", "A", "B")], 0, 0, 2),
    "steps_differ": ([("add", "a", "s4"), ("sub", "a", "b")], 0, 0, 3),
    "add_sub": ([("add", "A", "B"), ("sub", "A", "B")], 1, 6, 2),  # through ti.add_sub
}


@pytest.fixture(scope="module")
def toy():
    """TOY_SHORTINT keys, the 4-bit operands, and a cache of the separate
    add/sub results the cases share."""
    ck, sk = tsi.keygen(tp.TOY_SHORTINT, seed=13, device="cpu")
    cts = {name: _enc(ck, v, 4, 21 + i) for i, (name, v) in enumerate(CHAIN_VALUES.items()) if name[0] != "s"}
    for name in ("s9", "s4"):
        cts[name] = ti.trivial_radix(sk.params, np.uint64(CHAIN_VALUES[name]), 4, device="cpu")
    return ck, sk, cts, {}


@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_add_sub_many_equals_separate_ops(toy, monkeypatch, case):
    """add_sub_many (and add_sub) give each op the ciphertext bits and
    degrees of a separate integer.add / integer.sub, in one chain where
    the ops' carry steps agree and in chains of their own where not."""
    ck, sk, cts, separate = toy
    ops, chains, rows, calls = CHAIN_CASES[case]
    args = [(kind, cts[x], cts[y]) for kind, x, y in ops]
    n_calls = [0]
    stacked = ti._stacked_pbs

    def counted(*a):
        n_calls[0] += 1
        return stacked(*a)

    monkeypatch.setattr(ti, "_stacked_pbs", counted)
    before = (ti.add_sub_many.chains, ti.add_sub_many.ops)
    got = ti.add_sub(sk, cts["A"], cts["B"]) if case == "add_sub" else ti.add_sub_many(sk, args)
    assert n_calls[0] == calls
    assert (ti.add_sub_many.chains - before[0], ti.add_sub_many.ops - before[1]) == (chains, rows)
    monkeypatch.undo()
    for (kind, x, y), (_, ca, cb), g in zip(ops, args, got):
        if (kind, x, y) not in separate:
            separate[kind, x, y] = getattr(ti, kind)(sk, ca, cb)
        want = separate[kind, x, y]
        assert g.degrees == want.degrees
        assert torch.equal(g.blocks, want.blocks)
        clear = np.asarray(CHAIN_VALUES[x]) + (1 if kind == "add" else -1) * np.asarray(CHAIN_VALUES[y])
        assert _dec(ck, g) == (clear % 16).tolist()


def test_dispatcher_pads_and_routes(own):
    params, ck, sk = own
    engine = tsi.engine_for(params, "cpu")
    ident = np.arange(16, dtype=np.uint64)
    double = (np.arange(16, dtype=np.uint64) * 2) % 16

    def run_batch(cts, lut_table):
        lut = tsi.generate_lut(params, lut_table, device="cpu")
        return multibit_programmable_bootstrap(keyswitch(cts, sk.ksk), lut, sk.bsk, engine)

    d = PbsDispatcher(run_batch, bucket_sizes=(4, 16))
    rng = FheRng(13, device="cpu")
    tickets = []
    for i, v in enumerate([0, 1, 2, 3, 7]):
        c = tsi.encrypt(ck, torch.tensor(v), rng)
        table = ident if i % 2 == 0 else double
        tickets.append((d.submit(c.ct, table), v, i % 2 == 0))
    for t, v, is_ident in tickets:
        out = tsi.Ciphertext(ct=d.result(t), params=params, degree=15, noise_level=1)
        assert int(tsi.decrypt(ck, out)) == (v if is_ident else (2 * v) % 16)
    assert d.stats["batches"] == 2  # one per distinct LUT
    assert d.stats["padded"] > 0  # buckets padded
    assert d.stats["submitted"] == d.stats["executed"] == 5
