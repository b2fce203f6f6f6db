"""The port's FhevmInstance and FheServer against the JAX package, on the CPU.

One JAX instance at TOY_SHORTINT (seed 19); the port's instance runs on the
same keys, carried across by patching the port's `keycache.load_or_keygen`
with `convert.keys_from_reference`, and on the same input ciphertexts
(encrypted under the JAX client key, registered in both stores):
* one fhe_op of each family (binary, scalar binary, compare, shift,
  select, cast, div, ebool) and one mixed fhe_op_many batch give
  ciphertexts bit-identical to the JAX instance's, with equal degrees and
  equal result handles;
* the port's FheServer answers the JAX package's own FheClient: /health,
  /publickey, a full /input-proof submission (a JAX-serialized list and a
  proof that the JAX verifier accepts), a batched /evaluate, a verified
  /public-decrypt, the full /user-decrypt protocol and the API-key check;
* an ERC20 /evaluate list at 1 and 3 transfers gives the reply and the
  stored ciphertexts of the unfused waves (a second port instance from
  the same seed, bucket by bucket) bit for bit, with the wave's sub and
  add in one carry chain;
* the port's spans (`utils/profiling`): off with no profiler session (no
  range entered, SPANS unchanged), their nesting and self-time arithmetic
  under one, one /evaluate's spans on the handler thread sharing a request
  id in `device_trace`'s Chrome trace, and the LUT upload counter.
"""

import json
import threading
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu import params as jp
from tfhe_tpu.api import compact_pke as jcp
from tfhe_tpu.api import handles as jhd
from tfhe_tpu.api import types as jty
from tfhe_tpu.api import secp256k1 as jec
from tfhe_tpu.api import zkpok as jzk
from tfhe_tpu.api.client import FheClient, FheClientUnauthorizedError
from tfhe_tpu.api.instance import create_instance as jax_create_instance
from tfhe_tpu.models import integer as jri
from tfhe_tpu.models import shortint as jsi
from tfhe_tpu.rng import FheRng as JaxRng
from tfhe_tpu.utils import serialization as jser
from tfhe_tpu_torch import _u64, convert
from tfhe_tpu_torch import params as tp
from tfhe_tpu_torch.api import compact_pke as tcp
from tfhe_tpu_torch.api import types as tty
from tfhe_tpu_torch.api import zkpok as tzk
from tfhe_tpu_torch.api.client import FheClient as PortClient
from tfhe_tpu_torch.api.handles import FhevmHandle
from tfhe_tpu_torch.api.instance import create_instance
from tfhe_tpu_torch.api.serve import FheServer
from tfhe_tpu_torch.models import integer as tri
from tfhe_tpu_torch.models import shortint as tsi
from tfhe_tpu_torch.rng import FheRng
from tfhe_tpu_torch.utils import keycache, profiling
from tfhe_tpu_torch.utils.profiling import SPANS, span

C, U = "0x" + "11" * 20, "0x" + "22" * 20
A, B = 177, 23


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several test processes side by side; the port's many
    small tensor ops run fastest, and slow the other processes least, on
    one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_port(t, ct):
    if isinstance(ct, jri.RadixCiphertext):
        return tty.FHE_TYPES[t.name], tri.RadixCiphertext(
            blocks=convert.u64_tensor(ct.blocks), params=tp.TOY_SHORTINT, degrees=ct.degrees
        )
    return tty.FHE_TYPES[t.name], tsi.Ciphertext(
        ct=convert.u64_tensor(ct.ct), params=tp.TOY_SHORTINT, degree=ct.degree, noise_level=ct.noise_level
    )


def _port_instance(jinst):
    """A port instance at TOY_SHORTINT, seed 19, on the JAX instance's keys."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(
            keycache,
            "load_or_keygen",
            lambda params, seed=0, device=None, **kw: (*convert.keys_from_reference(jinst._ck, jinst._sk, device=device), {}),
        )
        return create_instance(tp.TOY_SHORTINT, seed=19, device="cpu")


@pytest.fixture(scope="module")
def pair():
    """(JAX instance, port instance on its keys, input handles a, b: euint8,
    t, f: ebool). The inputs are encrypted under the JAX client key and
    registered in both stores, as a verified input is, under input handles
    derived from their serialized blobs."""
    jinst = jax_create_instance(jp.TOY_SHORTINT, seed=19)
    tinst = _port_instance(jinst)
    ints = jri.encrypt_radix(jinst._ck, jnp.asarray([A, B], dtype=jnp.uint64), 8, JaxRng(5))
    bools = jsi.encrypt(jinst._ck, jnp.asarray([1, 0], dtype=jnp.uint64), JaxRng(6))
    cts = [("euint8", jri.RadixCiphertext(blocks=ints.blocks[i], params=jp.TOY_SHORTINT, degrees=ints.degrees))
           for i in range(2)]
    cts += [("ebool", jsi.Ciphertext(ct=bools.ct[i], params=jp.TOY_SHORTINT, degree=1, noise_level=1))
            for i in range(2)]
    handles = []
    for idx, (tname, ct) in enumerate(cts):
        t = jty.FHE_TYPES[tname]
        h = jhd.FhevmHandle.from_ciphertext_blob(jser.serialize(ct), idx, t.type_id, jinst.chain_id).to_bytes32()
        jinst._store[h] = (t, ct)
        tinst._store[h] = _to_port(t, ct)
        for inst in (jinst, tinst):
            inst._provenance[h] = "input"
            for acct in (C, U):
                inst.acl.allow(h, acct)
        handles.append(h)
    return jinst, tinst, handles


def _same_ciphertext(jct, tct):
    if isinstance(jct, jri.RadixCiphertext):
        assert isinstance(tct, tri.RadixCiphertext) and tct.degrees == jct.degrees
        np.testing.assert_array_equal(_u64.u64_to_numpy(tct.blocks), np.asarray(jct.blocks))
    else:
        assert isinstance(tct, tsi.Ciphertext)
        assert (tct.degree, tct.noise_level) == (jct.degree, jct.noise_level)
        np.testing.assert_array_equal(_u64.u64_to_numpy(tct.ct), np.asarray(jct.ct))


# (op, args by input name or literal, clear result)
FAMILIES = {
    "binary": ("add", ("a", "b"), (A + B) % 256),
    "binary_scalar": ("sub", ("a", 200), (A - 200) % 256),
    "compare": ("lt", ("a", "b"), int(A < B)),
    "shift": ("shl", ("a", 3), (A << 3) % 256),
    "select": ("select", ("f", "a", "b"), B),
    "cast": ("cast", ("a", "euint16"), A),
    "div": ("div", ("a", 7), A // 7),
    "ebool": ("or", ("t", "f"), 1),
    "ebool_not": ("not", ("t",), 0),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_fhe_op_matches_reference(pair, family):
    jinst, tinst, (ha, hb, ht, hf) = pair
    names = {"a": ha, "b": hb, "t": ht, "f": hf}
    op, args, want = FAMILIES[family]
    args = [names.get(x, x) if isinstance(x, str) else x for x in args]
    jh = jinst.fhe_op(op, *args)
    th = tinst.fhe_op(op, *args)
    assert th == jh
    _same_ciphertext(jinst._store[jh][1], tinst._store[th][1])
    assert tinst._store[th][0].name == jinst._store[jh][0].name
    tinst.acl.allow_for_decryption(th)
    assert tinst.public_decrypt([th])["0x" + th.hex()] == want


def test_fhe_op_many_mixed_batch_matches_reference(pair):
    """One batched program over a handle rhs and a scalar rhs."""
    jinst, tinst, (ha, hb, _, _) = pair
    pairs = [(ha, hb), (hb, 9), (ha, 250)]
    assert len({tinst.batch_key("add", list(p)) for p in pairs}) == 1
    jhs = jinst.fhe_op_many("add", pairs)
    ths = tinst.fhe_op_many("add", pairs)
    assert ths == jhs
    for jh, th in zip(jhs, ths):
        _same_ciphertext(jinst._store[jh][1], tinst._store[th][1])
    for th in ths:
        tinst.acl.allow_for_decryption(th)
    got = tinst.public_decrypt(ths)
    assert [got["0x" + h.hex()] for h in ths] == [(A + B) % 256, B + 9, (A + 250) % 256]


# -- the port's server, the JAX package's client -------------------------------


@pytest.fixture(scope="module")
def server(pair):
    srv = FheServer(pair[1]).start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def client(server):
    return FheClient(f"http://127.0.0.1:{server.port}", timeout=120.0)


def test_health_and_publickey(client, pair):
    assert client.health()["status"] == "ok"
    r = client.get_public_key()
    assert r["paramsHash"] == tp.TOY_SHORTINT.hash == jp.TOY_SHORTINT.hash
    pk = jser.deserialize(bytes.fromhex(r["publicKey"]))  # the reference reads the port's blob
    np.testing.assert_array_equal(np.asarray(pk.zeros), _u64.u64_to_numpy(pair[1].public_key.zeros))


def _submit(client, inst, values, contract=C, user=U):
    """A client-side euint8 input: the port encrypts under the server's PKE
    key and proves, the JAX package serializes the list; then one
    /input-proof request through the JAX client."""
    blocks = [(v >> (2 * i)) & 3 for v in values for i in range(4)]
    lst, r, e = tcp.compact_pke_encrypt_with_witness(inst.pke_keys, blocks, FheRng(77, device="cpu"))
    proof = tzk.prove(inst.crs, inst.pke_keys.pke_pk, lst, r, np.asarray(blocks, dtype=np.uint64), e,
                      inst.input_aux_data(contract, user), seed=3)
    jlst = jcp.CompactCiphertextList(glwes=jnp.asarray(_u64.u64_to_numpy(lst.glwes)), params=jcp.TOY_PKE,
                                     n_values=lst.n_values)
    jcrs = jzk.CompactPkeCrs.from_params(jcp.TOY_PKE, jp.TOY_SHORTINT)
    jzk.verify(jcrs, _u64.u64_to_numpy(inst.pke_keys.pke_pk), jlst, jzk.CompactPkeProof.from_bytes(proof.to_bytes()),
               inst.input_aux_data(contract, user))
    return client._post("/input-proof", {
        "ciphertext": jser.serialize(jlst).hex(),
        "zkProof": proof.to_bytes().hex(),
        "types": ["euint8"] * len(values),
        "contract": contract,
        "user": user,
    })


def test_input_evaluate_and_decrypt_round_trip(client, pair):
    """input -> batched evaluate -> verified public decrypt -> user decrypt,
    every request from the JAX client."""
    inst = pair[1]
    bal, amt = [200, 17, 90], [50, 30, 90]
    rb = _submit(client, inst, bal)
    ra = _submit(client, inst, amt)
    assert len(rb["handles"]) == 3 and rb["threshold"] == 3 and len(rb["signatures"]) == 4
    assert client._post("/verify", {"handles": rb["handles"], "inputProof": rb["inputProof"],
                                    "user": U, "contract": C})["valid"]
    ops = []
    for hb, ha in zip(rb["handles"], ra["handles"]):
        ops += [("le", [ha, hb]), ("sub", [hb, ha]), ("add", [hb, ha])]
    r = client.evaluate_many(ops)
    assert r["batchedGroups"] == 3 and r["singleOps"] == 0
    for h in r["handles"]:
        client.allow(h)
    vals = client.public_decrypt_verified(r["handles"])["values"]
    want = []
    for b, a in zip(bal, amt):
        want += [int(a <= b), (b - a) % 256, (b + a) % 256]
    assert [int(vals[h]) for h in r["handles"]] == want
    priv = jec.keygen(b"serve-user")
    user = jec.address(priv)
    for h in r["handles"][1::3]:
        client.allow(h, account=user, for_decryption=False)
        client.allow(h, account=C, for_decryption=False)
    got = client.user_decrypt([(h, C) for h in r["handles"][1::3]], priv)
    assert got == want[1::3]


@pytest.fixture(scope="module")
def erc20(pair):
    """euint8 balances and amounts, and the zero as the benchmark makes it
    (xor of an amount with itself), in the store of the served instance and
    of a second port instance from the same seed, which runs the unfused
    waves."""
    jinst, tinst, _ = pair
    unfused = _port_instance(jinst)
    bal = tri.encrypt_radix(tinst._ck, np.array(ERC20_BAL, dtype=np.uint64), 8, FheRng(31, device="cpu"))
    amt = tri.encrypt_radix(tinst._ck, np.array(ERC20_AMT, dtype=np.uint64), 8, FheRng(32, device="cpu"))
    handles = []
    for i, blocks in enumerate([*bal.blocks, *amt.blocks]):
        h = bytes([0xE0 + i]) * 32
        entry = (tty.FHE_TYPES["euint8"], tri.RadixCiphertext(blocks=blocks, params=tp.TOY_SHORTINT, degrees=bal.degrees))
        tinst._store[h] = unfused._store[h] = entry
        handles.append(h)
    zero = tinst.fhe_op("xor", handles[8], handles[8])
    unfused._store[zero] = tinst._store[zero]
    return unfused, handles[:8], handles[8:], zero


# balances and amounts: the one-transfer list pays from account 0 to 4 with
# amount 0, the three-transfer list from 1..3 to 5..7 with amounts 1..3, so
# the two lists share no operand and no result (two overdraws, one wrap)
ERC20_BAL = [200, 17, 90, 9, 130, 61, 44, 250]
ERC20_AMT = [50, 30, 60, 7]


def _erc20_transfers(n):
    """(payer, payee, amount) indices of the list of n transfers."""
    first = 0 if n == 1 else 1
    return [(first + k, first + 4 + k, first + k) for k in range(n)]


def _erc20_ops(inst, bal, amt, zero, transfers):
    """benchmark/generators/erc20_closed_loop.py's list: per transfer le,
    select against the zero, sub from the payer, add to the payee."""
    ops = []
    for i, j, k in _erc20_transfers(transfers):
        f, t, a = bal[i], bal[j], amt[k]
        cond = FhevmHandle.from_op("le", [a, f], inst.chain_id, tty.FHE_TYPES["ebool"].type_id).to_bytes32()
        moved = FhevmHandle.from_op("select", [cond, a, zero], inst.chain_id, tty.FHE_TYPES["euint8"].type_id).to_bytes32()
        ops += [("le", [a, f]), ("select", [cond, a, zero]), ("sub", [f, moved]), ("add", [t, moved])]
    return ops


def _unfused_evaluate(inst, op_cost, ops):
    """/evaluate's waves with no shared carry chain: each wave's batch_key
    buckets one after another, through fhe_op_many, a lone op through
    fhe_op; the reply counted per bucket."""
    out, cost, groups, singles = [None] * len(ops), 0, 0, 0
    while None in out:
        buckets = {}
        for i, (op, args) in enumerate(ops):
            if out[i] is None and all(not isinstance(x, bytes) or x in inst._store for x in args):
                buckets.setdefault(inst.batch_key(op, args), []).append(i)
        for key, idxs in buckets.items():
            if key is not None and len(idxs) > 1:
                hs = inst.fhe_op_many(key[0], [tuple(ops[i][1]) for i in idxs])
                groups += 1
            else:
                hs = [inst.fhe_op(ops[i][0], *ops[i][1]) for i in idxs]
                singles += len(idxs)
            for i, h in zip(idxs, hs):
                out[i] = h
                cost += op_cost(*ops[i])
    return {"handles": ["0x" + h.hex() for h in out], "gasUsed": cost, "batchedGroups": groups, "singleOps": singles}


@pytest.mark.parametrize("transfers", [1, 3])
def test_evaluate_runs_a_waves_add_and_sub_in_one_chain(client, server, pair, erc20, monkeypatch, transfers):
    """An ERC20 /evaluate list gives the reply and the stored ciphertexts of
    the unfused waves bit for bit, with one carry chain fewer: the wave's
    sub and add share one."""
    tinst = pair[1]
    unfused, bal, amt, zero = erc20
    ops = _erc20_ops(tinst, bal, amt, zero, transfers)
    calls = [0]
    stacked = tri._stacked_pbs

    def counted(*a):
        calls[0] += 1
        return stacked(*a)

    monkeypatch.setattr(tri, "_stacked_pbs", counted)
    before = (tri.add_sub_many.chains, tri.add_sub_many.ops)
    got = client.evaluate_many([(op, ["0x" + x.hex() for x in args]) for op, args in ops])
    fused_calls, calls[0] = calls[0], 0
    assert (tri.add_sub_many.chains - before[0], tri.add_sub_many.ops - before[1]) == (1, 2 * transfers)
    # the gas of an op reads its operands' types from the served store
    want = _unfused_evaluate(unfused, server._op_cost, ops)
    assert fused_calls == calls[0] - 4  # one euint8 carry chain: 4 blocks
    assert {k: got[k] for k in want} == want
    for h in want["handles"]:
        (tt, tct), (ut, uct) = tinst._store[bytes.fromhex(h[2:])], unfused._store[bytes.fromhex(h[2:])]
        assert tt.name == ut.name
        if isinstance(uct, tri.RadixCiphertext):
            assert tct.degrees == uct.degrees
            assert torch.equal(tct.blocks, uct.blocks)
        else:
            assert (tct.degree, tct.noise_level) == (uct.degree, uct.noise_level)
            assert torch.equal(tct.ct, uct.ct)
    for n, (i, j, k) in enumerate(_erc20_transfers(transfers)):
        moved = ERC20_AMT[k] if ERC20_AMT[k] <= ERC20_BAL[i] else 0
        h_from, h_to = (bytes.fromhex(h[2:]) for h in want["handles"][4 * n + 2:4 * n + 4])
        assert tinst._decrypt_handle(h_from) == ERC20_BAL[i] - moved
        assert tinst._decrypt_handle(h_to) == (ERC20_BAL[j] + moved) % 256


def test_api_key_is_checked(pair):
    srv = FheServer(pair[1], api_key="s3cret").start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        with pytest.raises(FheClientUnauthorizedError):
            FheClient(url, timeout=30.0).health()
        assert FheClient(url, api_key="s3cret", timeout=30.0).health()["status"] == "ok"
    finally:
        srv.stop()


# -- spans and counters -----------------------------------------------------------


def _spans_state():
    return SPANS.report(), SPANS.by_layer()


def _evaluate_xors(client, pair):
    """One batched /evaluate of two xors: a single PBS round."""
    _, _, (ha, hb, _, _) = pair
    a, b = "0x" + ha.hex(), "0x" + hb.hex()
    return client.evaluate_many([("xor", [a, b]), ("xor", [b, a])])


def test_spans_are_off_without_a_profiler_session(client, pair, monkeypatch):
    """No session open: an /evaluate enters no profiler range on any thread
    (a range raises, and the server would answer 500) and SPANS keeps its
    numbers."""

    def refuse(name):
        raise AssertionError(f"span {name} entered a range with no profiler session open")

    monkeypatch.setattr(profiling, "_Range", refuse)
    before = _spans_state()
    r = _evaluate_xors(client, pair)
    assert r["batchedGroups"] == 1
    with span("api.test"):
        pass
    assert _spans_state() == before


def test_profiler_flag_is_seen_from_another_thread():
    """Spans on the server's threads read torch's module-wide flag; a torch
    that stopped setting it would turn them off without a word."""
    from torch.autograd import profiler as autograd_profiler
    from torch.profiler import ProfilerActivity, profile

    seen = []
    with profile(activities=[ProfilerActivity.CPU]):
        t = threading.Thread(target=lambda: seen.append(autograd_profiler._is_profiler_enabled))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen == [True]
    assert autograd_profiler._is_profiler_enabled is False


def test_span_self_time_is_duration_less_children():
    from torch.profiler import ProfilerActivity, profile

    @span("integer.spans_test_inner")
    def inner():
        time.sleep(0.02)

    before = {k: (v.self_s, v.count) for k, v in SPANS.layers.items()}
    with profile(activities=[ProfilerActivity.CPU]):
        with span("api.spans_test_outer"):
            time.sleep(0.01)
            inner()
            with span("wait.spans_test_wait"):
                time.sleep(0.01)
    rep = SPANS.report()
    outer, child = rep["api.spans_test_outer"]["total_s"], rep["integer.spans_test_inner"]["total_s"]
    wait = rep["wait.spans_test_wait"]["total_s"]
    assert child >= 0.02 and wait >= 0.01 and outer >= child + wait + 0.01
    d = {k: (SPANS.layers[k].self_s - before[k][0], SPANS.layers[k].count - before[k][1]) for k in before}
    assert d["api"][1] == d["integer"][1] == d["wait"][1] == 1
    assert d["api"][0] == pytest.approx(outer - child - wait, abs=2e-3)
    assert d["integer"][0] == pytest.approx(child, abs=2e-3)
    for layer, (self_s, _) in d.items():  # a layer's self time is within its spans' durations
        assert self_s <= sum(v["total_s"] for k, v in rep.items() if k.startswith(layer + ".")) + 1e-3


def test_evaluate_spans_share_a_request_id_in_device_trace(server, pair, tmp_path):
    """One /evaluate from the port's client under device_trace: every span
    of the server's handler thread carries the request's id and lies
    inside its `api.request`; the client's span is on its own thread."""
    port_client = PortClient(f"http://127.0.0.1:{server.port}", timeout=120.0)
    before = SPANS.layers["api"].count
    with profiling.device_trace(str(tmp_path)) as path:
        _evaluate_xors(port_client, pair)
    assert SPANS.layers["api"].count > before
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    (req,) = [e for e in events if e["name"] == "api.request"]
    spans = [e for e in events if e["tid"] == req["tid"] and e["name"].split(".")[0] in SPANS.layers]
    names = {e["name"] for e in spans}
    assert {"api.read", "api.wave", "instance.gather", "instance.op", "integer.bitxor", "pbs.rotate",
            "wait.lut_upload", "instance.put", "api.cost", "api.reply"} <= names
    assert {e["args"].get("request") for e in spans} == {req["args"]["request"]}
    for e in spans:  # nested under the request's own span, on its thread
        assert req["ts"] <= e["ts"] and e["ts"] + e["dur"] <= req["ts"] + req["dur"] + 1
    (post,) = [e for e in events if e["name"] == "client.post"]
    assert post["tid"] != req["tid"] and "request" not in post["args"]


def test_generate_lut_counts_each_upload():
    n = tsi.generate_lut.uploads
    tsi.generate_lut(tp.TOY_SHORTINT, lambda v: v, "cpu")
    tsi.generate_lut_bivariate(tp.TOY_SHORTINT, lambda a, b: a * b, "cpu")
    assert tsi.generate_lut.uploads == n + 2
