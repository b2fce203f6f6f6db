"""The MoE cell's yardstick: the reference router and its pair products
(`reference/deepseek_v2_moe`) against brute force at tiny sizes; a toy MoE
cell on the CPU that is `correct`, and not correct under each fault of the
timed path (a pair sent to the neighbouring expert, a dropped pair, an
altered answer, a stale result) or with the plain matmul in float32 in the
program's place; the roofline reader's composition. On the card (`-m
card`), the program at the cell's own size over a dozen seeds, and the
float32 control and each fault on three, each printing its readings as a
JSON line (`-s` shows them)."""

import dataclasses
import functools
import json
import math
import time
import types

import pytest
import torch

from benchmark import harness, roofline
from benchmark.reference import deepseek_v2_moe as dm
from benchmark.reference import glwe_matmul as rm
from benchmark.tests.conftest import MATMUL_LIMITS, ROOT, toy_cell

# the toy matmul cell's limits (conftest), and no pair without its result
LIMITS = {**MATMUL_LIMITS, "missing_pairs": 0}
SEEDS = tuple(2**31 + 1013 * i for i in range(1, 13))
CELL = "dsv2lite_moe_ep8_t256"


def _toy():
    return toy_cell("toy_moe", "toy_moe_t6", LIMITS)


def test_router_by_brute_force():
    """Softmax scores, the k largest, weights times the scaling factor (no
    renormalisation), and the held pairs token by token."""
    g = torch.Generator().manual_seed(3)
    x, router = torch.randn(5, 7, generator=g), torch.randn(6, 7, generator=g)
    idx, w = dm.route(x, router, 2, routed_scaling_factor=1.5)
    for t in range(5):
        logits = [sum(float(x[t, c]) * float(router[e, c]) for c in range(7)) for e in range(6)]
        z = sum(math.exp(v) for v in logits)
        scores = [math.exp(v) / z for v in logits]
        best = sorted(range(6), key=lambda e: -scores[e])[:2]
        assert sorted(idx[t].tolist()) == sorted(best)
        for e, we in zip(idx[t].tolist(), w[t].tolist()):
            assert we == pytest.approx(1.5 * scores[e], rel=1e-5)
    pairs = dm.held_pairs(x, router, 2, 3)
    want = [(t, e) for t in range(5) for e in sorted(idx[t].tolist()) if e < 3]
    assert [tuple(p) for p in pairs.tolist()] == want
    _, wn = dm.route(x, router, 2, norm_topk_prob=True)
    assert torch.allclose(wn.sum(dim=1), torch.ones(5))


def test_pair_products_by_brute_force():
    g = torch.Generator().manual_seed(4)
    x = torch.randint(0, 256, (4, 9), generator=g)
    w = torch.randint(-128, 128, (3, 9, 5), generator=g, dtype=torch.int64).to(torch.int8)
    rows, experts = torch.tensor([0, 3, 3, 1, 0]), torch.tensor([2, 0, 2, 1, 2])
    got = dm.pair_products(x, w, rows, experts)
    for i, (r, e) in enumerate(zip(rows.tolist(), experts.tolist())):
        assert got[i].tolist() == [sum(int(x[r, c]) * int(w[e, c, o]) for c in range(9)) for o in range(5)]


def test_moe_block_is_the_weighted_sum():
    torch.manual_seed(6)
    experts = [dm.MLP(8, 4) for _ in range(4)]
    shared = dm.MLP(8, 8)
    router, x = torch.randn(4, 8), torch.randn(3, 8)
    with torch.no_grad():
        got = dm.moe(x, router, experts, shared, 2)
        idx, w = dm.route(x, router, 2)
        want = torch.stack([sum(w[t, j] * experts[idx[t, j]](x[t]) for j in range(2)) for t in range(3)]) + shared(x)
    assert torch.allclose(got, want, atol=1e-6)


def test_toy_cell_is_correct():
    cell = _toy()
    res = harness.execute(ROOT, cell.name, 2**31 + 5, 1.0, False, "cpu", time.perf_counter(), cell)
    assert res["correct"], res["checks"]
    assert res["checks"]["missing_pairs"]["value"] == 0 and res["checks"]["wrong_outputs"]["value"] == 0
    assert res["metrics"]["gmac_per_s"]["value"] > 0 and res["attempted"] >= 1


# -- faults and the control -----------------------------------------------------


def _neighbour(fn):
    """Pair 0 sent to the next held expert."""
    @functools.wraps(fn)
    def run(enc, experts, routing, pkey, **kw):
        r = torch.as_tensor(routing).clone()
        r[0, 1] = (r[0, 1] + 1) % len(experts)
        return fn(enc, experts, r, pkey, **kw)
    return run


def _dropped(fn):
    """The last pair left out."""
    @functools.wraps(fn)
    def run(enc, experts, routing, pkey, **kw):
        return fn(enc, experts, torch.as_tensor(routing)[:-1], pkey, **kw)
    return run


def _altered(fn):
    """Pair 0's first output moved by half the output modulus where it is
    made."""
    @functools.wraps(fn)
    def run(enc, experts, routing, pkey, **kw):
        out = fn(enc, experts, routing, pkey, **kw)
        data = out.data.clone()
        data[0, 0, -1, 0] = (data[0, 0, -1, 0] + (1 << (out.n_bits_out - 1))) % (1 << out.n_bits_out)
        return dataclasses.replace(out, data=data)
    return run


def _stale(fn):
    """Every call of a kind answers with the first result it made (the
    warm-up's)."""
    first = {}

    @functools.wraps(fn)
    def run(enc, experts, routing, pkey, **kw):
        kind = experts[0].shape
        if kind not in first:
            first[kind] = fn(enc, experts, routing, pkey, **kw)
        return first[kind]
    return run


FAULTS = {"neighbour_expert": _neighbour, "dropped_pair": _dropped, "altered_answer": _altered, "stale": _stale}


def _plant(monkeypatch, fault):
    """The fault over the program's `expert_matmul`, which keeps counting
    its calls (the wrapper carries its counters)."""
    from tfhe_tpu_torch.models import glwe_matmul as gm

    monkeypatch.setattr(gm, "expert_matmul", FAULTS[fault](gm.expert_matmul))


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_toy_fault_is_not_correct(monkeypatch, fault):
    _plant(monkeypatch, fault)
    cell = _toy()
    res = harness.execute(ROOT, cell.name, 2**31 + 5, 1.0, False, "cpu", time.perf_counter(), cell)
    assert not res["correct"], res["checks"]
    if fault == "dropped_pair":
        assert res["checks"]["missing_pairs"]["value"] > 0


def _from_window(monkeypatch, install):
    """The program serves set-up; `install(state)` puts the control in its
    place from the window's start."""
    load = harness._module

    def module(path):
        m = load(path)
        if path.parent.name == "generators":
            window = m.window

            def controlled(st, seconds):
                install(st)
                return window(st, seconds)

            m.window = controlled
        return m

    monkeypatch.setattr(harness, "_module", module)


def _control(monkeypatch, cell, seed, device, dtype):
    """The plain matmul in `dtype` (TF32 off), with the keys it works out
    from the seed, over the program's `expert_matmul`: each pair through the
    clear weights of its expert's prepared matrix, in blocks of one expert's
    rows."""
    def install(st):
        from tfhe_tpu_torch.models import glwe_matmul as gm

        torch.backends.cuda.matmul.allow_tf32 = False
        p = rm.Params.from_config(cell.config)
        keys = rm.keygen(p, seed, device)
        clear_of = {id(prep): layer.weights[kind][e] for layer in st.layers for kind in layer.prepared
                    for e, prep in enumerate(layer.prepared[kind])}

        def expert_matmul(enc, experts, routing, pkey, **kw):
            routing = torch.as_tensor(routing)
            n, k1 = p.polynomial_size, p.glwe_dimension + 1
            width = experts[0].shape[1]
            out = torch.empty((len(routing), -(-width // n), k1, n), dtype=torch.int32, device=enc.glwes.device)
            for e in routing[:, 1].unique().tolist():
                sel = (routing[:, 1] == e).nonzero().flatten()
                w = clear_of[id(experts[e])].to(torch.int64)
                out[sel.to(out.device)] = rm.matmul(p, keys, enc.glwes[routing[sel, 0].to(out.device)], w,
                                                    dtype).to(torch.int32)
            return gm.CompressedResultMatrix(data=out, params=enc.params, shape=(len(routing), width),
                                             n_bits_out=p.ct_modulus_out_bits)

        monkeypatch.setattr(gm, "expert_matmul", expert_matmul)

    _from_window(monkeypatch, install)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_toy_control(monkeypatch, dtype):
    """The plain matmul in float64 in the program's place passes; in float32
    it does not."""
    cell = _toy()
    seed = 2**31 + 303
    _control(monkeypatch, cell, seed, "cpu", dtype)
    res = harness.execute(ROOT, cell.name, seed, 0.2, False, "cpu", time.perf_counter(), cell)
    assert res["correct"] == (dtype == torch.float64), res["checks"]


def test_roofline_reader_composes_the_matmul_counts():
    """A call whose pairs each have their own row and one expert is the
    matmul of those rows; a token's transform counts once however many of
    its experts run, and each expert's weights once a call. Missing where
    the program's pair counter disagrees with the traffic."""
    cell = _toy()
    c = cell.config
    inner, out = c["hidden_size"], 2 * c["moe_intermediate_size"]
    shape = (1, c["crt_primes"], c["polynomial_size"], c["packing_ks_level"])
    reader = harness.reader("expert_roofline.moe")

    def share(calls, pairs=None):
        total = sum(cl[1] for cl in calls)
        run = types.SimpleNamespace(cell=cell, facts={"calls": calls, "pairs": total},
                                    counters={"pairs": total if pairs is None else pairs},
                                    trace=types.SimpleNamespace(window_s=2.0))
        return reader.read(run)

    assert share([("gate_up", 5, 5, 1)]) == pytest.approx(100.0 * roofline.matmul_bound_s(5, inner, out, *shape) / 2.0)
    ops = roofline.matmul_ops(5, inner, out, *shape) - roofline.ntt_ops(3 * 2 * 2, 3, c["polynomial_size"])
    weights = roofline.matmul_bytes(0, inner, out, *shape) - roofline.matmul_bytes(0, inner, 0, *shape)
    n_bytes = roofline.matmul_bytes(5, inner, out, *shape) + 2 * weights - 3 * 2 * 256 * 2 * 8
    assert share([("gate_up", 5, 2, 3)]) == pytest.approx(100.0 * roofline.bound_s(n_bytes, ops) / 2.0)
    assert share([("gate_up", 5, 5, 1)], pairs=4) is None


# -- on the card ------------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
def test_program_at_cell_size(card, seed):
    """The program's readings at the cell's size: a window of one layer (its
    two grouped calls) at least."""
    cell = harness.load_cell(ROOT, CELL)
    t0 = time.perf_counter()
    res = harness.execute(ROOT, cell.name, seed, 5.0, False, card, t0, cell)
    print(json.dumps({"workload": cell.name, "seed": seed, "checks": res["checks"], "attempted": res["attempted"],
                      "metrics": res["metrics"], "peak": res["device"]["memory_peak_bytes"],
                      "seconds": time.perf_counter() - t0}))
    assert res["attempted"] >= 2
    assert res["correct"], res["checks"]


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("fault", sorted(FAULTS) + ["float32"])
def test_fault_and_control_at_cell_size(card, monkeypatch, fault, seed):
    cell = harness.load_cell(ROOT, CELL)
    harness.prepare_env(ROOT, cell.config)
    if fault == "float32":
        _control(monkeypatch, cell, seed, card, torch.float32)
    else:
        _plant(monkeypatch, fault)
    t0 = time.perf_counter()
    res = harness.execute(ROOT, cell.name, seed, 1.0, False, card, t0, cell)
    print(json.dumps({"workload": cell.name, "fault": fault, "seed": seed, "checks": res["checks"],
                      "attempted": res["attempted"], "seconds": time.perf_counter() - t0}))
    assert not res["correct"], res["checks"]
