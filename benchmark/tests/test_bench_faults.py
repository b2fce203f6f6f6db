"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven on the
CPU at a toy size, once for each fault a cell can have. (One card a cell:
no exchange between chips to leave out.) The matmul's faults also run at
the cell's own size on the card (`-m card`), on three seeds each."""

import dataclasses
import json
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import MATMUL_LIMITS, ROOT, toy_cell

LIMITS = {"wrong": 0, "gap_bits": 52.0, "noise_bits": 56.0}


def _unchanged(fn):
    return lambda sk, c, lut, *rest: c


def _half(fn):
    def run(sk, c, lut, *rest):
        x = c.ct if hasattr(c, "ct") else c
        h = max(1, x.shape[0] // 2)
        part = fn(sk, type(c)(**{**c.__dict__, "ct": x[:h]}) if hasattr(c, "ct") else x[:h],
                  lut if lut.dim() == 2 else lut[:h], *rest)
        y = part.ct if hasattr(part, "ct") else part
        full = torch.cat([y] * (x.shape[0] // h + 1))[:x.shape[0]]
        return type(part)(**{**part.__dict__, "ct": full}) if hasattr(part, "ct") else full
    return run


def _altered(fn):
    def run(sk, c, lut, *rest):
        out = fn(sk, c, lut, *rest)
        y = (out.ct if hasattr(out, "ct") else out).clone()
        y[0, -1] += 1 << 60  # one answer's message moved where it is produced
        return type(out)(**{**out.__dict__, "ct": y}) if hasattr(out, "ct") else y
    return run


FAULTS = {"unchanged": _unchanged, "half_batch": _half, "altered_answer": _altered}


def _run(cell):
    return harness.execute(ROOT, cell.name, 2**31 + 5, 0.3, False, "cpu", time.perf_counter(), cell)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("config", ["toy_c22", "toy_g3"])
def test_pbs_cell_fault_is_not_correct(monkeypatch, config, fault):
    from tfhe_tpu_torch.models import shortint as si

    cell = toy_cell(config, "toy_pbs", LIMITS)
    assert _run(cell)["correct"]
    monkeypatch.setattr(si, "apply_lut", FAULTS[fault](si.apply_lut))
    res = _run(cell)
    assert not res["correct"] and res["checks"]["wrong"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_erc20_cell_fault_is_not_correct(monkeypatch, fault):
    from tfhe_tpu_torch.models import integer as ri

    cell = toy_cell("toy_g3", "toy_erc20", LIMITS)
    monkeypatch.setattr(ri, "_pbs_flat", FAULTS[fault](ri._pbs_flat))
    res = _run(cell)
    assert not res["correct"] and res["checks"]["wrong"]["value"] > 0


def test_erc20_cell_is_correct():
    res = _run(toy_cell("toy_g3", "toy_erc20", LIMITS))
    assert res["correct"], res["checks"]


def _stale(fn):
    """Every matmul answers with the first result it made (the warm-up's)."""
    first = []

    def run(enc, clear, pkey):
        if not first:
            first.append(fn(enc, clear, pkey))
        return first[0]
    return run


def _half_rows(fn):
    """Half of the rows computed, the rest copied from them."""
    def run(enc, clear, pkey):
        r = enc.shape[0]
        h = max(1, r // 2)
        part = fn(dataclasses.replace(enc, glwes=enc.glwes[:h], shape=(h, enc.shape[1])), clear, pkey)
        return dataclasses.replace(part, data=torch.cat([part.data] * (r // h + 1))[:r], shape=(r, part.shape[1]))
    return run


def _altered_matmul_answer(fn):
    """Output 0's body moved by half the output modulus where it is made."""
    def run(enc, clear, pkey):
        out = fn(enc, clear, pkey)
        data = out.data.clone()
        data[0, 0, -1, 0] = (data[0, 0, -1, 0] + (1 << (out.n_bits_out - 1))) % (1 << out.n_bits_out)
        return dataclasses.replace(out, data=data)
    return run


def _changed_weight(prepare):
    """One weight changed (by 64) in what the server prepared."""
    def run(params, clear, *args, **kwargs):
        w = clear.clone()
        w[0, 0] += 64
        return prepare(params, w, *args, **kwargs)
    return run


MATMUL_FAULTS = {"stale": _stale, "half_rows": _half_rows, "altered_answer": _altered_matmul_answer}
SEEDS = (2**31 + 404, 2**31 + 505, 2**31 + 606)


def _plant(monkeypatch, fault):
    from tfhe_tpu_torch.models import glwe_matmul as gm

    if fault == "changed_weight":
        monkeypatch.setattr(gm, "prepare_clear_weights", _changed_weight(gm.prepare_clear_weights))
    else:
        monkeypatch.setattr(gm, "matrix_multiplication", MATMUL_FAULTS[fault](gm.matrix_multiplication))


@pytest.mark.parametrize("fault", sorted(MATMUL_FAULTS) + ["changed_weight"])
def test_matmul_cell_fault_is_not_correct(monkeypatch, fault):
    _plant(monkeypatch, fault)
    cell = toy_cell("toy_matmul", "toy_matmul_mix", MATMUL_LIMITS)
    res = harness.execute(ROOT, cell.name, 2**31 + 5, 1.5, False, "cpu", time.perf_counter(), cell)
    assert not res["correct"], res["checks"]


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", sorted(MATMUL_FAULTS) + ["changed_weight"])
def test_matmul_fault_at_cell_size(card, monkeypatch, fault, seed):
    """Each fault at the cell's own size, a window of at least one pass over
    the layers; prints its readings as a JSON line (`-s` shows them)."""
    cell = harness.load_cell(ROOT, "ml_matmul_8b")
    _plant(monkeypatch, fault)
    t0 = time.perf_counter()
    res = harness.execute(ROOT, cell.name, seed, 3.0, False, card, t0, cell)
    print(json.dumps({"workload": cell.name, "fault": fault, "seed": seed, "checks": res["checks"],
                      "attempted": res["attempted"], "seconds": time.perf_counter() - t0}))
    assert res["attempted"] >= len(cell.traffic["layers"])
    assert not res["correct"], res["checks"]
