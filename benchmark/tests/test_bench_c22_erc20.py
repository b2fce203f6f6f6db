"""The ERC20 traffic on the classic 2_2 key (`c22_erc20_b32`): the toy
`toy_c22` x `toy_erc20` cell on the CPU is `correct`, and not correct under
each fault of the PBS underneath (the integer layer's `_pbs_flat`) or with
the reference in float32 in the program's place; the key held at fewer
bits moves its `noise_bits` over the limit. On the card (`-m card`), both
controls at the cell's own size on three seeds, each printing its readings
as a JSON line (`-s` shows them)."""

import json
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import ROOT, toy_cell
from benchmark.tests.test_bench_control import (CONTROLS, SEEDS, TOY_KEY_BITS, TOY_LIMITS, _in_place,
                                                _in_place_for_window)
from benchmark.tests.test_bench_faults import FAULTS

CELL = "c22_erc20_b32"


def _toy():
    return toy_cell("toy_c22", "toy_erc20", TOY_LIMITS)


def _run(cell, seed=2**31 + 5):
    return harness.execute(ROOT, cell.name, seed, 0.2, False, "cpu", time.perf_counter(), cell)


def test_toy_cell_is_correct():
    res = _run(_toy())
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_toy_fault_is_not_correct(monkeypatch, fault):
    from tfhe_tpu_torch.models import integer as ri

    monkeypatch.setattr(ri, "_pbs_flat", FAULTS[fault](ri._pbs_flat))
    res = _run(_toy())
    assert not res["correct"] and res["checks"]["wrong"]["value"] > 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_toy_control(monkeypatch, dtype):
    """The reference in float64 in the program's place passes; in float32
    it does not."""
    cell, seed = _toy(), SEEDS[0]
    _in_place(monkeypatch, cell, seed, "cpu", dtype)
    assert _run(cell, seed)["correct"] == (dtype == torch.float64)


def test_toy_key_bits_control_fails_the_noise_limit(monkeypatch):
    cell, seed = _toy(), SEEDS[1]
    _in_place(monkeypatch, cell, seed, "cpu", torch.float64, TOY_KEY_BITS)
    res = _run(cell, seed)
    noise = res["checks"]["noise_bits"]
    assert noise["limit"] < noise["value"] < 62, res["checks"]


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("control", sorted(CONTROLS))
def test_control_at_cell_size(card, monkeypatch, control, seed):
    cell = harness.load_cell(ROOT, CELL)
    harness.prepare_env(ROOT, cell.config)
    _in_place_for_window(monkeypatch, cell, seed, card, control)
    t0 = time.perf_counter()
    res = harness.execute(ROOT, CELL, seed, 0.1, False, card, t0, cell)
    print(json.dumps({"workload": CELL, "control": control, "seed": seed, "checks": res["checks"],
                      "seconds": time.perf_counter() - t0}))
    assert not res["correct"]
