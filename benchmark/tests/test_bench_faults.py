"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven on the
CPU at a toy size, once for each fault a cell can have. (One card a cell:
no exchange between chips to leave out.)"""

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import ROOT, toy_cell

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
