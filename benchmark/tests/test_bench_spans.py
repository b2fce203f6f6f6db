"""The per-layer metrics that read the program's spans and counters:
`api_host_ms_per_request`, `lut_uploads_per_request` and
`k4_window_roofline`. A traced toy ERC20 run on the CPU reports the first
two and leaves the roofline out (no launch on a card); the window
roofline equals `k4_roofline` where every launch has one batch size and
reads lower over mixed batches; a program without the spans and
counters they read (a renamed counter) refuses the run."""

import json
import time

import pytest

from benchmark import harness
from benchmark.trace import TraceSummary
from benchmark.tests.conftest import ROOT, toy_cell

LIMITS = {"wrong": 0, "gap_bits": 52.0, "noise_bits": 56.0}
NEW = ("k4_window_roofline", "api_host_ms_per_request", "lut_uploads_per_request")


def _per_layer(suffix):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [m for m in spec["per_layer"] if m["name"].endswith(suffix)]


def test_traced_toy_erc20_run_reports_the_span_metrics():
    cell = toy_cell("toy_g3", "toy_erc20", LIMITS, per_layer=_per_layer(".b32"))
    res = harness.execute(ROOT, cell.name, 2**31 + 11, 0.3, True, "cpu", time.perf_counter(), cell)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert m["api_host_ms_per_request.b32"]["value"] > 0
    assert m["lut_uploads_per_request.b32"]["value"] >= 1
    assert "k4_window_roofline.b32" not in m  # no K4 launch on a card
    assert res["attempted"] >= 1


def test_each_new_metric_is_listed_only_for_its_own_cell():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        if m["name"].split(".")[0] in NEW:
            cell = {"b32": "g3_erc20_b32", "b1": "g3_erc20_b1"}[m["name"].split(".")[1]]
            assert m["workloads"] == [cell] and m["source"] == "program_counter"


def _run(config: dict, batches: list, k4_seconds: float):
    trace = TraceSummary(window_s=10.0, busy_s=k4_seconds, kernel_s={"k4_group_steps": k4_seconds},
                         kernel_n={"k4_group_steps": len(batches)}, idle_by_host={})
    cell = harness.Cell(name="g3", chips=1, config=config, traffic={"batch": batches[0]}, limits={},
                        end_to_end=[], per_layer=[])
    return harness.Run(cell=cell, setup_s=0.0, window_s=10.0, facts={"attempted": 1},
                       counters={"K4": len(batches), "K4_rows": sum(batches)}, trace=trace)


def test_window_roofline_is_k4_roofline_at_one_batch_and_low_over_mixed_batches():
    from benchmark import roofline

    config = json.loads((ROOT / "benchmark" / "configs" / "fhevm_g3.json").read_text())
    window, single = harness.reader("k4_window_roofline.b32"), harness.reader("k4_roofline")
    for batch in (1, 32, 512):
        run = _run(config, [batch] * 72, 3.0)
        assert window.read(run) == pytest.approx(single.read(run), rel=1e-12)
    mixed = [1, 2, 32, 64, 1024] * 10
    g, n_pr, n = config["grouping_factor"], config["crt_primes"], config["polynomial_size"]
    each = sum(roofline.k4_bound_s(b, config["lwe_dimension"], g, n_pr, n) for b in mixed)
    assert window.read(_run(config, mixed, 3.0)) < 100.0 * each / 3.0


def test_a_program_without_the_counters_refuses_the_run(monkeypatch):
    from tfhe_tpu_torch.models import shortint
    from tfhe_tpu_torch.ops import multibit_cuda
    from tfhe_tpu_torch.utils import profiling

    from benchmark import system

    monkeypatch.delattr(profiling, "SPANS")
    monkeypatch.delattr(multibit_cuda.group_steps, "rows")
    monkeypatch.delattr(shortint.generate_lut, "uploads")
    for name in NEW:
        counters = harness.reader(name + ".b1").COUNTERS
        assert counters
        with pytest.raises(harness.Refused):
            for path in counters.values():
                system.read_counter(path)
