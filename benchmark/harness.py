"""The benchmark's harness: finds a cell's configuration, traffic mix,
limits and metric readers by the names in BENCHMARK.json, runs the cell's
traffic generator through set-up, the measured window and the check, and prints the
result line.

Everything that belongs to one configuration, mix or metric lives in a file
of its own: `configs/<config>.json`, `workloads/<traffic>.json` (its `kind`
names the generator `generators/<kind>.py`), `limits/<workload>.json` and
`metrics/<metric>.py` (or `metrics/<prefix>.py` for `<prefix>.<suffix>`).
A metric reader defines `read(run) -> float | None` and may name the
program counters it needs in `COUNTERS`; a reader that finds nothing to
read returns None and the metric is left out of the line.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "tfhe_tpu"}


class Refused(Exception):
    """The run cannot be made here; no result is printed."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


@dataclasses.dataclass
class Run:
    """What a metric reader sees of one run."""

    cell: Cell
    setup_s: float
    window_s: float
    facts: dict  # the generator's counts over the window
    counters: dict  # program counter deltas over the window
    trace: object = None  # trace.TraceSummary in a --trace 1 run


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(f"bench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: Path, workload: str) -> Cell:
    spec = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]

    def applies(m):
        return workload in m.get("workloads", [workload])

    return Cell(
        name=workload,
        chips=w["chips"],
        config=_json(root / cfg_entry["file"]),
        traffic=_json(BENCH / "workloads" / f"{w['traffic']}.json"),
        limits=_json(BENCH / "limits" / f"{workload}.json"),
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[m for m in spec["per_layer"] if applies(m)],
    )


def reader(name: str):
    for stem in (name, name.split(".")[0]):
        path = BENCH / "metrics" / f"{stem}.py"
        if path.exists():
            return _module(path)
    raise Refused(f"no reader for metric {name}")


def prepare_env(root: Path, cfg: dict) -> None:
    """The configuration's prime set, and every cache inside the checkout."""
    os.environ["TFHE_TPU_PRIMES"] = str(cfg["crt_primes"])
    cache = root / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TFHE_TPU_KEY_CACHE_DIR"] = str(cache / "torch_keys")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def execute(root: Path, workload: str, seed: int, seconds: float, trace: bool, device: str,
            t_start: float, cell: Cell | None = None) -> dict:
    """One run of a cell on `device`; returns the result line's object."""
    cell = cell or load_cell(root, workload)
    prepare_env(root, cell.config)
    import torch

    from benchmark import system
    from benchmark import trace as tr

    gen = _module(BENCH / "generators" / f"{cell.traffic['kind']}.py")
    metrics = cell.per_layer if trace else cell.end_to_end
    readers = {m["name"]: reader(m["name"]) for m in metrics}
    counters = {k: v for r in readers.values() for k, v in getattr(r, "COUNTERS", {}).items()}
    cuda = device == "cuda"

    t_gen = time.perf_counter()
    state = gen.setup(cell, seed, device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    phases = {"imports and start-up": t_gen - t_start, **getattr(state, "phases", {})}
    print("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()), file=sys.stderr, flush=True)
    before = {k: system.read_counter(p) for k, p in counters.items()}
    out = {}
    if trace:
        with tr.traced(out):
            facts = gen.window(state, seconds)
    else:
        facts = gen.window(state, seconds)
    after = {k: system.read_counter(p) for k, p in counters.items()}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": torch.cuda.max_memory_allocated(0) if cuda else 0}
    found = forbidden_modules()
    if found:
        raise Refused(f"modules of JAX or the JAX package are loaded: {', '.join(found)}")
    run = Run(cell=cell, setup_s=setup_s, window_s=facts["window_s"], facts=facts,
              counters={k: after[k] - before[k] for k in counters},
              trace=out.get("trace"))
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"attempted": facts["attempted"], "failed": facts["failed"], "metrics": values, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"], dev["window_s"] = run.trace.busy_s, run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top(run.trace.kernel_s),
                               "idle_gaps": run.trace.top(run.trace.idle_by_host)}
    numbers = gen.check(state)
    checks = {name: {"value": v, "limit": cell.limits.get(name)} for name, v in numbers.items()}
    correct = facts["failed"] == 0 and all(
        c["limit"] is not None and not math.isnan(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return {"correct": correct, **result, "checks": checks}


def main(argv: list[str], t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on this machine's card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = BENCH.parent
    try:
        cell = load_cell(root, args.workload)
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise Refused(f"{args.workload} needs {cell.chips} CUDA device(s); "
                          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        res = execute(root, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_start, cell)
    except Refused as e:
        print(f"benchmark: {e}", file=sys.stderr, flush=True)
        return 3
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
