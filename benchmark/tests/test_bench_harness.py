"""The harness as data: a configuration, a traffic mix, a limits file and a
metric reader added as files are picked up with no edit to a file that is
there; a run without a card exits non-zero and prints no result."""

import json
import shutil
import subprocess
import sys
import time

from benchmark.tests.conftest import DATA, ROOT


def test_added_files_are_picked_up(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    b = root / "benchmark"
    shutil.copy(DATA / "toy_c22.json", b / "configs" / "toy_added.json")
    shutil.copy(DATA / "toy_pbs.json", b / "workloads" / "toy_added_mix.json")
    (b / "limits" / "toy_added_cell.json").write_text(json.dumps({"wrong": 0, "gap_bits": 52.0}))
    (b / "metrics" / "batches_seen.py").write_text("def read(run):\n    return float(run.facts['attempted'])\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy_added", "source": "https://example.org/toy",
                            "file": "benchmark/configs/toy_added.json", "reduced": [], "why": "toy"})
    spec["workloads"].append({"name": "toy_added_cell", "config": "toy_added", "traffic": "toy_added_mix",
                              "chips": 1, "why": "toy"})
    next(m for m in spec["end_to_end"] if m["name"] == "pbs_per_s")["workloads"].append("toy_added_cell")
    spec["per_layer"].append({"name": "batches_seen.toy", "unit": "batches", "better": "higher",
                              "source": "program_counter", "layer": "harness", "moves": "pbs_per_s",
                              "workloads": ["toy_added_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for p, data in before.items():
        assert p.read_bytes() == data  # nothing that was there was edited

    code = (
        "import sys, json, time; sys.path[:0] = [%r, %r]\n"
        "import torch; torch.set_num_threads(4)\n"
        "from pathlib import Path\n"
        "from benchmark import harness\n"
        "for trace in (False, True):\n"
        "    res = harness.execute(Path(%r), 'toy_added_cell', 5, 0.5, trace, 'cpu', time.perf_counter())\n"
        "    print(json.dumps(res))\n"
    ) % (str(root), str(ROOT), str(root))
    env = {"TFHE_TPU_KEY_CACHE": "0", "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         cwd=root, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    untraced, traced = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert untraced["correct"] and set(untraced["metrics"]) == {"pbs_per_s", "setup_s"}
    assert traced["correct"] and traced["metrics"]["batches_seen.toy"]["value"] >= 1
    assert list(traced)[-1] == "checks"


def test_no_card_exits_nonzero_without_result():
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}
    t0 = time.time()
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "c22_pbs_b512", "--seed", "3",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=300)
    assert out.returncode != 0
    assert "metrics" not in out.stdout and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
    assert time.time() - t0 < 120


def test_a_missing_counter_refuses_the_run():
    import pytest

    from benchmark import harness, system

    assert system.read_counter("tfhe_tpu_torch.models.integer:_pbs.rows") >= 0
    for path in ("tfhe_tpu_torch.models.integer:_pbs.renamed", "tfhe_tpu_torch.no_such_module:x"):
        with pytest.raises(harness.Refused):
            system.read_counter(path)


def test_program_params_are_the_files_numbers():
    from benchmark import system

    cfg = json.loads((DATA / "toy_g3.json").read_text())
    cfg = {**cfg, "parameter_set": "V1_4_PARAM_MULTI_BIT_GROUP_3_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128",
           "lwe_dimension": 21, "pbs_base_log": 19}
    p = system.program_params(cfg)
    assert (p.name, p.lwe_dimension, p.pbs.base_log) == (cfg["parameter_set"], 21, 19)
