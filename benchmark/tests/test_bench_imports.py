"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the measured program. Top-level module names
(the part before the first dot) are compared whole, so `tfhe_tpu_torch`
is not taken for `tfhe_tpu`."""

import ast
import subprocess
import sys

from benchmark.tests.conftest import ROOT

BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "tfhe_tpu"}


def _imports(path):
    """Top-level names of every module an import statement in the file
    names, wherever the statement stands."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _run_modules():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


def test_benchmark_sources_import_no_jax():
    bad = {str(p.relative_to(ROOT)): sorted(_imports(p) & FORBIDDEN) for p in _run_modules()}
    assert not {k: v for k, v in bad.items() if v}
    assert len(_run_modules()) > 10  # the walk found the harness, generators, metrics and reference


def test_reference_imports_nothing_of_the_program():
    for p in (BENCH / "reference").rglob("*.py"):
        names = _imports(p)
        assert "tfhe_tpu_torch" not in names and not names & FORBIDDEN, p
        assert names <= {"__future__", "dataclasses", "math", "torch", "benchmark"}, (p, names)


def test_run_loads_no_jax_module():
    """Load every module a run loads, the program's included, in a fresh
    process, and read sys.modules."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from pathlib import Path\n"
        "from benchmark import harness, system, roofline, trace\n"
        "from benchmark.reference import tfhe, rng, erc20\n"
        "for d in ('generators', 'metrics'):\n"
        "    for p in sorted((Path(%r) / d).glob('*.py')): harness._module(p)\n"
        "import tfhe_tpu_torch.api.instance, tfhe_tpu_torch.api.serve, tfhe_tpu_torch.api.client\n"
        "import tfhe_tpu_torch.models.shortint, tfhe_tpu_torch.models.integer\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & %r))\n"
    ) % (str(ROOT), str(BENCH), FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
