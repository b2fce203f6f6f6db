"""The benchmark's own tests: `python -m pytest benchmark/tests` from the
root of a checkout. Tests marked `card` need a CUDA device and skip without
one; on the card run them with `python -m pytest benchmark/tests -m card`."""

import json
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture(autouse=True, scope="session")
def _env(tmp_path_factory):
    import torch

    torch.set_num_threads(4)
    os.environ["TFHE_TPU_KEY_CACHE"] = "0"  # keygen on the CPU writes no key file
    os.environ["TFHE_TPU_KEY_CACHE_DIR"] = str(tmp_path_factory.mktemp("keys"))


def toy_cell(config: str, traffic: str, limits: dict, per_layer=()):
    """A cell at a toy size, for runs on the CPU."""
    from benchmark import harness

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    return harness.Cell(name=f"{config}.{traffic}", chips=1,
                        config=json.loads((DATA / f"{config}.json").read_text()),
                        traffic=json.loads((DATA / f"{traffic}.json").read_text()),
                        limits=limits, end_to_end=list(spec["end_to_end"]), per_layer=list(per_layer))
