"""Shared set-up of the benchmark's own tests: the checkout's root on the
import path, and each cell shrunk to a size the CPU runs in seconds."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Per driver: the traffic's and the configuration's keys set for a CPU run.
TINY = {
    "encode_phase": ({"height": 32, "width": 48, "chunk_itr": 4}, {}),
    "hypernet_train": ({"batch_size": 2, "eval_batch": 2, "chunk_samples": 4, "freq_valid_samples": 4},
                       {"patch_size": [32, 32]}),
}


def tiny_cell(name: str):
    from benchmark.harness.core import load_cell

    cell = load_cell(name)
    traffic, config = TINY[cell.traffic["driver"]]
    cell.traffic.update(traffic)
    cell.config.update(config)
    if "images" in cell.traffic:  # at most 2 images, with the first lambdas
        cell.traffic["images"] = min(cell.traffic["images"], 2)
        cell.traffic["lmbdas"] = cell.traffic["lmbdas"][: cell.traffic["images"]]
    return cell


@pytest.fixture
def run_module():
    """``benchmark/run.py`` as a module (its ``execute`` skips the look for a chip)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("benchmark_run", ROOT / "benchmark" / "run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
