"""Finding a cell's files by name, and what a run hands to the metric readers.

``BENCHMARK.json`` at the checkout's root names each cell's configuration,
traffic and metrics. Every piece that belongs to one of them is a file of its
own under ``benchmark/``, found by that name:

    configs/<config>.json     sizes, precision, source, reduced, assumed
    counts/<config>.py        FLOP and byte counts of the configuration
    traffic/<traffic>.json    the traffic's parameters and the driver it uses
    drivers/<driver>.py       set-up, window and check of one kind of traffic
    workloads/<cell>.json     the cell: config, traffic, chips, why, limits
    metrics/<metric>.py       ``read(run) -> float | None`` of one metric

A later cell, configuration, traffic or metric is new files and new entries of
``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "coolchic_tpu")

# Dense peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet). TF32
# is the fastest tensor-core rate that an f32 program can be computed at, so
# no share of it can pass 100 %.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"tf32_flops": 495e12, "f64_tensor_flops": 67e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def load_module(path: Path) -> ModuleType:
    """Import one file by its path, under a name made from that path (the
    file names carry dots and dashes)."""
    name = "bench_" + hashlib.sha1(str(path).encode()).hexdigest()[:12]
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of ``workloads``, with everything found by its names."""

    name: str
    entry: Dict[str, Any]  # the BENCHMARK.json entry
    spec: Dict[str, Any]  # workloads/<cell>.json
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    bench_dir: Path = BENCH_DIR

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def driver(self) -> ModuleType:
        return load_module(self.bench_dir / "drivers" / f"{self.traffic['driver']}.py")

    def counts(self) -> ModuleType:
        return load_module(self.bench_dir / "counts" / f"{self.entry['config']}.py")

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.bench_dir / "metrics" / f"{metric}.py")


def _reports(metric: Dict[str, Any], cell: str, e2e_of_cell: Optional[List[str]]) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads`` list;
    without that key, every cell (an end-to-end metric, ``e2e_of_cell`` None)
    or every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_of_cell is None or metric["moves"] in e2e_of_cell


def load_cell(name: str, bench: Optional[Dict[str, Any]] = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``) and its files."""
    bench = bench if bench is not None else read_json(ROOT / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, None)]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(
        name=name, entry=entry,
        spec=read_json(bench_dir / "workloads" / f"{name}.json"),
        config=read_json(bench_dir / "configs" / f"{entry['config']}.json"),
        traffic=read_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=e2e, per_layer=per_layer, bench_dir=bench_dir,
    )


def sub_seed(seed: int, *keys: Any) -> int:
    """A 63-bit seed for one purpose, from the run's seed (any integer)."""
    digest = hashlib.sha256(repr((int(seed),) + keys).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


@dataclass
class Run:
    """What a driver hands to the metric readers: its counters (work done,
    window seconds by the host clock), the trace summary of the traced unit
    of work (or None), the configuration's counts, and the card's peaks."""

    cell: Cell
    counters: Dict[str, Any] = field(default_factory=dict)
    trace: Any = None
    peaks: Dict[str, float] = field(default_factory=dict)

    @property
    def counts(self) -> ModuleType:
        return self.cell.counts()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (the whole top-level name compared: ``coolchic_tpu_torch``
    is not ``coolchic_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
