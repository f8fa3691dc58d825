"""Benchmark of coolchic_tpu_torch on one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the chips the cell asks for.
Set-up (imports, CUDA context, the kernel built into the checkout's cache,
inputs and weights from the seed, warm-up of the cell's shapes) is timed from
process start to the first timed unit of work (``setup_s``); the window then
runs the cell's traffic for ``--seconds``; the program's outputs are checked
against the plain reference under ``benchmark/reference/``; the last line of
standard output is one JSON object. ``--trace 1`` profiles the window's first
unit of work and prints the per-layer metrics instead of the end-to-end ones.

``--control <name>`` puts what the driver names (the reference in a lower
precision, or a planted fault) in the program's place for the compared
numbers: such a run has to come out not correct. The driver's runs never pass
it.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# Fixed cache directories inside the checkout: only a checkout's first run builds.
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "benchmark" / ".cache" / "triton")
os.environ["USE_FLAX"] = "0"

from benchmark.harness.core import PEAKS, Run, forbidden_modules, load_cell  # noqa: E402
from benchmark.harness.trace import Tracer  # noqa: E402


def power_limit_w():
    """The card's power limit in W, as nvidia-smi reads it (None without it)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def execute(cell, device, seed: int, seconds: float, trace: bool, control=None,
            start: float = PROCESS_START, marks=None):
    """Set-up, window, check and metrics of one run on ``device``; returns the
    result object (without ``device``'s card fields) and the checked numbers.
    The look for a chip is the caller's. ``marks``: (stage, host clock at its
    end) of the set-up so far; the driver's set-up adds its own (``s.marks``)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = cell.driver()
    marks = list(marks or []) + [("driver_import", time.perf_counter())]
    state = driver.setup(cell, device, seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - start
    marks += getattr(state, "marks", []) + [("rest", start + setup_s)]
    stages, last = {}, start
    for name, at in marks:
        stages[name], last = at - last, at

    tracer = Tracer(trace, device)
    counters = driver.window(state, seconds, tracer)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    numbers = driver.check(state, control)
    del state

    run = Run(cell=cell, counters=counters, trace=tracer.summary,
              peaks=PEAKS.get(torch.cuda.get_device_name(device), {}) if device.type == "cuda" else {})
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = setup_s if m["name"] == "setup_s" else cell.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(math.isfinite(v) and v <= limit for _name, v, limit in numbers)
    result = {
        "correct": correct,
        "attempted": counters["attempted"],
        "failed": counters["failed"],
        "metrics": metrics,
        "device": {"memory_peak_bytes": peak},
    }
    if trace and tracer.summary is not None:
        result["device"].update(busy_s=tracer.summary.busy_s, window_s=tracer.summary.window_s)
        result["breakdown"] = tracer.breakdown()
        result["trace_reduce_s"] = tracer.reduce_s
    result["setup_stages_s"] = stages
    result["check"] = {name: {"value": v, "limit": limit} for name, v, limit in numbers}
    return result, numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default=None)
    args = p.parse_args(argv)

    cell = load_cell(args.workload)
    try:
        import coolchic_tpu_torch
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 3
    if ROOT not in Path(coolchic_tpu_torch.__file__).resolve().parents:
        print(f"coolchic_tpu_torch is not this checkout's ({coolchic_tpu_torch.__file__})",
              file=sys.stderr)
        return 3
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2

    device = torch.device("cuda", 0)
    marks = [("imports", time.perf_counter())]
    torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    marks.append(("cuda_context", time.perf_counter()))
    result, numbers = execute(cell, device, args.seed, args.seconds, bool(args.trace), args.control,
                              marks=marks)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the port and the benchmark may not", file=sys.stderr)
        return 4
    card = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell.chips}
    result["device"] = {**card, **result["device"], "power_limit_w": power_limit_w()}
    result["check"] = result.pop("check")  # the compared numbers come last
    for name, value in result["setup_stages_s"].items():
        print(f"setup stage {name} {value!r} s", file=sys.stderr)
    for name, value, limit in numbers:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
