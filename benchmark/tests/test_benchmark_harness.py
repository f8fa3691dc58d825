"""The harness finds every piece by name, picks up new files with no edit,
runs each driver on the CPU at a tiny size, and turns ``correct`` false when
the timed path is broken underneath.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import importlib
import inspect
import json
import re
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from benchmark.harness.core import BENCH_DIR, FORBIDDEN, ROOT, load_cell, read_json
from benchmark.tests.conftest import tiny_cell

BENCH = read_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SEED = 2 ** 31 + 4242  # past 32 signed bits, as the driver's seeds are


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]] + CELLS + \
        [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load_by_name(name):
    cell = load_cell(name)
    for key in ("config", "traffic", "chips", "why"):
        assert cell.spec[key] == cell.entry[key]
    for fn in ("setup", "window", "check"):
        assert callable(getattr(cell.driver(), fn))
    assert cell.counts() is not None
    assert set(cell.spec["limits"]) == set(cell.driver().CHECKS)
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        if m["name"] != "setup_s":
            assert callable(cell.reader(m["name"]).read)
    for m in cell.per_layer:
        assert m["moves"] in e2e


def test_new_cell_and_metric_are_picked_up_without_edits(tmp_path):
    """A copy of the benchmark gains a cell (its traffic) and a per-layer
    metric as new files and new BENCHMARK.json entries alone."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    traffic = read_json(bench_dir / "traffic" / "c3x-phase1.kodak-b8.json")
    traffic["images"], traffic["lmbdas"] = 2, traffic["lmbdas"][:2]
    (bench_dir / "traffic" / "c3x-phase1.kodak-b2.json").write_text(json.dumps(traffic))
    spec = dict(read_json(bench_dir / "workloads" / "encode.c3x-kodak.b8.json"), traffic="c3x-phase1.kodak-b2")
    (bench_dir / "workloads" / "encode.c3x-kodak.b2.json").write_text(json.dumps(spec))
    (bench_dir / "metrics" / "chunks.encode.py").write_text(
        "def read(run):\n    return float(run.counters['chunks'])\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({k: spec[k] for k in ("config", "traffic", "chips", "why")}
                              | {"name": "encode.c3x-kodak.b2"})
    for m in bench["end_to_end"]:
        if m["name"] == "encode_image_steps_per_s":
            m["workloads"].append("encode.c3x-kodak.b2")
    bench["per_layer"].append({"name": "chunks.encode", "unit": "chunks", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "encode_image_steps_per_s"})
    cell = load_cell("encode.c3x-kodak.b2", bench, bench_dir)
    assert cell.traffic["images"] == 2
    assert [m["name"] for m in cell.per_layer][-1] == "chunks.encode"
    assert cell.reader("chunks.encode").read(type("R", (), {"counters": {"chunks": 3}})) == 3.0
    # The new metric reaches the old cells that report what it moves, with no edit either.
    assert "chunks.encode" in [m["name"] for m in load_cell("encode.c3x-kodak.b8", bench, bench_dir).per_layer]


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", CELLS)
def test_driver_runs_on_cpu_and_is_correct(name, trace, run_module):
    torch.manual_seed(0)
    cell = tiny_cell(name)
    result, numbers = run_module.execute(cell, torch.device("cpu"), SEED, 0.1, trace)
    assert result["correct"], result["check"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    expected = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    # Off a card: no peak for the FLOP shares and no device events for the idle share.
    off_card = {m for m in expected if m.startswith(("mfu.", "device_idle.", "step_device_ms."))}
    assert set(result["metrics"]) == expected - off_card
    if trace:
        assert result["breakdown"]["idle_gaps"]
    assert [n for n, _v, _l in numbers] == list(cell.spec["limits"])


# The faults a run must catch, each planted in the program under the timed path.
def _unchanged_state(monkeypatch, cell):
    if cell.traffic["driver"] == "encode_phase":
        import coolchic_tpu_torch.train.step as step
        monkeypatch.setattr(step, "clip_adam_update", lambda *a, **k: None)
    else:
        from coolchic_tpu_torch.hypernet.training import WholeNetOptimizer
        monkeypatch.setattr(WholeNetOptimizer, "update_", lambda *a, **k: None)


def _half_batch(monkeypatch, cell):
    if cell.traffic["driver"] == "encode_phase":
        import coolchic_tpu_torch.train.step as step
        real = step.loss_function

        def half(decoded, rate, targets, lmbdas, *a, **k):
            out = real(decoded, rate, targets, lmbdas, *a, **k)
            if not torch.is_grad_enabled() or out.loss.dim() == 0:
                return out
            keep = torch.arange(out.loss.shape[0]) < max(out.loss.shape[0] // 2, 1)
            return out._replace(loss=torch.where(keep.to(out.loss.device), out.loss, 0.0 * out.loss))
        monkeypatch.setattr(step, "loss_function", half)
    else:
        import coolchic_tpu_torch.hypernet.training as training
        real = training._batch_loss

        def half(net, state, imgs, *a, **k):
            return real(net, state, imgs[: imgs.shape[0] // 2], *a, **k)
        monkeypatch.setattr(training, "_batch_loss", half)


def _altered_answer(monkeypatch, cell):
    if cell.traffic["driver"] == "encode_phase":
        import coolchic_tpu_torch.train.step as step
        real = step.eval_metrics

        def altered(*a, **k):
            out = real(*a, **k)
            return out._replace(loss=out.loss * 1.01)
        monkeypatch.setattr(step, "eval_metrics", altered)
    else:
        import coolchic_tpu_torch.hypernet.training as training
        real = training.evaluate_wholenet

        def altered(*a, **k):
            out = real(*a, **k)
            return {**out, "loss": out["loss"] * 1.01}
        monkeypatch.setattr(training, "evaluate_wholenet", altered)


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "altered_answer": _altered_answer}

# Faults planted inside the window's entry itself, by driver: (module, function,
# a line of its source, the line that replaces it).
ENTRY_FAULTS = {
    "encode_phase": {
        "skipped_step": ("coolchic_tpu_torch.train.step", "run_phase_batch",
                         "for _ in range(n_steps):", "for _ in range(n_steps - 1):"),
        "lr_doubled": ("coolchic_tpu_torch.train.step", "run_phase_batch",
                       "lr = cosine_lr(", "lr = 2 * cosine_lr("),
    },
    "hypernet_train": {
        "half_of_rows": ("coolchic_tpu_torch.hypernet.training", "train_wholenet",
                         "rows, lead = slice(None), True", "rows, lead = slice(0, batch_size // 2), True"),
        "noise_of_step_0": ("coolchic_tpu_torch.hypernet.training", "train_wholenet",
                            "make_generator(device, seed, steps_done + i)", "make_generator(device, seed, steps_done)"),
    },
}


def _plant(monkeypatch, module_name, function, line, replacement):
    """``module.function`` recompiled from its source with ``line`` replaced,
    in the module's own namespace (so that it calls what the module holds)."""
    module = importlib.import_module(module_name)
    real = getattr(module, function)
    source = textwrap.dedent(inspect.getsource(real))
    assert source.count(line) == 1, f"{line!r} is not a line of {module_name}.{function}"
    exec(compile(source.replace(line, replacement), module.__file__, "exec"), vars(module))
    planted = getattr(module, function)
    setattr(module, function, real)
    monkeypatch.setattr(module, function, planted)


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch, run_module):
    cell = tiny_cell(name)
    if fault == "half_batch" and cell.traffic.get("images", cell.traffic.get("batch_size")) < 2:
        pytest.skip("a batch of one image has no half to leave out")
    FAULTS[fault](monkeypatch, cell)
    result, _ = run_module.execute(cell, torch.device("cpu"), SEED, 0.1, False)
    assert not result["correct"], result["check"]


@pytest.mark.parametrize("name,fault", [(name, fault) for name in CELLS
                                        for fault in ENTRY_FAULTS[load_cell(name).traffic["driver"]]])
def test_fault_inside_the_entry_is_not_correct(name, fault, monkeypatch, run_module):
    """A fault in the entry's own loop (not in a function that it calls)
    reaches what the check compares."""
    cell = tiny_cell(name)
    _plant(monkeypatch, *ENTRY_FAULTS[cell.traffic["driver"]][fault])
    result, _ = run_module.execute(cell, torch.device("cpu"), SEED, 0.1, False)
    assert not result["correct"], result["check"]


def test_run_refuses_without_a_card():
    """Without CUDA the command exits with another code than 0 and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, the command fails and prints no result."""
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "the program is not in this checkout" in p.stderr


LOADER = """
import sys
sys.path.insert(0, {root!r})
from benchmark.harness.core import load_cell, forbidden_modules
for name in {cells!r}:
    cell = load_cell(name)
    cell.driver(); cell.counts()
    for m in cell.end_to_end + cell.per_layer:
        if m["name"] != "setup_s":
            cell.reader(m["name"])
import importlib.util
spec = importlib.util.spec_from_file_location("r", {run!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(",".join(forbidden_modules()))
"""


def test_nothing_a_run_loads_is_jax_or_the_jax_package():
    """The top-level name of every module loaded for any cell, compared whole:
    coolchic_tpu_torch passes, coolchic_tpu, jax, jaxlib, flax and optax do not."""
    code = LOADER.format(root=str(ROOT), cells=CELLS, run=str(BENCH_DIR / "run.py"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert p.stdout.strip() == ""
    assert "coolchic_tpu" in FORBIDDEN and "coolchic_tpu_torch" not in FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.coolchic, benchmark.reference.hypernet\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'coolchic_tpu_torch', 'coolchic_tpu', 'jax', 'flax', 'optax', 'jaxlib'}))") % str(ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert p.stdout.strip() == "[]"
