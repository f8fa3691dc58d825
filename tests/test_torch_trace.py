"""The port's span recorder (``coolchic_tpu_torch/utils/trace.py``) and the
spans at its layer boundaries: nesting, parent and root ids, a length that
a step of the wall clock cannot bend, the bound on the queue, one parent
stack per thread, ``under_profiler`` and the clock shared with
``torch.profiler``; ``run_phase_batch`` and ``train_wholenet`` at tiny
sizes, span by span against what they count, and with no synchronise of the
device; the image and video encoders' ``stage_seconds``, the writer's and
the one-shot encode's ``timings`` read from spans, with the keys they had.

    python -m pytest tests/test_torch_trace.py -q
    python -m pytest --noconftest -m cuda tests/test_torch_trace.py -q   # on the card

Imports no JAX: the tests marked ``cuda`` run on the card's machine.
"""

import inspect
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from coolchic_tpu_torch.bitstream import encode_image_bitstream
from coolchic_tpu_torch.hypernet import NOWholeNet
from coolchic_tpu_torch.hypernet import training
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.models.coolchic import init_coolchic_params
from coolchic_tpu_torch.metalearning.data import synthetic_batches
from coolchic_tpu_torch.params import from_numpy_pytree, stack_params, tree_map
from coolchic_tpu_torch.train import step
from coolchic_tpu_torch.train.encode import EncodeStats, encode_frame_batch
from coolchic_tpu_torch.train.presets import Preset, TrainerPhase, Warmup, WarmupPhase
from coolchic_tpu_torch.utils import trace
from coolchic_tpu_torch.video import encoder as video_encoder
from coolchic_tpu_torch.video.codingstructure import CodingStructure
from torch_bitstream_cases import case

ARCH = dict(n_ft_per_res=(1, 1, 1), dim_arm=8, n_hidden_layers_arm=1,
            layers_synthesis=("8-1-linear-relu", "X-1-linear-none"))
SIZE = (16, 24)


def _after(mark, name=None):
    """The spans opened after the span ``mark`` (a fresh one)."""
    return [s for s in trace.spans(name) if s.id > mark.id]


def _mark():
    with trace.span("test.mark") as m:
        pass
    return m


# --------------------------------------------------------------------------- #
# The recorder
# --------------------------------------------------------------------------- #


def test_nesting_parent_and_root_ids():
    with trace.span("a", k=1) as a:
        with trace.span("b") as b:
            with trace.span("c") as c:
                pass
        with trace.span("d") as d:
            pass
    with trace.span("e") as e:
        pass
    assert (a.parent, a.root) == (None, a.id) and a.attrs == {"k": 1}
    assert (b.parent, b.root) == (a.id, a.id)
    assert (c.parent, c.root) == (b.id, a.id)
    assert (d.parent, d.root) == (a.id, a.id)
    assert (e.parent, e.root) == (None, e.id)
    assert a.id < b.id < c.id < d.id < e.id
    assert trace.children(a) == [b, d] and trace.children(b) == [c] and trace.children(e) == []
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= d.start_ns <= a.end_ns
    assert [s.name for s in trace.spans() if s.id >= a.id][:5] == ["a", "b", "c", "d", "e"]
    assert trace.spans("c")[-1] is c


def test_span_closes_when_its_block_raises():
    with pytest.raises(ValueError):
        with trace.span("raises") as r:
            raise ValueError
    with trace.span("after") as after:
        pass
    assert r.end_ns is not None and r.end_ns >= r.start_ns
    assert after.parent is None  # the raising span left the stack


def test_length_is_monotonic_when_the_wall_clock_steps(monkeypatch):
    """The start is stamped on the wall clock, the length on the monotonic
    one: a wall clock set back by a second inside a span moves neither."""
    wall = iter([10_000_000_000, 9_000_000_000])
    monkeypatch.setattr(trace, "time_ns", lambda: next(wall))
    with trace.span("outer") as outer:
        with trace.span("stepped back") as inner:
            pass
    assert outer.start_ns == 10_000_000_000 and inner.start_ns == 9_000_000_000
    assert 0 <= inner.ns <= outer.ns < 1_000_000_000
    assert outer.end_ns == outer.start_ns + outer.ns


def test_queue_keeps_the_newest_capacity_records():
    first = _mark()
    for _ in range(trace.CAPACITY + 10):
        with trace.span("bulk"):
            pass
    held = trace.spans()
    assert len(held) == trace.CAPACITY
    assert first not in held and held[-1].name == "bulk"
    assert [s.id for s in held] == sorted(s.id for s in held)


def test_one_parent_stack_per_thread():
    seen = {}
    ready, go = threading.Barrier(2, timeout=10), threading.Event()

    def worker(name):
        with trace.span(name) as outer:
            ready.wait()
            go.wait(10)
            with trace.span(name + ".inner") as inner:
                pass
        seen[name] = (outer, inner)

    threads = [threading.Thread(target=worker, args=(n,)) for n in ("t0", "t1")]
    for t in threads:
        t.start()
    with trace.span("main") as main:
        go.set()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    assert main.parent is None
    for name, (outer, inner) in seen.items():
        assert outer.parent is None and inner.parent == outer.id and inner.root == outer.id


# --------------------------------------------------------------------------- #
# The profiler: under_profiler, the shared clock, nothing entered
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("activities", [[ProfilerActivity.CPU],
                                        [ProfilerActivity.CPU, ProfilerActivity.CUDA]],
                         ids=["cpu", "cpu+cuda"])
def test_under_profiler(activities):
    with trace.span("before") as before:
        pass
    with profile(activities=activities):
        with trace.span("inside") as inside:
            pass
    with trace.span("after") as after:
        pass
    assert not before.under_profiler and inside.under_profiler and not after.under_profiler


def test_profiler_stamps_on_the_span_clock():
    """An aten op run inside a span has its profiler start (and end) inside
    the span's interval: both are on ``time.time_ns``'s clock."""
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("matmul") as s:
            x @ x
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert events
    for e in events:
        assert s.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= s.end_ns


def test_spans_enter_no_profiler_event():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("not.an.event"):
            torch.ones(4).sum()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "aten::sum" in names and "not.an.event" not in names


def test_no_synchronise_in_the_loops_or_the_recorder():
    """The loops that the spans time, and the recorder, hold no synchronise
    of the device, under any guard; ``test_no_synchronise_on_the_card``
    runs them on the card, callees included."""
    for code in (trace, step.run_phase_batch, step.train_step, training.train_wholenet):
        assert "synchronize" not in inspect.getsource(code)


# --------------------------------------------------------------------------- #
# The spans of the phase engine and of the hypernet train loop
# --------------------------------------------------------------------------- #


def _phase_run(max_itr=7, freq_valid=3, images=2, device="cpu"):
    cfg = CoolChicConfig(img_size=SIZE, **ARCH)
    rows = [init_coolchic_params(torch.Generator().manual_seed(s), cfg, "cpu", latent_init="normal")
            for s in range(images)]
    params = tree_map(lambda t: t.to(device), stack_params(rows))
    targets = torch.rand((images, 3) + SIZE, generator=torch.Generator().manual_seed(9)).to(device)
    phase = TrainerPhase(lr=1e-2, max_itr=max_itr, freq_valid=freq_valid, patience=1,
                         schedule_lr=True, quantizer_type="ste", quantizer_noise_type="none")
    mark = _mark()
    _, logs = step.run_phase_batch(params, targets, [1e-3, 2e-3][:images], cfg, phase)
    return mark, logs


def test_run_phase_batch_spans():
    mark, logs = _phase_run()
    (root,) = _after(mark, "phase")
    assert root.parent is None and root.attrs == {"images": 2, "max_itr": 7}
    kids = trace.children(root)
    names = [k.name for k in kids]
    assert names.count("phase.step") == logs.n_batched_steps == 7
    validations = [k for k in kids if k.name == "phase.validate"]
    assert len(validations) == logs.n_eval_forwards == 4  # one first, one per block of 3, 3, 1
    for v in validations:
        assert [w.name for w in trace.children(v)] == ["phase.wait"]
    assert set(names) == {"phase.step", "phase.validate"}
    assert all(s.root == root.id for s in _after(mark) if s.name.startswith("phase"))
    # Children in order and inside the root; the record bookkeeping lies between them.
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    assert root.start_ns <= kids[0].start_ns and kids[-1].end_ns <= root.end_ns


def test_phase_spans_under_the_encoder_stage():
    cfg = CoolChicConfig(img_size=SIZE, **ARCH)
    preset = Preset(
        preset_name="tiny",
        warmup=Warmup(phases=(WarmupPhase(candidates=2, training_phase=TrainerPhase(
            lr=1e-2, max_itr=2, freq_valid=2, patience=100)),)),
        all_phases=(TrainerPhase(lr=1e-2, max_itr=3, freq_valid=3, patience=100),),
    )
    targets = torch.rand((1, 3) + SIZE, generator=torch.Generator().manual_seed(3))
    mark = _mark()
    result = encode_frame_batch(targets, [1e-3], cfg, preset, [0])
    stages = {s.name: s for s in _after(mark) if s.name.startswith("encode.")}
    assert set(result.stats.stage_seconds) == {"warmup", "phase_0"}
    assert set(stages) == {"encode.warmup", "encode.phase_0"}
    for name, seconds in result.stats.stage_seconds.items():
        assert seconds == pytest.approx(1e-9 * stages["encode." + name].ns)
    phases = _after(mark, "phase")
    assert [p.parent for p in phases] == [stages["encode.warmup"].id, stages["encode.phase_0"].id]


def _train_run(n_samples=8, batch_size=2, freq_valid_samples=4, device="cpu", **kw):
    cfg = CoolChicConfig(img_size=(32, 32), **ARCH)
    net = NOWholeNet(cfg, n_hidden_channels=4)
    state = net.init(0, device=device)
    phase = TrainerPhase(lr=1e-4, max_itr=1, schedule_lr=True, quantizer_type="softround",
                         quantizer_noise_type="gaussian", softround_temperature=(0.3, 0.3),
                         noise_parameter=(0.25, 0.25))
    eval_imgs = next(synthetic_batches(2, (32, 32), seed=5))
    mark = _mark()
    _, logs = training.train_wholenet(
        net, state, synthetic_batches(batch_size, (32, 32), seed=4), eval_imgs, 1e-3, phase, 7,
        n_samples, batch_size, freq_valid_samples=freq_valid_samples, verbose=False, **kw)
    return mark, logs


def test_train_wholenet_spans(monkeypatch):
    records = []
    monkeypatch.setattr(training.cclog, "log", lambda m, step=None: records.append(m))
    mark, logs = _train_run()
    (root,) = _after(mark, "train")
    # On the CPU every step runs eagerly (no CUDA graph).
    assert root.parent is None and root.attrs == {
        "n_samples": 8, "batch_size": 2, "graph_captures": 0, "graph_replays": 0, "eager_steps": 4}
    names = [k.name for k in trace.children(root)]
    assert names == ["train.data", "train.h2d", "train.step"] * 2 + ["train.validate"] + \
        ["train.data", "train.h2d", "train.step"] * 2 + ["train.validate"]
    assert len(logs) == names.count("train.validate") == len(records) == 2
    # The operator's record: host ms per step since the previous validation,
    # in checkpoints since then (none here), and of the validation itself;
    # the steps since then by how they ran.
    steps = [k for k in trace.children(root) if k.name != "train.validate"]
    validations = [k for k in trace.children(root) if k.name == "train.validate"]
    for i, record in enumerate(records):
        for name in ("train.data", "train.h2d", "train.step"):
            ns = [k.ns for k in steps[6 * i:6 * i + 6] if k.name == name]
            assert record[name + "_ms"] == pytest.approx(1e-6 * sum(ns) / 2)
        assert record["train.checkpoint_ms"] == 0
        assert record["train.validate_ms"] == pytest.approx(1e-6 * validations[i].ns)
        assert (record["graph_captures"], record["graph_replays"], record["eager_steps"]) == (0, 0, 2)


def test_train_wholenet_checkpoint_span(tmp_path, monkeypatch):
    records = []
    monkeypatch.setattr(training.cclog, "log", lambda m, step=None: records.append(m))
    mark, _ = _train_run(n_samples=4, freq_valid_samples=4, workdir=tmp_path,
                         checkpointing_freq_samples=2)
    (root,) = _after(mark, "train")
    checkpoints = [k for k in trace.children(root) if k.name == "train.checkpoint"]
    assert len(checkpoints) == 2 and len(records) == 1
    assert records[0]["train.checkpoint_ms"] == pytest.approx(1e-6 * sum(c.ns for c in checkpoints))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["samples_2.pkl", "samples_4.pkl"]


# --------------------------------------------------------------------------- #
# The clocks rebased on spans keep their keys
# --------------------------------------------------------------------------- #


def test_writer_timings_are_its_spans():
    arch, params, q, eg, blk = case("arm8_3grids")
    timings = {}
    mark = _mark()
    encode_image_bitstream(from_numpy_pytree(params, "cpu"), CoolChicConfig(**arch), q, eg,
                           hls_sig_blksize=blk, timings=timings)
    assert set(timings) == {"armint_s", "entropy_s"}
    arm, coded = _after(mark, "write.armint"), _after(mark, "write.entropy")
    assert len(arm) == 3 and len(coded) == 3 + 3  # per grid; per module and per grid
    assert timings["armint_s"] == pytest.approx(1e-9 * sum(s.ns for s in arm))
    assert timings["entropy_s"] == pytest.approx(1e-9 * sum(s.ns for s in coded))


def test_video_stage_seconds_are_its_spans():
    """The video encoder's write and integer decode of a frame it
    reconstructs, here an I frame of a written case."""
    arch, params, q, eg, _ = case("arm8_3grids")
    structure = CodingStructure(0, 0)
    encoder = video_encoder.VideoEncoder(structure, CoolChicConfig(**arch), None, device="cpu")
    infos = {m: types.SimpleNamespace(q_step_w=q[m]["weight"], q_step_b=q[m]["bias"],
                                      expgol_w=eg[m]["weight"], expgol_b=eg[m]["bias"]) for m in q}
    frame = structure.get_frame_from_coding_order(0)
    stats = EncodeStats()
    mark = _mark()
    decoded, frame_bytes = encoder._integer_reconstruct(
        from_numpy_pytree(params, "cpu"), infos, frame, encoder.frame_cfg("I"), stats)
    assert decoded.shape == (3,) + arch["img_size"] and frame_bytes
    (write,), (decode,) = _after(mark, "write.frame"), _after(mark, "decode.int")
    assert set(stats.stage_seconds) == {"write", "integer_decode"}
    assert stats.stage_seconds["write"] == pytest.approx(1e-9 * write.ns)
    assert stats.stage_seconds["integer_decode"] == pytest.approx(1e-9 * decode.ns)
    assert {s.parent for s in _after(mark) if s.name.startswith("write.")} - {None} == {write.id}


def test_oneshot_timings_are_its_spans():
    from coolchic_tpu_torch.hypernet import DeltaWholeNet
    from coolchic_tpu_torch.hypernet.inference import hypernet_to_bitstream

    cfg = CoolChicConfig(img_size=(32, 32), n_ft_per_res=(1, 1, 1), dim_arm=8, n_hidden_layers_arm=1,
                         layers_synthesis=("8-1-linear-relu", "X-1-linear-none"))
    net = DeltaWholeNet(cfg, backbone_arch="resnet18", n_hidden_channels=8, synthesis_hidden_dim=16,
                        synthesis_n_layers=1, arm_hidden_dim=16, arm_n_layers=1, ups_hidden_dim=8,
                        ups_n_layers=1)
    state = net.init(0, device="cpu")
    img = torch.tensor(np.asarray(next(synthetic_batches(1, (32, 32), seed=2)))[0])
    mark = _mark()
    timings = {}
    hypernet_to_bitstream(net, state, img, 1e-3, timings=timings)
    parts = [s for s in _after(mark) if s.name.startswith("oneshot.")]
    assert [p.name for p in parts] == ["oneshot.delta_search", "oneshot.quantize", "oneshot.write"]
    assert set(timings) == {"delta_search_s", "quantize_s", "write_s"}
    for key, p in zip(("delta_search_s", "quantize_s", "write_s"), parts):
        assert timings[key] == pytest.approx(1e-9 * p.ns)
    assert {s.parent for s in _after(mark) if s.name.startswith("write.")} == {parts[2].id}


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_under_a_device_only_profiler_and_in_no_event(cuda):
    """Under CUDA activity alone the span knows it is profiled, enters none
    of the profiler's events (host or device), and the kernels it enqueued
    and waited for start inside it: the device's timestamps share its clock."""
    x = torch.randn(2048, 2048, device=cuda)
    x @ x
    torch.cuda.synchronize(cuda)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with trace.span("device.work") as s:
            for _ in range(4):
                x @ x
            torch.cuda.synchronize(cuda)
    events = list(prof.profiler.kineto_results.events())
    assert s.under_profiler
    assert not any(e.name() == "device.work" for e in events)
    kernels = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA
               and e.duration_ns() > 0]
    assert len(kernels) >= 4
    for e in kernels:
        assert s.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= s.end_ns


@pytest.mark.cuda
def test_oneshot_synchronises_only_for_timings(cuda, monkeypatch):
    from coolchic_tpu_torch.hypernet import DeltaWholeNet
    from coolchic_tpu_torch.hypernet.inference import hypernet_to_bitstream

    cfg = CoolChicConfig(img_size=(32, 32), n_ft_per_res=(1, 1, 1), dim_arm=8, n_hidden_layers_arm=1,
                         layers_synthesis=("8-1-linear-relu", "X-1-linear-none"))
    net = DeltaWholeNet(cfg, backbone_arch="resnet18", n_hidden_channels=8)
    state = net.init(0, device=cuda)
    img = torch.rand((3, 32, 32), generator=torch.Generator().manual_seed(1)).to(cuda)
    real, calls = torch.cuda.synchronize, []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: (calls.append(a), real(*a, **k)))
    plain, _ = hypernet_to_bitstream(net, state, img, 1e-3)
    assert calls == []
    timings = {}
    timed, _ = hypernet_to_bitstream(net, state, img, 1e-3, timings=timings)
    assert len(calls) == 3 and timed == plain and set(timings) == {"delta_search_s", "quantize_s", "write_s"}


@pytest.mark.cuda
def test_no_synchronise_on_the_card(cuda, monkeypatch):
    """``run_phase_batch`` and ``train_wholenet`` on the card, with
    everything they call, never synchronise the device: the host waits only
    in the validations' reads."""
    real, calls = torch.cuda.synchronize, []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: (calls.append(a), real(*a, **k)))
    mark, logs = _phase_run(device=cuda)
    assert len(_after(mark, "phase.step")) == logs.n_batched_steps
    mark, logs = _train_run(device=cuda)
    assert len(_after(mark, "train.step")) == 4 and len(logs) == 2
    assert calls == []
