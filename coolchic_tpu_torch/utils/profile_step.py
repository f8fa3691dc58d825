"""Where the time of one training step and one eval forward goes, on a GPU.

    python -m coolchic_tpu_torch.utils.profile_step [--frame_type I|P|B]
        [--img_size HxW] [--hypernet | --hypernet_train] [B ...]

For each batch size B given (default: 1), builds B default decoders (arm
24,2; 40-wide synthesis; 7 grids) at 512x768 (or ``--img_size``) with random
weights (seeded), stacked, runs 20 batched training steps of the c3x first
phase (softround + gaussian noise) and as many batched eval forwards, and
prints one JSON line
per measurement: wall time per step and per eval
forward (host clock around synchronised work), then the device time by
kernel from ``torch.profiler`` over a window of as many of each (after one
unrecorded warm-up iteration of the profiler), with the share of the wall
time the device was busy. A P or B frame (``--frame_type``) synthesizes 6 or
9 channels and warps random references (float warp in the step, the
fixed-point warp in the eval forward). The eval-forward line also gives the ARM kernel's
launches as the wrapper counted them over the window beside the profiler's
count (``profile_complete``: the profiler saw every launch), and the peak
device memory of the batch size.

With ``--hypernet``: the prediction of B images by the hypernet of
``hypernet.DeltaWholeNet`` (resnet18 at the JAX package's HyperNetConfig
widths, seeded init) at the image size, no gradient: wall and device time
per prediction, by kernel and by operator (``aten::`` ops, their own device
time, so that a layer's share shows).

With ``--hypernet_train``: one train step of that whole net
(``hypernet/training.py::make_wholenet_train_step``: the training forward of
B images and their B decoders, the backward, the clip and Adam over its
21.8 M parameters) at 256x256 (or ``--img_size``), JAX's default phase
(softround + gaussian noise): wall and device time per step, kernels, busy
share, the top kernels and ``aten::`` ops of the step and of its forward
alone, and the peak device memory.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

H, W = 512, 768
STEPS = 20


def _device_table(prof, n_iter: int, top: int = 12) -> dict:
    """Device time by kernel (GPU events only, so no operator is counted
    twice, and not the schedule's ``ProfilerStep`` spans), per iteration."""
    from torch.autograd import DeviceType

    rows = [
        (evt.key, evt.self_device_time_total / n_iter / 1e3, evt.count / n_iter,
         evt.self_device_time_total / evt.count / 1e3)
        for evt in prof.key_averages()
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0
        and not evt.key.startswith("ProfilerStep")
    ]
    rows.sort(key=lambda r: -r[1])
    return {
        "device_ms_per_iter": sum(r[1] for r in rows),
        "kernels_per_iter": sum(r[2] for r in rows),
        "top": [{"name": k[:90], "ms_per_iter": ms, "calls_per_iter": c, "ms_per_call": per_call}
                for k, ms, c, per_call in rows[:top]],
        "arm_rate_calls": sum(round(r[2] * n_iter) for r in rows if "arm_rate_kernel" in r[0]),
    }


def _op_table(prof, n_iter: int, top: int = 12) -> list:
    """Device time per iteration by the ``aten::`` operator that launched it
    (each op's own kernels, not its children's)."""
    from torch.autograd import DeviceType

    rows = [(evt.key, evt.self_device_time_total / n_iter / 1e3, evt.count / n_iter)
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CPU and evt.key.startswith("aten::")
            and evt.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return [{"op": k, "ms_per_iter": ms, "calls_per_iter": c} for k, ms, c in rows[:top]]


def profile_hypernet(batch: int, img_size=(H, W), steps: int = 5) -> dict:
    """Profile the hypernet's prediction of ``batch`` images of ``img_size``
    over ``steps`` iterations; prints and returns one JSON line."""
    from coolchic_tpu_torch.hypernet import DeltaWholeNet
    from coolchic_tpu_torch.train.step import make_generator
    from coolchic_tpu_torch.utils.types import DecoderConfig

    device = torch.device("cuda")
    net = DeltaWholeNet(DecoderConfig().to_coolchic_config(img_size), backbone_arch="resnet18")
    state = net.init(0, device=device)
    imgs = torch.rand(batch, 3, *img_size, generator=make_generator(device, 0), device=device)
    torch.cuda.reset_peak_memory_stats()

    @torch.no_grad()
    def predict():
        net.predict(state, imgs)

    wall_ms, prof = _timed_profile(predict, steps)
    table = _device_table(prof, steps)
    table.pop("arm_rate_calls")
    line = {"what": "hypernet_predict", "batch": batch, "img_size": list(img_size),
            "steps": steps, "wall_ms": wall_ms,
            "device_busy_share": table["device_ms_per_iter"] / wall_ms, **table,
            "top_ops": _op_table(prof, steps),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "device": torch.cuda.get_device_name(0)}
    print(json.dumps(line), flush=True)
    return line


def _timed_profile(fn, steps: int):
    """(wall ms per call over ``steps`` synchronised calls after two warm-up
    calls, the profiler over ``steps`` more after one unrecorded call)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps, repeat=1)) as prof:
        for i in range(1 + steps):
            fn()
            if i in (0, steps):
                torch.cuda.synchronize()
            prof.step()
    return wall_ms, prof


def profile_hypernet_train(batch: int, img_size=(256, 256), steps: int = 5,
                           mode: str = "delta") -> dict:
    """Profile one train step of the full-width whole net (``mode``: "delta",
    or "no" / "small" for ``NOWholeNet`` / ``SmallDeltaWholeNet``) on
    ``batch`` images of ``img_size`` over ``steps`` steps, and its training
    forward alone; prints and returns one JSON line."""
    from coolchic_tpu_torch.hypernet import DeltaWholeNet, NOWholeNet, SmallDeltaWholeNet
    from coolchic_tpu_torch.hypernet.training import (
        _batch_loss, make_wholenet_train_step, state_leaves,
    )
    from coolchic_tpu_torch.train.presets import TrainerPhase
    from coolchic_tpu_torch.train.step import make_generator
    from coolchic_tpu_torch.utils.types import DecoderConfig

    device = torch.device("cuda")
    cfg = DecoderConfig().to_coolchic_config(img_size)
    net = {"no": NOWholeNet, "small": SmallDeltaWholeNet,
           "delta": lambda c: DeltaWholeNet(c, backbone_arch="resnet18")}[mode](cfg)
    state = net.init(0, device=device)
    leaves = state_leaves(state)
    gen = make_generator(device, 0)
    imgs = torch.rand(batch, 3, *img_size, generator=gen, device=device)
    phase = TrainerPhase(lr=1e-4, max_itr=1, schedule_lr=True, quantizer_type="softround",
                         quantizer_noise_type="gaussian", softround_temperature=(0.3, 0.3),
                         noise_parameter=(0.25, 0.25))
    tx, step = make_wholenet_train_step(net, phase)
    opt = tx.init(state)

    def train():
        step(state, opt, imgs, 1e-3, gen, phase.lr, 0.3, 0.25)

    def forward():
        for t in leaves:
            t.requires_grad_(True)
        _batch_loss(net, state, imgs, 1e-3, phase.quantizer_noise_type, phase.quantizer_type,
                    0.3, 0.25, gen)
        for t in leaves:
            t.requires_grad_(False)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall_ms, prof = _timed_profile(train, steps)
    peak = torch.cuda.max_memory_allocated()
    table = _device_table(prof, steps)
    table.pop("arm_rate_calls")
    fwd_wall_ms, fwd_prof = _timed_profile(forward, steps)
    fwd_table = _device_table(fwd_prof, steps)
    line = {"what": "hypernet_train_step", "mode": mode, "batch": batch,
            "img_size": list(img_size),
            "steps": steps, "hypernet_params": sum(t.numel() for t in state.hypernet.values()),
            "wall_ms": wall_ms, "device_busy_share": table["device_ms_per_iter"] / wall_ms,
            **table, "top_ops": _op_table(prof, steps),
            "forward": {"wall_ms": fwd_wall_ms, "device_ms_per_iter": fwd_table[
                "device_ms_per_iter"], "kernels_per_iter": fwd_table["kernels_per_iter"],
                        "top_ops": _op_table(fwd_prof, steps)},
            "max_memory_allocated_bytes": peak, "device": torch.cuda.get_device_name(0)}
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("profile_step needs a GPU", file=sys.stderr)
        return 1
    p = argparse.ArgumentParser(description="profile one train step and one eval forward")
    p.add_argument("--frame_type", choices=["I", "P", "B"], default="I")
    p.add_argument("--img_size", default=None,
                   help=f"HxW (default {H}x{W}; 256x256 with --hypernet_train)")
    what = p.add_mutually_exclusive_group()
    what.add_argument("--hypernet", action="store_true",
                      help="profile the hypernet's prediction instead")
    what.add_argument("--hypernet_train", action="store_true",
                      help="profile one train step of the hypernet instead")
    p.add_argument("batch", type=int, nargs="*")
    args = p.parse_args(argv)
    default_size = "256x256" if args.hypernet_train else f"{H}x{W}"
    img_size = tuple(int(v) for v in (args.img_size or default_size).split("x"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for batch in args.batch or [1]:
        if args.hypernet:
            profile_hypernet(batch, img_size)
        elif args.hypernet_train:
            profile_hypernet_train(batch, img_size)
        else:
            profile_batch(batch, args.frame_type, img_size)
    return 0


def profile_batch(batch: int, frame_type: str = "I", img_size=(H, W), steps: int = STEPS) -> dict:
    """Profile a batch of ``batch`` decoders of ``frame_type`` frames of
    ``img_size`` over ``steps`` iterations of each; prints one JSON line for
    the train step and one for the eval forward, and returns both by name.
    The profiler's processing grows with the kernels it saw (a P step at
    1080p launches ~16,000), so a caller short of time takes fewer steps."""
    from dataclasses import replace

    from torch.profiler import ProfilerActivity, profile, schedule

    from coolchic_tpu_torch.models.coolchic import init_coolchic_params
    from coolchic_tpu_torch.ops import arm_rate as ar
    from coolchic_tpu_torch.params import stack_params, tree_leaves
    from coolchic_tpu_torch.train.presets import load_preset
    from coolchic_tpu_torch.train.step import AdamState, eval_metrics, make_generator, train_step
    from coolchic_tpu_torch.utils.types import DecoderConfig

    device = torch.device("cuda")
    n_refs = "IPB".index(frame_type)
    cfg = DecoderConfig().to_coolchic_config(img_size, out_channels=3 * (n_refs + 1))
    cfg = replace(cfg, frame_type=frame_type)
    phase = load_preset("c3x").all_phases[0]
    gen = make_generator(device, 0)
    params = stack_params(
        [init_coolchic_params(gen, cfg, device, latent_init="normal") for _ in range(batch)])
    tensors = tree_leaves(params)
    for t in tensors:
        t.requires_grad_(True)
    opt = AdamState.zeros(tensors)
    # A P / B frame's references ride the target (train/step.py::split_target).
    target = torch.rand(batch, 3 * (n_refs + 1), *img_size, generator=gen, device=device)
    lmbdas = torch.full((batch,), 1e-3, device=device)
    torch.cuda.reset_peak_memory_stats()

    def step():
        train_step(params, tensors, opt, target, lmbdas, cfg, phase, 1e-3, 0.3, 0.25, gen)

    def evaluate():
        eval_metrics(params, cfg, target, lmbdas)

    lines = {}
    for name, fn in (("train_step", step), ("eval_forward", evaluate)):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=steps, repeat=1)) as prof:
            for i in range(1 + steps):
                if i == 1:
                    ar.launch_count = 0
                fn()
                if i in (0, steps):  # the warm-up's kernels end before the window
                    torch.cuda.synchronize()
                prof.step()
        table = _device_table(prof, steps)
        lines[name] = {
            "what": name, "batch": batch, "frame_type": frame_type, "img_size": list(img_size),
            "steps": steps, "wall_ms": wall_ms,
            "device_busy_share": table["device_ms_per_iter"] / wall_ms, **table,
            "arm_rate_launches": ar.launch_count,
            "profile_complete": table["arm_rate_calls"] == ar.launch_count,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "device": torch.cuda.get_device_name(0),
        }
        print(json.dumps(lines[name]), flush=True)
    return lines


if __name__ == "__main__":
    sys.exit(main())
