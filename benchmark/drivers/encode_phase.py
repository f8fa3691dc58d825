"""Overfitting B Cool-chic decoders: chained chunks of the first training phase
through ``coolchic_tpu_torch/train/step.py::run_phase_batch``.

Set-up makes the images and the initial decoders from the seed and drives the
window's own entry, ``run_phase_batch``, from them through its first
validation block, cut to the traffic's ``check_steps`` steps (``max_itr`` =
``freq_valid`` = ``check_steps``), with its own noise generator. A spy reads
each step's losses and the first clipped gradient (Adam's first moment after
one step) as the entry's loop runs them; the entry returns the decoders it
keeps, which are the window's start. The window then runs chunks of
``chunk_itr`` steps, each from the previous chunk's best, until ``--seconds``
have passed. The check runs the plain reference through the same block from
the same decoders and noise (validate, the steps, validate, keep the record),
and evaluates the last chunk's best decoders to judge its validation metrics.
"""

from __future__ import annotations

import math
import time
from dataclasses import replace
from types import SimpleNamespace

import torch

from benchmark.harness.compare import leaf_norm_gap, moving_leaves, rel_gap, tf32
from benchmark.harness.core import sub_seed
from benchmark.harness.inputs import noise_draws, synthetic_images
from benchmark.harness.program import decoder_config
from benchmark.harness.spy import spy
from benchmark.reference import coolchic as ref
from coolchic_tpu_torch.train import step as program
from coolchic_tpu_torch.train.presets import TrainerPhase

CHECKS = ("step_count_gap", "loss_gap", "grad_gap", "change_gap", "eval_loss_gap", "eval_rate_gap")


def _reading(seen):
    """A wrapper of ``train_step`` that keeps each step's [B] losses and,
    after the first, Adam's first moment over (1 - b1): the clipped gradient."""
    def wrap(real):
        def train_step(params, tensors, opt, *args, **kwargs):
            loss = real(params, tensors, opt, *args, **kwargs)
            seen.losses.append(loss.detach().cpu())
            if seen.first_grads is None:
                seen.first_grads = [m.detach().clone() / (1.0 - ref.ADAM_B1) for m in opt.mu]
            return loss
        return train_step
    return wrap


def setup(cell, device, seed: int) -> SimpleNamespace:
    t, config = cell.traffic, cell.config
    s = SimpleNamespace()
    s.cell, s.device, s.seed = cell, device, seed
    s.h, s.w, s.n = t["height"], t["width"], t["images"]
    s.cfg = decoder_config(config, s.h, s.w)
    s.phase = TrainerPhase.from_dict({**config["phase_1"], "max_itr": t["chunk_itr"]})
    s.targets = synthetic_images(s.n, s.h, s.w, sub_seed(seed, "images"), device)
    s.lmbdas = torch.tensor(t["lmbdas"], dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    s.params0 = ref.init_params(gen, config, s.h, s.w, s.n, device)
    s.marks = [("inputs", time.perf_counter())]

    # The entry's first block, which also warms up every shape the window uses.
    k = t["check_steps"]
    s.seen = SimpleNamespace(losses=[], first_grads=None)
    noise_gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "noise"))
    with spy(program, "train_step", _reading(s.seen)):
        s.params, s.check_logs = program.run_phase_batch(
            s.params0, s.targets, s.lmbdas, s.cfg, replace(s.phase, max_itr=k, freq_valid=k), noise_gen)
    s.marks.append(("entry_steps", time.perf_counter()))
    s.check_leaves = ref.leaves(s.params)  # the window leaves the params it is given untouched
    return s


def window(s: SimpleNamespace, seconds: float, tracer) -> dict:
    gen = torch.Generator(device=s.device).manual_seed(sub_seed(s.seed, "window"))
    sync = torch.cuda.synchronize if s.device.type == "cuda" else (lambda *a: None)
    chunks = []
    start = time.perf_counter()
    while True:
        with tracer.window() as traced:
            t0 = time.perf_counter()
            best, logs = program.run_phase_batch(s.params, s.targets, s.lmbdas, s.cfg, s.phase, gen)
            sync(s.device)
            t1 = time.perf_counter()
        chunks.append({"traced": traced, "seconds": t1 - t0,
                       "image_steps": int(logs.n_train_steps.sum()),
                       "finite": int(torch.isfinite(logs.loss).sum())})
        s.params, s.logs = best, logs
        if time.perf_counter() - start >= seconds and tracer.done:
            break
    window_s = time.perf_counter() - start
    untraced = [c for c in chunks if not c["traced"]]
    return {
        "window_s": window_s,
        "image_steps": sum(c["image_steps"] for c in chunks),
        "untraced_s": sum(c["seconds"] for c in untraced),
        "untraced_image_steps": sum(c["image_steps"] for c in untraced),
        "chunks": len(chunks),
        "attempted": len(chunks) * s.n,
        "failed": sum(s.n - c["finite"] for c in chunks),
        "height": s.h, "width": s.w, "images": s.n,
    }


def check(s: SimpleNamespace, control=None):
    """The numbers compared, each (name, value, limit). ``control``: "tf32"
    puts the reference computed with TF32 in the program's place; "half_batch"
    the reference with the second half of the batch left untrained."""
    limits = s.cell.spec["limits"]
    k = s.cell.traffic["check_steps"]
    phase = s.cell.config["phase_1"]
    shapes = [y.shape[1:] for y in s.params0["latents"]]
    noises = noise_draws(shapes, s.n, k, sub_seed(s.seed, "noise"), s.device)
    best_params, logs = s.params, s.logs  # what the check reads of the window's last chunk

    def reference_block(b, lower=False, frozen=False):
        with tf32(lower):
            return ref.first_block(s.params0, b, s.cell.config, phase, s.targets[b], float(s.lmbdas[b]),
                                   [[z[b] for z in step] for step in noises], frozen=frozen)

    def reference_eval(b, lower=False):
        with tf32(lower):
            return ref.evaluate(best_params, b, s.cell.config, s.targets[b], float(s.lmbdas[b]))

    step_count_gap = abs(len(s.seen.losses) - k) + int((s.check_logs.n_train_steps - k).abs().max())
    loss_gap = grad_gap = change_gap = eval_loss_gap = eval_rate_gap = 0.0
    for b in range(s.n):
        r_losses, r_grads, r_kept, _record = reference_block(b)
        p0 = ref.leaves(ref.image_params(s.params0, b))
        if control is None:
            losses = [float(l[b]) for l in s.seen.losses]
            grads = [g[b] for g in s.seen.first_grads] if s.seen.first_grads else None
            kept = [x[b] for x in s.check_leaves]
        elif control in ("tf32", "half_batch"):
            losses, grads, kept, _ = reference_block(
                b, lower=control == "tf32", frozen=control == "half_batch" and b >= s.n // 2)
        else:
            raise ValueError(f"unknown control {control!r}")
        loss_gap = max(loss_gap, rel_gap(losses, r_losses) if len(losses) == len(r_losses) else math.inf)
        grad_gap = max(grad_gap, leaf_norm_gap(grads, r_grads) if grads else math.inf)
        change_gap = max(change_gap, leaf_norm_gap(
            [x - x0 for x, x0 in zip(kept, p0)], [x - x0 for x, x0 in zip(r_kept, p0)],
            moving_leaves(r_grads)))

        r_loss, _r_psnr, r_rate = reference_eval(b)
        if control == "tf32":
            e_loss, _e_psnr, e_rate = reference_eval(b, lower=True)
        else:
            e_loss, e_rate = float(logs.loss[b]), float(logs.rate_latent_bpp[b])
        eval_loss_gap = max(eval_loss_gap, rel_gap([e_loss], [r_loss]))
        eval_rate_gap = max(eval_rate_gap, rel_gap([e_rate], [r_rate]))
    values = dict(zip(CHECKS, (float(step_count_gap), loss_gap, grad_gap, change_gap, eval_loss_gap,
                               eval_rate_gap)))
    return [(name, values[name], limits[name]) for name in CHECKS]
