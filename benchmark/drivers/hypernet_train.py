"""Training the delta whole net (the amortized encoder): chained chunks of
``coolchic_tpu_torch/hypernet/training.py::train_wholenet``.

Set-up draws the hypernet's and the shared decoder's weights from the seed
(shapes read from the program's module on the meta device) and drives the
window's own entry, ``train_wholenet``, from them through the traffic's
``check_steps`` first steps (``n_samples`` = ``check_steps`` batches, one
validation at the end), with its own noise seed, on batches that all differ.
A spy reads each step's loss, the first clipped gradient (from Adam's first
moment) and the state after each step as the entry's loop runs them; the
entry returns the state after the last, which is the window's start. The
window runs chunks of ``chunk_samples`` samples, each from the previous
chunk's best, on the continuing host batch stream, until ``--seconds`` have
passed. The check runs the plain reference over the same steps, with the
entry's schedule (cosine LR on the run's sample clock) and its noise (step i
drawn from the generator keyed by the seed and i), and evaluates the last
chunk's best state on the held-out batch to judge its validation metrics.

Adam's first step moves every parameter by about lr times the sign of its
gradient, so the few whose gradient is near zero move one way here and the
other way in the reference, and the resnet18's ReLU and max-pool switches turn
on such differences: two runs of the three steps apart drift by that alone,
more on some seeds than on others. So the step-1 loss (before any update) is
compared, and the parameters' change over the steps is compared with the
reference's change over the same steps, each step taken from the state that
the program had reached before it (the first from the start, which the first
gradient and the step-1 loss check by themselves), by the median leaf (the
worst leaf's gap still swings with the switches). The independent steps'
losses and change are printed as readings. The validation's loss moves when a
latent near a rounding boundary rounds the other way, which the program's
layer norms and GELU (torch's fused kernels) and the reference's written-out
ones can each cause: its limit comes from a fault, not from TF32.
"""

from __future__ import annotations

import math
import sys
import time
from types import SimpleNamespace

import torch

from benchmark.harness.compare import leaf_norm_gap, moving_leaves, rel_gap, tf32
from benchmark.harness.core import sub_seed
from benchmark.harness.data import TimedIterator, synthetic_batches
from benchmark.harness.inputs import keyed_noise_draws
from benchmark.harness.program import decoder_config
from benchmark.harness.spy import spy
from benchmark.reference import coolchic as cc
from benchmark.reference import hypernet as ref
from coolchic_tpu_torch.hypernet import DeltaWholeNet, WholeNetState
from coolchic_tpu_torch.hypernet import training as program
from coolchic_tpu_torch.train.presets import TrainerPhase

CHECKS = ("step_count_gap", "first_loss_gap", "grad_gap", "change_gap", "eval_loss_gap")


def _leaves(state) -> list:
    return list(state.hypernet.values()) + cc.leaves(state.decoder)


def _reading(seen, names, template):
    """A wrapper of ``make_wholenet_train_step`` whose step keeps each step's
    loss, Adam's first moment over (1 - b1) after the first (the clipped
    gradient), and the state and moments after each."""
    def wrap(real):
        def make_wholenet_train_step(*args, **kwargs):
            tx, step = real(*args, **kwargs)

            def reading_step(state, opt_state, *a, **k):
                state, opt_state, loss = step(state, opt_state, *a, **k)
                seen.losses.append(float(loss))
                if seen.first_grads is None:
                    seen.first_grads = [m.clone() / (1.0 - cc.ADAM_B1) for m in opt_state.mu]
                seen.states.append(ref.WholeNetState(names, template, _leaves(state), opt_state.mu,
                                                     opt_state.nu, opt_state.count))
                return state, opt_state, loss
            return tx, reading_step
        return make_wholenet_train_step
    return wrap


def init_hypernet(shapes, head_std: float, generator, device):
    """The benchmark's draw of the hypernet's weights, in one call: weights
    of two or more axes N(0, 1 / fan_in), the heads' output layers N(0,
    head_std^2), norm scales 1, biases 0, ConvNeXt layer scales 1e-6."""
    big = {k: s for k, s in shapes.items() if len(s) >= 2}
    draw = torch.randn(sum(math.prod(s) for s in big.values()), generator=generator, device=device)
    last_dense = {}
    for k in shapes:
        if ".Dense_" in k:
            mlp, rest = k.split(".Dense_")
            last_dense[mlp] = max(last_dense.get(mlp, 0), int(rest.split(".")[0]))
    heads = {f"{mlp}.Dense_{i}" for mlp, i in last_dense.items()}
    out, p = {}, 0
    for k, s in shapes.items():
        if k in big:
            n = math.prod(s)
            std = head_std if k.rsplit(".", 1)[0] in heads else math.sqrt(1.0 / math.prod(s[1:]))
            out[k] = draw[p:p + n].view(s) * std
            p += n
        elif k.endswith("layer_scale"):
            out[k] = torch.full(s, 1e-6, device=device)
        elif k.endswith(".weight"):
            out[k] = torch.ones(s, device=device)
        else:
            out[k] = torch.zeros(s, device=device)
    return out


def setup(cell, device, seed: int) -> SimpleNamespace:
    t, config = cell.traffic, cell.config
    s = SimpleNamespace()
    s.cell, s.device, s.seed = cell, device, seed
    h, w = config["patch_size"]
    s.bs, s.lmbda = t["batch_size"], config["lmbda"]
    s.cfg = decoder_config(config, h, w)
    s.net = DeltaWholeNet(
        s.cfg, backbone_arch=config["backbone_arch"], mode=config["mode"],
        n_hidden_channels=config["n_hidden_channels"],
        synthesis_hidden_dim=config["synthesis_hidden_dim"], synthesis_n_layers=config["synthesis_n_layers"],
        arm_hidden_dim=config["arm_hidden_dim"], arm_n_layers=config["arm_n_layers"],
        ups_hidden_dim=config["ups_hidden_dim"], ups_n_layers=config["ups_n_layers"],
        output_activation=config["output_activation"])
    s.phase = TrainerPhase(max_itr=1, **{k: tuple(v) if isinstance(v, list) else v
                                          for k, v in config["phase"].items()})
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    shapes = {k: tuple(v.shape) for k, v in s.net.module.state_dict().items()}
    s.hyper0 = init_hypernet(shapes, t["head_output_std"], gen, device)
    dec = cc.init_params(gen, config, h, w, 1, device)
    s.decoder0 = {m: cc.image_params(dec, 0)[m] for m in ("arm", "upsampling", "synthesis")}

    data = synthetic_batches(s.bs, (h, w), sub_seed(seed, "data"))
    s.eval_imgs = torch.as_tensor(next(synthetic_batches(t["eval_batch"], (h, w), sub_seed(seed, "eval"))),
                                  device=device)
    s.marks = [("inputs", time.perf_counter())]
    # The entry's first steps, which also warm up every shape the window uses.
    k = t["check_steps"]
    s.batches = [next(data) for _ in range(k)]
    s.check_seed = sub_seed(seed, "check")
    s.seen = SimpleNamespace(losses=[], first_grads=None, states=[])
    with spy(program, "make_wholenet_train_step", _reading(s.seen, s.hyper0, s.decoder0)):
        s.state, s.check_logs = program.train_wholenet(
            s.net, WholeNetState(s.hyper0, s.decoder0), iter(s.batches), s.eval_imgs, s.lmbda, s.phase,
            s.check_seed, k * s.bs, s.bs, freq_valid_samples=k * s.bs, verbose=False)
    s.marks.append(("entry_steps", time.perf_counter()))
    s.check_leaves = _leaves(s.state)  # the window leaves the state it is given untouched
    s.data = TimedIterator(data)
    return s


def window(s: SimpleNamespace, seconds: float, tracer) -> dict:
    t = s.cell.traffic
    sync = torch.cuda.synchronize if s.device.type == "cuda" else (lambda *a: None)
    chunks = []
    start = time.perf_counter()
    while True:
        data_s0, calls0 = s.data.seconds, s.data.calls
        with tracer.window() as traced:
            t0 = time.perf_counter()
            best, logs = program.train_wholenet(
                s.net, s.state, s.data, s.eval_imgs, s.lmbda, s.phase,
                sub_seed(s.seed, "window", len(chunks)), t["chunk_samples"], s.bs,
                freq_valid_samples=t["freq_valid_samples"], verbose=False)
            sync(s.device)
            t1 = time.perf_counter()
        chunks.append({"traced": traced, "seconds": t1 - t0, "steps": s.data.calls - calls0,
                       "data_s": s.data.seconds - data_s0,
                       "finite": all(math.isfinite(l.eval_loss) for l in logs)})
        s.state, s.logs = best, logs
        if time.perf_counter() - start >= seconds and tracer.done:
            break
    window_s = time.perf_counter() - start
    untraced = [c for c in chunks if not c["traced"]]
    device_chunk = [c for c in chunks if c["traced"]][:1]
    return {
        "window_s": window_s,
        "samples": sum(c["steps"] for c in chunks) * s.bs,
        "steps": sum(c["steps"] for c in chunks),
        "untraced_s": sum(c["seconds"] for c in untraced),
        "untraced_samples": sum(c["steps"] for c in untraced) * s.bs,
        "untraced_data_s": sum(c["data_s"] for c in untraced),
        "untraced_steps": sum(c["steps"] for c in untraced),
        "traced_steps": device_chunk[0]["steps"] if device_chunk else 0,
        "attempted": len(chunks),
        "failed": sum(not c["finite"] for c in chunks),
        "patch_size": list(s.cell.config["patch_size"]),
    }


def check(s: SimpleNamespace, control=None):
    """The numbers compared, each (name, value, limit). ``control``: "tf32"
    puts the reference computed with TF32 in the program's place; "half_batch"
    the reference with half of each batch left out of the loss;
    "altered_answer" the program with its validation loss 1 % off."""
    limits = s.cell.spec["limits"]
    config = s.cell.config
    k = s.cell.traffic["check_steps"]
    best, logs = s.state, s.logs  # what the check reads of the window's last chunk
    del s.state, s.net
    grid_shapes = cc.latent_shapes(*config["patch_size"], len(config["n_ft_per_res"]))
    noises = keyed_noise_draws(grid_shapes, s.bs, k, s.check_seed, s.device)
    schedule = ref.trainer_schedule(config["phase"], s.bs, k * s.bs, k)
    batches = [torch.as_tensor(b, device=s.device) for b in s.batches]

    def readings(lower=False, frozen_rows=0):
        with tf32(lower):
            return ref.train_steps(s.hyper0, s.decoder0, batches, s.lmbda, config, schedule, noises, frozen_rows)

    def followed(states):
        """The reference's change over the steps, each step from the state
        the judged side had reached before it (the first from the start)."""
        starts = [ref.WholeNetState.initial(s.hyper0, s.decoder0)] + states[:-1]
        total = [torch.zeros_like(t) for t in starts[0].leaves]
        for start, imgs, sched, noise in zip(starts, batches, schedule, noises):
            nxt = ref.step(start, imgs, s.lmbda, config, sched, noise)[2]
            torch._foreach_add_(total, torch._foreach_sub(nxt.leaves, start.leaves))
        return total

    def evaluation(lower=False):
        with tf32(lower):
            return ref.evaluate(best.hypernet, best.decoder, s.eval_imgs, s.lmbda, config)

    r_losses, r_grads, r_states = readings()
    if control in (None, "altered_answer"):
        losses, grads, states, final = s.seen.losses, s.seen.first_grads, s.seen.states, s.check_leaves
    elif control in ("tf32", "half_batch"):
        losses, grads, states = readings(lower=control == "tf32",
                                         frozen_rows=s.bs // 2 if control == "half_batch" else 0)
        final = states[-1].leaves
    else:
        raise ValueError(f"unknown control {control!r}")
    samples = s.check_logs[-1].samples_seen if s.check_logs else 0
    step_count_gap = abs(len(s.seen.losses) - k) + abs(samples - k * s.bs) / s.bs
    if not grads:  # the spy saw no step of the entry
        values = dict.fromkeys(CHECKS, math.inf) | {"step_count_gap": float(step_count_gap)}
        return [(name, values[name], limits[name]) for name in CHECKS]
    p0 = list(s.hyper0.values()) + cc.leaves(s.decoder0)
    r_loss, _r_psnr, r_rate = evaluation()
    if control == "tf32":
        e_loss, _e_psnr, e_rate = evaluation(lower=True)
    else:
        e_loss, e_rate = logs[-1].eval_loss, logs[-1].eval_rate_bpp
    if control == "altered_answer":  # the validation's loss 1 % off where it is produced
        e_loss *= 1.01
    deltas = torch._foreach_sub(final, p0)
    r_followed = followed(states)
    r_alone = torch._foreach_sub(r_states[-1].leaves, p0)
    moving = moving_leaves(r_grads)
    values = {
        "step_count_gap": float(step_count_gap),
        "first_loss_gap": rel_gap(losses[:1], r_losses[:1]),
        "grad_gap": leaf_norm_gap(grads, r_grads),
        "change_gap": leaf_norm_gap(deltas, r_followed, moving, median=True),
        "eval_loss_gap": rel_gap([e_loss], [r_loss]),
    }
    # Read but not compared: they swing from seed to seed (see the module's docstring).
    for name, value in (("loss_gap_every_step", rel_gap(losses, r_losses)),
                        ("change_gap_alone_worst_leaf", leaf_norm_gap(deltas, r_alone, moving)),
                        ("change_gap_alone_median_leaf", leaf_norm_gap(deltas, r_alone, moving, median=True)),
                        ("change_gap_followed_worst_leaf", leaf_norm_gap(deltas, r_followed, moving)),
                        ("eval_rate_gap", rel_gap([e_rate], [r_rate]))):
        print(f"reading {name} {value!r}", file=sys.stderr)
    return [(name, values[name], limits[name]) for name in CHECKS]
