"""Amortized-encoder (whole-net) training over an image-patch stream.

Counterpart of ``coolchic_tpu/hypernet/training.py``: Adam with a cosine LR
on the global sample clock, softround temperature and noise linear in the
samples seen, one gradient clip at norm 1.0 over every leaf, periodic
evaluation with a patience-based reload of the best state, an optional
frozen backbone for the first samples, and gradient accumulation.

The optimizer is optax's ``chain(clip_by_global_norm(1.0), scale_by_adam())``
written out, not the per-image engine's (``train/step.py::clip_adam_update``
clips each image at 0.1 with a count per image): here one norm over the
hypernet and the shared decoder together (optax's clip: ``t / norm * 1.0``
only when ``norm >= 1.0``, which ``torch.nn.utils.clip_grad_norm_`` is
not), one Adam step count, then ``p -= lr * update``. Freezing the backbone
is masking its gradients with zeros before the clip, as JAX does: its Adam
moments still decay and the count is shared, so that the unfreeze carries
the optimizer state over unchanged. Accumulation is ``optax.MultiSteps``:
the running mean of k micro-batch gradients goes to the clip and Adam on
the k-th call; between those calls the parameters do not move.

The state's tensors are updated in place: the best state is a snapshot, and
the patience reload copies it back.

Data parallelism (``mesh``, ``parallel/mesh.py``) keeps the semantics of
the one-device step, as JAX's batch-sharded recipe does: every rank reads the
same batch stream and takes its rows; the noise of step i is the
one-device draw for the whole batch, sliced to the rank's rows; a rank's loss
is its rows' summed loss over the whole batch's size, and the gradients are
all-reduced (summed) in one flat bucket before the freeze mask, the clip and
Adam, which every rank then applies identically. Nothing else needs syncing:
the hypernet has no batch statistics (GroupNorm, and a LayerNorm per
position).
"""

from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from coolchic_tpu_torch.hypernet.inference import save_checkpoint
from coolchic_tpu_torch.hypernet.wholenet import WholeNetState
from coolchic_tpu_torch.params import tree_clone, tree_leaves
from coolchic_tpu_torch.train.loss import loss_function
from coolchic_tpu_torch.train.presets import TrainerPhase
from coolchic_tpu_torch.train.step import ADAM_B1, ADAM_B2, ADAM_EPS, make_generator
from coolchic_tpu_torch.utils import logging as cclog
from coolchic_tpu_torch.utils.trace import span

GRAD_CLIP_NORM = 1.0


def state_leaves(state: WholeNetState) -> List[torch.Tensor]:
    """Every trained tensor of the state: the hypernet's, then the shared
    decoder's, in a fixed order."""
    return list(state.hypernet.values()) + tree_leaves(state.decoder)


def snapshot(state: WholeNetState) -> WholeNetState:
    """Detached copies of every tensor (a state no later update touches)."""
    return WholeNetState(tree_clone(state.hypernet), tree_clone(state.decoder))


def _batch_loss(net, state, imgs, lmbda, q_noise, q_type, temp, noise, generator=None,
                mesh=None):
    """The mean over the batch of each image's RD loss. With a mesh,
    ``imgs`` are this rank's rows: the sum of their losses over the whole
    batch's size, with the whole batch's noise sliced to the rows."""
    raw_noise, n_global = None, imgs.shape[0]
    if mesh is not None:
        n_global = imgs.shape[0] * mesh.world_size
        raw_noise = _rows_of_global_noise(net.cfg, q_noise, generator, n_global, mesh,
                                          imgs.device)
    decoded, rate = net.forward(
        state,
        imgs,
        quantizer_noise_type=q_noise,
        quantizer_type=q_type,
        soft_round_temperature=temp,
        noise_parameter=noise,
        training=True,
        noise=raw_noise,
        generator=generator,
    )
    loss = loss_function(decoded, rate, imgs, lmbda).loss
    return torch.mean(loss) if mesh is None else torch.sum(loss) / n_global


def _rows_of_global_noise(cfg, q_noise, generator, n_global, mesh, device):
    """The raw draw that one device makes for a batch of ``n_global`` (one
    per latent grid, in grid order, ``models/quantizer.py::draw_noise``),
    sliced to this rank's rows; None when the quantizer draws no noise."""
    draw = {"gaussian": torch.randn, "kumaraswamy": torch.rand}.get(q_noise)
    if draw is None:
        return None
    rows = mesh.rows(n_global)
    return [draw((n_global, *shape), generator=generator, device=device)[rows]
            for shape in cfg.latent_shapes]


def _bias_correction(beta: float, count: int) -> float:
    """``1 - beta^count`` in float32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(count))


class WholeNetOptState:
    """Adam's moments and step count over every leaf of the state, and
    MultiSteps' running mean of the micro-batch gradients."""

    def __init__(self, leaves: List[torch.Tensor], grad_accumulation_steps: int):
        self.mu = [torch.zeros_like(t) for t in leaves]
        self.nu = [torch.zeros_like(t) for t in leaves]
        self.count = 0
        self.acc = [torch.zeros_like(t) for t in leaves] if grad_accumulation_steps > 1 else None
        self.mini_step = 0


class WholeNetOptimizer:
    """clip_by_global_norm(1.0) + Adam, in MultiSteps when
    ``grad_accumulation_steps > 1``."""

    def __init__(self, grad_accumulation_steps: int = 1):
        self.grad_accumulation_steps = grad_accumulation_steps

    def init(self, state: WholeNetState) -> WholeNetOptState:
        return WholeNetOptState(state_leaves(state), self.grad_accumulation_steps)

    @torch.no_grad()
    def update_(self, leaves: List[torch.Tensor], grads: List[torch.Tensor],
                opt: WholeNetOptState, lr: float) -> None:
        """One call per micro-batch: accumulate, and on the k-th call clip,
        Adam and ``p -= lr * update``, in place (``grads`` is consumed)."""
        if opt.acc is not None:
            # optax.MultiSteps' running mean: acc + (g - acc) / (n + 1).
            diff = torch._foreach_sub(grads, opt.acc)
            torch._foreach_div_(diff, float(opt.mini_step + 1))
            torch._foreach_add_(opt.acc, diff)
            if opt.mini_step < self.grad_accumulation_steps - 1:
                opt.mini_step += 1
                return
            grads = opt.acc
        # optax's clip_by_global_norm: t if norm < max, else t / norm * max.
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        keep = norm < GRAD_CLIP_NORM
        torch._foreach_div_(grads, torch.where(keep, torch.ones_like(norm), norm))
        torch._foreach_mul_(grads, torch.where(keep, torch.ones_like(norm),
                                               norm.new_tensor(GRAD_CLIP_NORM)))
        # scale_by_adam (b1 0.9, b2 0.999, eps 1e-8), one count for every leaf.
        opt.count += 1
        torch._foreach_mul_(opt.mu, ADAM_B1)
        torch._foreach_add_(opt.mu, grads, alpha=1.0 - ADAM_B1)
        torch._foreach_mul_(opt.nu, ADAM_B2)
        torch._foreach_addcmul_(opt.nu, grads, grads, value=1.0 - ADAM_B2)
        denom = torch._foreach_div(opt.nu, _bias_correction(ADAM_B2, opt.count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        update = torch._foreach_div(opt.mu, _bias_correction(ADAM_B1, opt.count))
        torch._foreach_div_(update, denom)
        torch._foreach_add_(leaves, update, alpha=-lr)
        if opt.acc is not None:
            torch._foreach_zero_(opt.acc)
            opt.mini_step = 0


def make_wholenet_train_step(
    net,
    phase: TrainerPhase,
    freeze_backbone: bool = False,
    grad_accumulation_steps: int = 1,
    mesh=None,
):
    """Build (optimizer, step) for one training phase.

    ``step(state, opt_state, imgs, lmbda, generator, lr, temp, noise)``
    updates ``state`` and ``opt_state`` in place and returns them with the
    micro-batch's loss (a tensor, not synchronised). The noise is drawn from
    ``generator``. With ``freeze_backbone`` the gradients of the hypernet's
    ``ResNet_*`` tensors are zeros (they are not computed). With
    ``grad_accumulation_steps = k > 1`` the parameters move on every k-th
    call, by the mean gradient of the last k micro-batches. With a mesh,
    ``imgs`` are this rank's rows of the batch, the loss is the rank's share
    of the batch mean, and the gradients are summed over the ranks before
    the update (see the module's docstring)."""
    tx = WholeNetOptimizer(grad_accumulation_steps)

    def step(state: WholeNetState, opt_state: WholeNetOptState, imgs, lmbda, generator,
             lr, temp, noise):
        leaves = state_leaves(state)
        frozen = [freeze_backbone and k.startswith("ResNet") for k in state.hypernet]
        frozen += [False] * (len(leaves) - len(frozen))
        trained = [t for t, f in zip(leaves, frozen) if not f]
        for t in trained:
            t.requires_grad_(True)
        try:
            loss = _batch_loss(net, state, imgs, lmbda, phase.quantizer_noise_type,
                               phase.quantizer_type, temp, noise, generator, mesh)
            computed = torch.autograd.grad(loss, trained)
        finally:
            for t in trained:
                t.requires_grad_(False)
        if mesh is not None:
            bucket = torch.cat([g.reshape(-1) for g in computed])
            dist.all_reduce(bucket, group=mesh.group)
            computed = [b.view_as(g) for b, g in zip(bucket.split([g.numel() for g in computed]),
                                                     computed)]
        computed = iter(computed)
        grads = [torch.zeros_like(t) if f else next(computed) for t, f in zip(leaves, frozen)]
        tx.update_(leaves, grads, opt_state, lr)
        return state, opt_state, loss.detach()

    return tx, step


@torch.no_grad()
def evaluate_wholenet(net, state: WholeNetState, imgs: torch.Tensor, lmbda, mesh=None) -> Dict:
    """Eval-mode metrics over a batch (one forward of its B decoders: one
    launch of the ARM-rate kernel on the card), each a 0-d tensor. With a
    mesh, ``imgs`` are this rank's rows of the eval batch and the means are
    over every rank's rows (an all-reduce of the sums), the same on every
    rank."""
    decoded, rate = net.forward(state, imgs, training=False)
    out = loss_function(decoded, rate, imgs, lmbda)
    metrics = torch.stack([out.loss, out.psnr_db, out.rate_latent_bpp])
    if mesh is None:
        means = metrics.mean(dim=1)
    else:
        sums = metrics.sum(dim=1)
        dist.all_reduce(sums, group=mesh.group)
        means = sums / (imgs.shape[0] * mesh.world_size)
    return dict(zip(("loss", "psnr_db", "rate_latent_bpp"), means))


class HypernetTrainLog(NamedTuple):
    samples_seen: int
    loss: float
    eval_loss: float
    eval_psnr_db: float
    eval_rate_bpp: float


def train_wholenet(
    net,
    state: WholeNetState,
    data_iter: Iterator[Any],
    eval_imgs: Any,
    lmbda: float,
    phase: TrainerPhase,
    seed: int,
    n_samples: int,
    batch_size: int,
    freq_valid_samples: int = 1000,
    patience_samples: Optional[int] = None,
    unfreeze_backbone_samples: int = 0,
    verbose: bool = True,
    workdir: Optional[Any] = None,
    checkpointing_freq_samples: Optional[int] = None,
    grad_accumulation_steps: int = 1,
    samples_offset: int = 0,
    mesh=None,
):
    """Train for ``n_samples`` images with periodic evaluation and the
    patience reload of the best state, on the device of ``state`` (which is
    left untouched).

    Args:
        data_iter: yields [B, 3, H, W] batches in [0, 1] (numpy arrays or
            tensors).
        eval_imgs: held-out [B_eval, 3, H, W] batch.
        seed: the noise of step i is drawn from
            ``make_generator(device, seed, i)``, i counted from the start of
            the run, also across a resume.
        unfreeze_backbone_samples: keep the backbone frozen until this many
            samples have been seen.
        workdir / checkpointing_freq_samples: write ``samples_{N}.pkl``
            checkpoints every N samples during the run.
        samples_offset: samples already seen by a resumed run. ``n_samples``
            stays the total: the step count covers the remainder, the data
            stream and the noise skip the consumed prefix, and the LR,
            temperature and noise schedules and the checkpoint names continue
            on the global sample clock. The Adam moments restart at zero on
            resume (a checkpoint holds the state only, as in JAX), so expect
            a brief rise of the loss at the resume boundary.
        mesh: data parallelism over the ranks of ``parallel.launch`` (see the
            module's docstring): ``batch_size`` and the eval batch must be
            multiples of the world size; rank 0's state is broadcast first,
            and rank 0 alone writes checkpoints (the others wait for it) and
            logs. Every rank returns the same best state and logs.

    Spans (``utils/trace.py``): ``train`` (attrs ``n_samples``,
    ``batch_size``) around the call; inside it, per step, ``train.data``
    around ``next(data_iter)``, ``train.h2d`` around the batch's copy to the
    device (from pageable memory, so it waits for the steps enqueued before
    it), ``train.step`` around the step's enqueue; ``train.checkpoint``
    around each checkpoint, and ``train.validate`` around each validation
    (the evaluation, its reads, the snapshot or the reload). Each
    validation's ``cclog.log`` record also carries the host ms per step of
    ``train.data``, ``train.h2d`` and ``train.step`` since the previous one
    (``train.data_ms``, ``train.h2d_ms``, ``train.step_ms``), the host ms of
    the checkpoints since then (``train.checkpoint_ms``, 0 without) and of
    the validation itself (``train.validate_ms``).

    Returns:
        (best state, list of HypernetTrainLog).
    """
    with span("train", n_samples=n_samples, batch_size=batch_size) as root:
        device = state_leaves(state)[0].device
        state = snapshot(state)
        eval_imgs = torch.as_tensor(eval_imgs, dtype=torch.float32, device=device)
        rows, lead = slice(None), True
        if mesh is not None:
            rows, lead = mesh.rows(batch_size), mesh.rank == 0
            eval_imgs = eval_imgs[mesh.rows(eval_imgs.shape[0])]
            for t in state_leaves(state):
                dist.broadcast(t, src=0, group=mesh.group)
        verbose = verbose and lead
        n_steps = max((n_samples - samples_offset) // batch_size, 1)
        steps_done = samples_offset // batch_size
        for _ in range(steps_done):
            next(data_iter)
        freq_valid_steps = max(freq_valid_samples // batch_size, 1)
        patience_steps = max(patience_samples // batch_size, 1) if patience_samples else None

        frozen = unfreeze_backbone_samples > 0
        tx, step = make_wholenet_train_step(
            net, phase, freeze_backbone=frozen, grad_accumulation_steps=grad_accumulation_steps,
            mesh=mesh)
        opt_state = tx.init(state)

        best_state = snapshot(state)
        best_loss = float("inf")
        logs = []
        step_record = 0
        # Host time since the last validation: per step, and in checkpoints.
        host_ns = dict.fromkeys(("train.data", "train.h2d", "train.step"), 0)
        host_steps = checkpoint_ns = 0

        for i in range(n_steps):
            samples_seen = samples_offset + i * batch_size
            # The optimizer is the same either way (freezing masks gradients),
            # so its state carries over the unfreeze.
            if frozen and samples_seen >= unfreeze_backbone_samples:
                frozen = False
                _, step = make_wholenet_train_step(
                    net, phase, freeze_backbone=False,
                    grad_accumulation_steps=grad_accumulation_steps, mesh=mesh)

            frac = samples_seen / n_samples
            lr = phase.lr * 0.5 * (1 + math.cos(math.pi * frac)) if phase.schedule_lr else phase.lr
            temp = phase.softround_temperature[0] + frac * (
                phase.softround_temperature[1] - phase.softround_temperature[0])
            noise = phase.noise_parameter[0] + frac * (
                phase.noise_parameter[1] - phase.noise_parameter[0])

            with span("train.data") as data_span:
                batch = next(data_iter)[rows]
            with span("train.h2d") as h2d_span:
                imgs = torch.as_tensor(batch, dtype=torch.float32, device=device)
            with span("train.step") as step_span:
                generator = make_generator(device, seed, steps_done + i)
                state, opt_state, loss = step(state, opt_state, imgs, lmbda, generator, lr, temp, noise)
            for done in (data_span, h2d_span, step_span):
                host_ns[done.name] += done.ns
            host_steps += 1

            if workdir is not None and checkpointing_freq_samples:
                ckpt_steps = max(checkpointing_freq_samples // batch_size, 1)
                if (i + 1) % ckpt_steps == 0:
                    with span("train.checkpoint") as ckpt_span:
                        n_seen = samples_seen + batch_size
                        if lead:
                            save_checkpoint(state, Path(workdir) / f"samples_{n_seen}.pkl", n_seen)
                        if mesh is not None:
                            dist.barrier(group=mesh.group)
                    checkpoint_ns += ckpt_span.ns

            if (i + 1) % freq_valid_steps == 0 or i + 1 == n_steps:
                with span("train.validate") as validate_span:
                    if mesh is not None:  # the batch's loss from the ranks' shares
                        dist.all_reduce(loss, group=mesh.group)
                    m = {k: float(v)
                         for k, v in evaluate_wholenet(net, state, eval_imgs, lmbda, mesh).items()}
                    train_loss = float(loss)
                    eval_loss = m["loss"]
                    if eval_loss < best_loss:
                        best_loss = eval_loss
                        best_state = snapshot(state)
                        step_record = i
                    elif patience_steps and i - step_record > patience_steps:
                        torch._foreach_copy_(state_leaves(state), state_leaves(best_state))
                        step_record = i
                logs.append(
                    HypernetTrainLog(
                        samples_seen=samples_seen + batch_size,
                        loss=train_loss,
                        eval_loss=eval_loss,
                        eval_psnr_db=m["psnr_db"],
                        eval_rate_bpp=m["rate_latent_bpp"],
                    )
                )
                if lead:
                    cclog.log({
                        "samples_seen": samples_seen + batch_size,
                        "train_loss": train_loss,
                        "eval_loss": eval_loss,
                        "eval_psnr_db": m["psnr_db"],
                        "eval_rate_bpp": m["rate_latent_bpp"],
                        "lr": float(lr),
                        "softround_temperature": float(temp),
                        "noise_parameter": float(noise),
                        **{f"{name}_ms": 1e-6 * ns / host_steps for name, ns in host_ns.items()},
                        "train.checkpoint_ms": 1e-6 * checkpoint_ns,
                        "train.validate_ms": 1e-6 * validate_span.ns,
                    }, step=samples_seen + batch_size)
                host_ns = dict.fromkeys(host_ns, 0)
                host_steps = checkpoint_ns = 0
                if verbose:
                    print(
                        f"samples {samples_seen + batch_size:>8} | "
                        f"train loss {train_loss:.5f} | eval loss {eval_loss:.5f} | "
                        f"psnr {m['psnr_db']:6.2f} dB | "
                        f"bpp {m['rate_latent_bpp']:.4f} | "
                        f"{1e-9 * (time.time_ns() - root.start_ns):6.1f} s"
                    )

    return best_state, logs
