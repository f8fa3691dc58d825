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

On a CUDA device, without a mesh and without accumulation, the step runs as
one CUDA graph: the forward, ``torch.autograd.grad``, the clip and Adam,
captured once per process for each net, device, batch shape, quantizer,
freeze flag and lambda (``_GraphSlot``) and replayed for every later step.
The graph reads and writes tensors of its own: the state's leaves, Adam's
moments, the batch, the step's raw quantizer noise (drawn eagerly from the
step's generator into them, in the forward's order) and the step's scalars
(lr, softround temperature, noise parameter, Adam's bias corrections: 0-d
tensors that the host fills before each replay). ``train_wholenet`` trains
those leaves and moments in place, from a copy of its caller's state, and the
next batch is made on the host while a replay runs. The first step of a new
graph runs eagerly on a side stream (cuDNN's and cuBLAS's lazy set-up, the
allocator), the second is captured and replayed; a capture that fails
raises. Eagerly, the step runs the same code, with the same 0-d scalars.

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
import weakref
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
# How the steps of a train step ran: captured into a CUDA graph (and then
# replayed), replayed (every graphed step, the captured ones included), or
# eagerly. ``WholeNetOptimizer.counts``; the ``train`` span's attributes.
STEP_COUNTS = ("graph_captures", "graph_replays", "eager_steps")


def state_leaves(state: WholeNetState) -> List[torch.Tensor]:
    """Every trained tensor of the state: the hypernet's, then the shared
    decoder's, in a fixed order."""
    return list(state.hypernet.values()) + tree_leaves(state.decoder)


def snapshot(state: WholeNetState) -> WholeNetState:
    """Detached copies of every tensor (a state no later update touches)."""
    return WholeNetState(tree_clone(state.hypernet), tree_clone(state.decoder))


def _batch_loss(net, state, imgs, lmbda, q_noise, q_type, temp, noise, generator=None,
                mesh=None, raw_noise=None):
    """The mean over the batch of each image's RD loss, the quantizer's noise
    drawn from ``generator`` in the forward, or given (``raw_noise``, as
    ``draw_raw_noise`` makes it). With a mesh, ``imgs`` are this rank's rows:
    the sum of their losses over the whole batch's size, with the whole
    batch's noise sliced to the rows."""
    n_global = imgs.shape[0]
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


def draw_raw_noise(cfg, q_noise, generator, n, device, out=None):
    """The raw quantizer noise of a training forward of ``n`` images: one
    draw per latent grid, in grid order, the numbers that
    ``models/quantizer.py::draw_noise`` draws inside the forward from the
    same generator; into the tensors ``out`` when given. None when the
    quantizer draws no noise."""
    draw = {"gaussian": torch.randn, "kumaraswamy": torch.rand}.get(q_noise)
    if draw is None:
        return None
    if out is None:
        return [draw((n, *shape), generator=generator, device=device) for shape in cfg.latent_shapes]
    for t in out:
        draw(t.shape, generator=generator, out=t)
    return out


def _rows_of_global_noise(cfg, q_noise, generator, n_global, mesh, device):
    """The raw draw that one device makes for a batch of ``n_global``,
    sliced to this rank's rows; None when the quantizer draws no noise."""
    raw = draw_raw_noise(cfg, q_noise, generator, n_global, device)
    rows = mesh.rows(n_global)
    return None if raw is None else [r[rows] for r in raw]


def _bias_correction(beta: float, count: int) -> float:
    """``1 - beta^count`` in float32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(count))


def _scalar(value, device) -> torch.Tensor:
    """``value`` as a 0-d float32 tensor on ``device`` (a fill there, no
    copy from the host); a tensor as it is."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.full((), value, dtype=torch.float32, device=device)


class WholeNetOptState:
    """Adam's moments and step count over every leaf of the state, and
    MultiSteps' running mean of the micro-batch gradients."""

    def __init__(self, leaves: List[torch.Tensor], grad_accumulation_steps: int):
        self.mu = [torch.zeros_like(t) for t in leaves]
        self.nu = [torch.zeros_like(t) for t in leaves]
        self.count = 0
        self.acc = [torch.zeros_like(t) for t in leaves] if grad_accumulation_steps > 1 else None
        self.mini_step = 0

    def reset_(self) -> None:
        """Back to the start: zero moments (and running mean), count 0."""
        torch._foreach_zero_(self.mu + self.nu + (self.acc or []))
        self.count = self.mini_step = 0


class WholeNetOptimizer:
    """clip_by_global_norm(1.0) + Adam, in MultiSteps when
    ``grad_accumulation_steps > 1``. ``counts``: the steps made with it by
    ``make_wholenet_train_step``'s step, by how they ran (``STEP_COUNTS``)."""

    def __init__(self, grad_accumulation_steps: int = 1):
        self.grad_accumulation_steps = grad_accumulation_steps
        self.counts = dict.fromkeys(STEP_COUNTS, 0)

    def init(self, state: WholeNetState) -> WholeNetOptState:
        return WholeNetOptState(state_leaves(state), self.grad_accumulation_steps)

    @torch.no_grad()
    def update_(self, leaves: List[torch.Tensor], grads: List[torch.Tensor],
                opt: WholeNetOptState, lr: float | torch.Tensor) -> None:
        """One call per micro-batch: accumulate, and on the k-th call clip,
        Adam and ``p -= lr * update`` (``apply_``), in place (``grads`` is
        consumed)."""
        if opt.acc is not None:
            # optax.MultiSteps' running mean: acc + (g - acc) / (n + 1).
            diff = torch._foreach_sub(grads, opt.acc)
            torch._foreach_div_(diff, float(opt.mini_step + 1))
            torch._foreach_add_(opt.acc, diff)
            if opt.mini_step < self.grad_accumulation_steps - 1:
                opt.mini_step += 1
                return
            grads = opt.acc
        opt.count += 1  # one Adam count for every leaf
        device = leaves[0].device
        self.apply_(leaves, grads, opt, _scalar(lr, device),
                    *(_scalar(_bias_correction(b, opt.count), device) for b in (ADAM_B1, ADAM_B2)))
        if opt.acc is not None:
            torch._foreach_zero_(opt.acc)
            opt.mini_step = 0

    @torch.no_grad()
    def apply_(self, leaves: List[torch.Tensor], grads: List[torch.Tensor], opt: WholeNetOptState,
               lr: torch.Tensor, bias1: torch.Tensor, bias2: torch.Tensor) -> None:
        """The clip, Adam's moments and ``p -= lr * update`` of Adam's step
        ``opt.count``, in place, with no value read from the host: ``lr``
        and ``bias1`` / ``bias2`` (``1 - b^count`` of b1 and b2) are 0-d
        tensors on the device, so that a CUDA graph can hold the call."""
        # optax's clip_by_global_norm: t if norm < max, else t / norm * max.
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        keep = norm < GRAD_CLIP_NORM
        torch._foreach_div_(grads, torch.where(keep, torch.ones_like(norm), norm))
        torch._foreach_mul_(grads, torch.where(keep, torch.ones_like(norm),
                                               torch.full_like(norm, GRAD_CLIP_NORM)))
        # scale_by_adam (b1 0.9, b2 0.999, eps 1e-8).
        torch._foreach_mul_(opt.mu, ADAM_B1)
        torch._foreach_add_(opt.mu, grads, alpha=1.0 - ADAM_B1)
        torch._foreach_mul_(opt.nu, ADAM_B2)
        torch._foreach_addcmul_(opt.nu, grads, grads, value=1.0 - ADAM_B2)
        denom = torch._foreach_div(opt.nu, bias2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        update = torch._foreach_div(opt.mu, bias1)
        torch._foreach_div_(update, denom)
        torch._foreach_mul_(update, lr)
        torch._foreach_sub_(leaves, update)


def _graphed(device: torch.device, mesh, grad_accumulation_steps: int) -> bool:
    """Whether the step runs as a CUDA graph: on a CUDA device, without a
    mesh (its all-reduce) and without accumulation (MultiSteps' branch on
    the host)."""
    return device.type == "cuda" and mesh is None and grad_accumulation_steps == 1


class _Capture:
    """On one device: the side stream that every graph of the step warms up
    and is captured on, and the graphs alive there, whose memory pool a new
    capture shares. The graphs of several nets or keys in one process then
    take the memory of one: none runs while another does, and each one's
    loss is read right after its own replay."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.graphs: "weakref.WeakSet[torch.cuda.CUDAGraph]" = weakref.WeakSet()

    def pool(self):
        """A live graph's pool; None (a new pool) when none is alive: a pool
        whose graphs are all gone cannot take a capture again."""
        live = next(iter(self.graphs), None)
        return None if live is None else live.pool()


_CAPTURES: Dict[torch.device, _Capture] = {}


class _StepGraph:
    """One graph of the step: its batch, its raw noise and its loss (static
    tensors, made at its first step), and the captured graph."""

    def __init__(self):
        self.imgs = self.noise = self.loss = self.graph = None
        self.warmed = False

    def run(self, body, capture: _Capture, counts: Dict[str, int]) -> torch.Tensor:
        """One step: a replay once captured; before that, the first step
        eagerly on the capture's stream (the warm-up), the next captured on
        it, then replayed. ``body()`` runs the step on the static tensors and
        returns its loss. Returns the loss, a tensor of its own."""
        if self.graph is not None:
            self.graph.replay()
            counts["graph_replays"] += 1
            return self.loss.clone()
        stream = capture.stream
        current = torch.cuda.current_stream(stream.device)
        stream.wait_stream(current)
        if not self.warmed:
            with torch.cuda.stream(stream):
                loss = body()
            current.wait_stream(stream)
            loss.record_stream(current)
            self.warmed = True
            counts["eager_steps"] += 1
            return loss
        # torch.cuda.graph() would synchronise the device first; nothing here needs it.
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=capture.pool())
            try:
                self.loss = body()
            finally:
                graph.capture_end()
        self.graph = graph
        capture.graphs.add(graph)
        counts["graph_captures"] += 1
        return self.run(body, capture, counts)


class _GraphSlot:
    """The tensors that the CUDA graphs of one net's step on one device read
    and write in place: the state's leaves (``state``), Adam's moments
    (``opt``) and the step's scalars (lr, temperature, noise parameter and
    Adam's two bias corrections, 0-d); the graphs by what they hold fixed
    (batch shape and dtype, quantizer noise type and quantizer type, freeze
    flag, lambda), and its device's ``_Capture``."""

    def __init__(self, state: WholeNetState):
        self.state = snapshot(state)
        self.leaves = state_leaves(self.state)
        self.opt = WholeNetOptState(self.leaves, 1)
        device = self.leaves[0].device
        self.scalars = [torch.zeros((), device=device) for _ in range(5)]
        self.graphs: Dict[tuple, _StepGraph] = {}
        if device not in _CAPTURES:
            _CAPTURES[device] = _Capture(device)
        self.capture = _CAPTURES[device]


# By net, held weakly: a net that is dropped frees its graphs.
_SLOTS: "weakref.WeakKeyDictionary[Any, Dict[tuple, _GraphSlot]]" = weakref.WeakKeyDictionary()


def _graph_slot(net, state: WholeNetState) -> _GraphSlot:
    """The net's slot for states of this one's device, names and shapes,
    made at first use."""
    leaves = state_leaves(state)
    key = (leaves[0].device, tuple(state.hypernet), tuple((t.shape, t.dtype) for t in leaves))
    slots = _SLOTS.setdefault(net, {})
    if key not in slots:
        slots[key] = _GraphSlot(state)
    return slots[key]


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
    the update (see the module's docstring).

    On a CUDA device without a mesh or accumulation the step is a CUDA
    graph's (see the module's docstring): given the slot's own state and
    moments (``train_wholenet``) it copies only the batch in; given others,
    it copies them in and the results back. ``tx.counts`` counts the steps
    by how they ran."""
    tx = WholeNetOptimizer(grad_accumulation_steps)
    q_noise, q_type = phase.quantizer_noise_type, phase.quantizer_type

    def loss_and_grads(state, imgs, lmbda, temp, noise, generator=None, raw_noise=None):
        leaves = state_leaves(state)
        frozen = [freeze_backbone and k.startswith("ResNet") for k in state.hypernet]
        frozen += [False] * (len(leaves) - len(frozen))
        trained = [t for t, f in zip(leaves, frozen) if not f]
        for t in trained:
            t.requires_grad_(True)
        try:
            loss = _batch_loss(net, state, imgs, lmbda, q_noise, q_type, temp, noise, generator,
                               mesh, raw_noise)
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
        return loss.detach(), grads

    def eager(state, opt_state, imgs, lmbda, generator, lr, temp, noise):
        device = imgs.device
        loss, grads = loss_and_grads(state, imgs, lmbda, _scalar(temp, device),
                                     _scalar(noise, device), generator)
        tx.update_(state_leaves(state), grads, opt_state, lr)
        tx.counts["eager_steps"] += 1
        return state, opt_state, loss

    def graphed(state, opt_state, imgs, lmbda, generator, lr, temp, noise):
        slot = _graph_slot(net, state)
        if state is not slot.state:
            torch._foreach_copy_(slot.leaves, state_leaves(state))
        if opt_state is not slot.opt:
            torch._foreach_copy_(slot.opt.mu + slot.opt.nu, opt_state.mu + opt_state.nu)
        key = (imgs.shape, imgs.dtype, q_noise, q_type, freeze_backbone, float(lmbda))
        g = slot.graphs.setdefault(key, _StepGraph())
        if g.imgs is None:
            g.imgs = imgs.clone(memory_format=torch.contiguous_format)
        else:
            g.imgs.copy_(imgs)
        g.noise = draw_raw_noise(net.cfg, q_noise, generator, imgs.shape[0], imgs.device, g.noise)
        opt_state.count += 1
        for t, v in zip(slot.scalars, (lr, temp, noise, _bias_correction(ADAM_B1, opt_state.count),
                                       _bias_correction(ADAM_B2, opt_state.count))):
            t.fill_(v)

        def body():
            lr_t, temp_t, noise_t, bias1, bias2 = slot.scalars
            loss, grads = loss_and_grads(slot.state, g.imgs, lmbda, temp_t, noise_t,
                                         raw_noise=g.noise)
            tx.apply_(slot.leaves, grads, slot.opt, lr_t, bias1, bias2)
            return loss

        loss = g.run(body, slot.capture, tx.counts)
        if state is not slot.state:
            torch._foreach_copy_(state_leaves(state), slot.leaves)
        if opt_state is not slot.opt:
            torch._foreach_copy_(opt_state.mu + opt_state.nu, slot.opt.mu + slot.opt.nu)
        return state, opt_state, loss

    def step(state: WholeNetState, opt_state: WholeNetOptState, imgs, lmbda, generator,
             lr, temp, noise):
        device = next(iter(state.hypernet.values())).device
        run = graphed if _graphed(device, mesh, grad_accumulation_steps) else eager
        return run(state, opt_state, imgs, lmbda, generator, lr, temp, noise)

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
    ``batch_size``, and at its end the call's steps by how they ran:
    ``graph_captures``, ``graph_replays``, ``eager_steps``) around the call;
    inside it, per step, ``train.data`` around ``next(data_iter)``,
    ``train.h2d`` around the batch's copy to the device (from pageable
    memory, so it waits for the steps enqueued before it), ``train.step``
    around the step's enqueue; ``train.checkpoint`` around each checkpoint,
    and ``train.validate`` around each validation (the evaluation, its
    reads, the snapshot or the reload). Each validation's ``cclog.log``
    record also carries the host ms per step of ``train.data``,
    ``train.h2d`` and ``train.step`` since the previous one
    (``train.data_ms``, ``train.h2d_ms``, ``train.step_ms``), the host ms of
    the checkpoints since then (``train.checkpoint_ms``, 0 without) and of
    the validation itself (``train.validate_ms``), and the steps since then
    by how they ran (``graph_captures``, ``graph_replays``,
    ``eager_steps``).

    Where the step is a CUDA graph's (the module's docstring), the call
    trains the graphs' own state and moments in place, set to ``state`` and
    zero at its start; else a snapshot of ``state`` and fresh moments.

    Returns:
        (best state, list of HypernetTrainLog).
    """
    with span("train", n_samples=n_samples, batch_size=batch_size) as root:
        device = state_leaves(state)[0].device
        if _graphed(device, mesh, grad_accumulation_steps):
            slot = _graph_slot(net, state)
            torch._foreach_copy_(slot.leaves, state_leaves(state))
            slot.opt.reset_()
            state, opt_state = slot.state, slot.opt
        else:
            state, opt_state = snapshot(state), None
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
        txs = [tx]
        if opt_state is None:
            opt_state = tx.init(state)

        def step_counts():
            return {k: sum(t.counts[k] for t in txs) for k in STEP_COUNTS}

        best_state = snapshot(state)
        best_loss = float("inf")
        logs = []
        step_record = 0
        # Host time since the last validation: per step, and in checkpoints.
        host_ns = dict.fromkeys(("train.data", "train.h2d", "train.step"), 0)
        host_steps = checkpoint_ns = 0
        counted = step_counts()

        for i in range(n_steps):
            samples_seen = samples_offset + i * batch_size
            # The optimizer is the same either way (freezing masks gradients),
            # so its state carries over the unfreeze.
            if frozen and samples_seen >= unfreeze_backbone_samples:
                frozen = False
                tx, step = make_wholenet_train_step(
                    net, phase, freeze_backbone=False,
                    grad_accumulation_steps=grad_accumulation_steps, mesh=mesh)
                txs.append(tx)

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
                counts = step_counts()
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
                        **{k: counts[k] - counted[k] for k in STEP_COUNTS},
                    }, step=samples_seen + batch_size)
                host_ns = dict.fromkeys(host_ns, 0)
                host_steps = checkpoint_ns = 0
                counted = counts
                if verbose:
                    print(
                        f"samples {samples_seen + batch_size:>8} | "
                        f"train loss {train_loss:.5f} | eval loss {eval_loss:.5f} | "
                        f"psnr {m['psnr_db']:6.2f} dB | "
                        f"bpp {m['rate_latent_bpp']:.4f} | "
                        f"{1e-9 * (time.time_ns() - root.start_ns):6.1f} s"
                    )
        root.attrs.update(step_counts())

    return best_state, logs
