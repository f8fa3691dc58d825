"""Overfitting engine: one training phase of a batch of decoders as a Python
loop.

Counterpart of ``coolchic_tpu/train/step.py::run_phase`` and of its ``vmap``
over images, with the same op order: a phase-initial eval, then
``max_itr // freq`` full validation blocks and a remainder block. The batch
axis is written out: every parameter leaf, Adam moment and target has a
leading [B] axis, one forward and one backward serve the B decoders
(``models/coolchic.py``), and the per-image state of the JAX engine's carry
(``best_loss``, ``best_psnr``, ``best_bpp``, ``cnt_record``, ``active``, the
Adam step count) is a set of [B] tensors kept on the host, brought up to date
from the one device-to-host copy of each validation. Each block:

  * patience, per image: once ``cnt_start - cnt_record > patience``, the
    image's rows of the params and of the optimizer state are reloaded from
    the best ones (``schedule_lr``), or the image is frozen (without
    ``schedule_lr``). Both are a ``torch.where`` over the stacked leaves with
    a [B] mask. A frozen image goes on riding the batched step, which costs
    nothing more, but can set no record and counts no step: what the phase
    returns for it is what the JAX engine's select-back gives. When every
    image is frozen the phase ends;
  * schedules stepped per block: temperature and noise are linear in
    ``max(cnt_start - 1, 0)``, the LR is a closed-form cosine;
  * ``n_steps`` optimizer steps: gradients of the modules outside
    ``optimized_module`` are zero (those tensors are simply not trained),
    clip by global norm 0.1 as optax does (scale ``0.1 / norm`` only when
    ``norm >= 0.1``), Adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0), then
    ``p -= lr * update``. The norm, the clip scale and the Adam step count
    are per image;
  * an eval-mode validation of the whole batch; a record needs
    loss < best and (delta bpp < 0.001 or delta PSNR > 0.001).

The working params are updated in place; the best params and optimizer
state are snapshots. ``run_phase`` on one image is the batch of one.
"""

from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from coolchic_tpu_torch.models.coolchic import frame_forward
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.params import tree_clone, tree_leaves, tree_map
from coolchic_tpu_torch.train.loss import LossOutput, loss_function
from coolchic_tpu_torch.train.presets import TrainerPhase
from coolchic_tpu_torch.utils.trace import span

Params = Dict[str, Any]

GRAD_CLIP_NORM = 0.1
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def make_generator(device: torch.device, *keys: int) -> torch.Generator:
    """A generator on ``device`` seeded from a tuple of integers."""
    digest = hashlib.sha256(repr(keys).encode()).digest()
    return torch.Generator(device=device).manual_seed(int.from_bytes(digest[:7], "little"))


def linear_schedule(v0: float, v1: float, t: float, t_max: float) -> float:
    return t * (v1 - v0) / t_max + v0


def cosine_lr(start_lr: float, end_lr: float, block_idx: int, n_blocks: float) -> float:
    """torch CosineAnnealingLR stepped once per validation block."""
    frac = min(block_idx, n_blocks) / n_blocks
    return end_lr + 0.5 * (start_lr - end_lr) * (1.0 + math.cos(math.pi * frac))


def phase_geometry(phase: TrainerPhase) -> Tuple[int, int, int, float]:
    """(freq, n_full_blocks, rem, n_blocks_sched) of one phase."""
    freq = min(phase.freq_valid, phase.max_itr)
    return freq, phase.max_itr // freq, phase.max_itr % freq, max(phase.max_itr / phase.freq_valid, 1)


def split_target(cfg: CoolChicConfig, target: torch.Tensor):
    """A P / B frame's target carries its decoded reference frame(s) as
    channels 3:6 (and 6:9), so that the engine keeps one ``targets``
    argument; split them off: (target [..., 3, H, W], refs or None)."""
    if cfg.frame_type == "I":
        return target, None
    if cfg.frame_type == "P":
        return target[..., :3, :, :], (target[..., 3:6, :, :],)
    return target[..., :3, :, :], (target[..., 3:6, :, :], target[..., 6:9, :, :])


@torch.no_grad()
def eval_metrics(
    params: Params, cfg: CoolChicConfig, target: torch.Tensor, lmbda: float | torch.Tensor,
    rate_nn_bits: float | torch.Tensor = 0.0, valid_hw: Optional[torch.Tensor] = None,
) -> LossOutput:
    """Eval-mode test: hardround, no noise, bitdepth rounding. One image, or
    a batch (stacked params, [B, C, H, W] targets: every metric is [B]).
    A P / B target carries its references (``split_target``)."""
    target, refs = split_target(cfg, target)
    decoded, rate, _ = frame_forward(params, cfg, training=False, valid_hw=valid_hw, refs=refs)
    return loss_function(
        decoded, rate, target, lmbda, rate_nn_bits, frame_data_type=cfg.frame_data_type,
        valid_hw=valid_hw,
    )


@torch.no_grad()
def detailed_eval_metrics(
    params: Params, cfg: CoolChicConfig, target: torch.Tensor, lmbda: float | torch.Tensor,
    rate_nn_bits: float | torch.Tensor = 0.0,
) -> Dict[str, torch.Tensor]:
    """``eval_metrics`` from the same one eval forward (one kernel launch on
    the card), plus each latent grid's rate in bpp (``latent_<i>_bpp``) and
    its share of nonzero quantized latents in % (``latent_<i>_nonzero_pct``).
    One image, or a batch: then every value is [B]."""
    target, refs = split_target(cfg, target)
    decoded, rate, extras = frame_forward(params, cfg, training=False, refs=refs)
    out = loss_function(decoded, rate, target, lmbda, rate_nn_bits,
                        frame_data_type=cfg.frame_data_type)
    per_grid_bpp, per_grid_nonzero = {}, {}
    start = 0
    for i, (c, h, w) in enumerate(cfg.latent_shapes):
        end = start + c * h * w
        per_grid_bpp[f"latent_{i}_bpp"] = rate[..., start:end].sum(-1) / cfg.n_pixels
        per_grid_nonzero[f"latent_{i}_nonzero_pct"] = 100.0 * (
            extras["flat_latent"][..., start:end] != 0).float().mean(-1)
        start = end
    return {
        "loss": out.loss,
        "psnr_db": out.psnr_db,
        "mse": out.mse,
        "rate_latent_bpp": out.rate_latent_bpp,
        "rate_nn_bpp": out.rate_nn_bpp,
        "total_rate_bpp": out.total_rate_bpp,
        **per_grid_bpp,
        **per_grid_nonzero,
    }


def row_views(rows: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """A [B] tensor viewed as [B, 1, ...] against each [B, ...] tensor of
    ``like``: one value per image, broadcast over that image's row."""
    return [rows.view(-1, *([1] * (t.dim() - 1))) for t in like]


@torch.no_grad()
def select_rows_(dst: List[torch.Tensor], rows: torch.Tensor, src: List[torch.Tensor]) -> None:
    """``dst[b] = src[b]`` for every image b of the [B] bool mask ``rows``
    (given on the host), leaf by leaf, in place."""
    for d, s, m in zip(dst, src, row_views(rows.to(dst[0].device), dst)):
        d.copy_(torch.where(m, s, d))


class AdamState:
    """Adam moments of the trained [B, ...] tensors, and each image's step
    count (a [B] integer tensor on the host)."""

    def __init__(self, mu: List[torch.Tensor], nu: List[torch.Tensor], count: torch.Tensor):
        self.mu, self.nu, self.count = mu, nu, count

    @classmethod
    def zeros(cls, tensors: List[torch.Tensor]) -> "AdamState":
        return cls([torch.zeros_like(t) for t in tensors], [torch.zeros_like(t) for t in tensors],
                   torch.zeros(tensors[0].shape[0], dtype=torch.long))

    def clone(self) -> "AdamState":
        return AdamState([m.clone() for m in self.mu], [v.clone() for v in self.nu],
                         self.count.clone())

    def select_rows_(self, rows: torch.Tensor, other: "AdamState") -> None:
        """Take the rows of ``other`` where the [B] mask ``rows`` is set."""
        select_rows_(self.mu, rows, other.mu)
        select_rows_(self.nu, rows, other.nu)
        self.count = torch.where(rows, other.count, self.count)


def _bias_correction(beta: float, count: torch.Tensor, like: List[torch.Tensor]):
    """``1 - beta^count`` per image: a float while every image has the same
    count (no image was reloaded alone), which keeps the multi-tensor
    kernels' one launch for all leaves; else row views of a [B] tensor."""
    counts = count.tolist()
    if len(set(counts)) == 1:
        return 1.0 - beta ** counts[0]
    corr = 1.0 - beta ** count.double()
    return row_views(corr.to(like[0].device, like[0].dtype), like)


@torch.no_grad()
def clip_adam_update(
    tensors: List[torch.Tensor], grads: List[torch.Tensor], opt: AdamState, lr: float
) -> None:
    """Per image (axis 0 of every tensor): global-norm clip at 0.1 over that
    image's leaves, Adam moments, ``p -= lr * update`` (in place)."""
    n_images = grads[0].shape[0]
    norm = torch.linalg.vector_norm(
        torch.cat([g.reshape(n_images, -1) for g in grads], dim=1), dim=1)
    scale = torch.where(norm < GRAD_CLIP_NORM, torch.ones_like(norm), GRAD_CLIP_NORM / norm)
    torch._foreach_mul_(grads, row_views(scale, grads))
    opt.count = opt.count + 1
    torch._foreach_mul_(opt.mu, ADAM_B1)
    torch._foreach_add_(opt.mu, grads, alpha=1.0 - ADAM_B1)
    torch._foreach_mul_(opt.nu, ADAM_B2)
    torch._foreach_addcmul_(opt.nu, grads, grads, value=1.0 - ADAM_B2)
    denom = torch._foreach_div(opt.nu, _bias_correction(ADAM_B2, opt.count, opt.nu))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, ADAM_EPS)
    update = torch._foreach_div(opt.mu, _bias_correction(ADAM_B1, opt.count, opt.mu))
    torch._foreach_div_(update, denom)
    torch._foreach_add_(tensors, update, alpha=-lr)


def train_step(
    params: Params,
    tensors: List[torch.Tensor],
    opt: AdamState,
    targets: torch.Tensor,
    lmbdas: torch.Tensor,
    cfg: CoolChicConfig,
    phase: TrainerPhase,
    lr: float,
    temperature: float,
    noise_parameter: float,
    generator: Optional[torch.Generator],
    valid_hws: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One optimizer step of every decoder of the batch on ``tensors`` (the
    leaves of the stacked ``params`` that require grad). The noise is one
    draw per grid for the whole batch. Returns the [B] training losses (not
    synchronised)."""
    targets, refs = split_target(cfg, targets)
    decoded, rate, _ = frame_forward(
        params,
        cfg,
        quantizer_noise_type=phase.quantizer_noise_type,
        quantizer_type=phase.quantizer_type,
        soft_round_temperature=temperature,
        noise_parameter=noise_parameter,
        training=True,
        generator=generator,
        valid_hw=valid_hws,
        refs=refs,
    )
    loss = loss_function(decoded, rate, targets, lmbdas, frame_data_type=cfg.frame_data_type,
                         valid_hw=valid_hws).loss
    # Image b's parameters reach only loss[b]: the sum's gradient is each image's own.
    grads = list(torch.autograd.grad(loss.sum(), tensors))
    clip_adam_update(tensors, grads, opt, lr)
    return loss.detach()


class BatchPhaseLogs(NamedTuple):
    loss: torch.Tensor  # [B], on the host, like the two below
    psnr_db: torch.Tensor
    rate_latent_bpp: torch.Tensor
    n_eval_forwards: int  # batched eval-mode forwards (each of B images)
    n_batched_steps: int  # batched optimizer steps
    n_train_steps: torch.Tensor  # [B] optimizer steps of each image while it was active


class PhaseLogs(NamedTuple):
    loss: float
    psnr_db: float
    rate_latent_bpp: float
    n_eval_forwards: int  # eval-mode forwards run by the phase
    n_train_steps: int  # optimizer steps run by the phase


def trained_tensors(params: Params, optimized_module: Tuple[str, ...]) -> List[torch.Tensor]:
    select_all = "all" in optimized_module
    return [
        leaf
        for module, sub in params.items()
        if select_all or module in optimized_module
        for leaf in tree_leaves(sub)
    ]


def run_phase_batch(
    params: Params,
    targets: torch.Tensor,
    lmbdas: torch.Tensor | Sequence[float],
    cfg: CoolChicConfig,
    phase: TrainerPhase,
    generator: Optional[torch.Generator] = None,
    valid_hws: Optional[torch.Tensor] = None,
) -> Tuple[Params, BatchPhaseLogs]:
    """Train B decoders (``params`` with a leading [B] axis on every leaf) on
    ``targets`` ([B, C, H, W] in [0, 1]; a P / B frame's with its references
    as further channels, ``split_target``) for one phase, image b at rate weight
    ``lmbdas[b]`` and, with ``valid_hws`` ([B, 2]), at its true size inside
    the buffer. Returns the best params seen per image (eval-mode loss) and
    their metrics; the input params are left untouched. The host waits for
    the device once per validation.

    Spans (``utils/trace.py``): ``phase`` (attrs ``images``, ``max_itr``)
    around the call; inside it ``phase.step`` around each ``train_step``
    call (the host's enqueue of one batched step, with any wait for room in
    the launch queue), ``phase.validate`` around each validation, holding
    ``phase.wait`` around its device-to-host copy alone (the wait for every
    step enqueued before it). The record bookkeeping between them (the first
    snapshot, the patience reloads, the record selections) is the root's
    own time."""
    with span("phase", images=targets.shape[0], max_itr=phase.max_itr):
        freq, n_full_blocks, rem, n_blocks_sched = phase_geometry(phase)
        device = targets.device
        n_images = targets.shape[0]
        lmbdas = torch.as_tensor(lmbdas, dtype=torch.float32, device=device)
        params = tree_clone(params)
        leaves = tree_leaves(params)
        tensors = trained_tensors(params, phase.optimized_module)
        opt = AdamState.zeros(tensors)

        def validate() -> torch.Tensor:
            with span("phase.validate"):
                m = eval_metrics(params, cfg, targets, lmbdas, valid_hw=valid_hws)
                metrics = torch.stack([m.loss, m.psnr_db, m.rate_latent_bpp])
                with span("phase.wait"):
                    return metrics.cpu()

        best = validate()  # [3, B]: loss, PSNR, bpp of each image's record
        best_params, best_opt = tree_clone(params), opt.clone()
        best_leaves = tree_leaves(best_params)
        cnt_record = torch.zeros(n_images, dtype=torch.long)
        active = torch.ones(n_images, dtype=torch.bool)
        n_train_steps = torch.zeros(n_images, dtype=torch.long)
        n_evals, n_batched_steps = 1, 0

        blocks = [(b, freq) for b in range(n_full_blocks)] + ([(n_full_blocks, rem)] if rem else [])
        for t in tensors:
            t.requires_grad_(True)
        for block_idx, n_steps in blocks:
            cnt_start = block_idx * freq
            over_patience = (cnt_start - cnt_record) > phase.patience
            if phase.schedule_lr:
                if bool(over_patience.any()):
                    select_rows_(leaves, over_patience, best_leaves)
                    opt.select_rows_(over_patience, best_opt)
                    cnt_record = torch.where(over_patience, cnt_start, cnt_record)
            else:
                active = active & ~over_patience
                if not bool(active.any()):
                    break

            sched_t = max(cnt_start - 1, 0)
            temperature = linear_schedule(*phase.softround_temperature, sched_t, phase.max_itr)
            noise_parameter = linear_schedule(*phase.noise_parameter, sched_t, phase.max_itr)
            if phase.schedule_lr:
                lr = cosine_lr(phase.lr, phase.end_lr, block_idx, n_blocks_sched)
            else:
                lr = phase.lr
            for _ in range(n_steps):
                with span("phase.step"):
                    train_step(params, tensors, opt, targets, lmbdas, cfg, phase, lr,
                               temperature, noise_parameter, generator, valid_hws)
            n_batched_steps += n_steps
            n_train_steps += n_steps * active

            m = validate()
            n_evals += 1
            significant = ((m[2] - best[2]) < 0.001) | ((m[1] - best[1]) > 0.001)
            new_record = active & (m[0] < best[0]) & significant
            if bool(new_record.any()):
                select_rows_(best_leaves, new_record, leaves)
                best_opt.select_rows_(new_record, opt)
                best = torch.where(new_record, m, best)
                cnt_record = torch.where(new_record, cnt_start + n_steps - 1, cnt_record)
        for t in tensors:
            t.requires_grad_(False)
    return best_params, BatchPhaseLogs(best[0], best[1], best[2], n_evals, n_batched_steps,
                                       n_train_steps)


def run_phase(
    params: Params,
    target: torch.Tensor,
    lmbda: float,
    cfg: CoolChicConfig,
    phase: TrainerPhase,
    generator: Optional[torch.Generator] = None,
    valid_hw: Optional[torch.Tensor] = None,
) -> Tuple[Params, PhaseLogs]:
    """Train ``params`` on ``target`` ([C, H, W] in [0, 1]) for one phase: the
    batch of one. Returns the best params seen (eval-mode loss) and their
    metrics; the input params are left untouched."""
    best, logs = run_phase_batch(
        tree_map(lambda t: t[None], params), target[None], [lmbda], cfg, phase, generator,
        None if valid_hw is None else valid_hw[None])
    return tree_map(lambda t: t[0], best), PhaseLogs(
        logs.loss.item(), logs.psnr_db.item(), logs.rate_latent_bpp.item(),
        logs.n_eval_forwards, int(logs.n_train_steps.item()))
