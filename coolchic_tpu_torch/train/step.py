"""Per-image overfitting engine: one training phase as a Python loop.

Counterpart of ``coolchic_tpu/train/step.py::run_phase`` with the same op
order: a phase-initial eval, then ``max_itr // freq`` full validation blocks
and a remainder block. Each block:

  * patience: once ``cnt_start - cnt_record > patience``, reload the best
    params and optimizer state (``schedule_lr``) or end the phase (without
    ``schedule_lr``; the JAX engine freezes instead, with the same result);
  * schedules stepped per block: temperature and noise are linear in
    ``max(cnt_start - 1, 0)``, the LR is a closed-form cosine;
  * ``n_steps`` optimizer steps: gradients of the modules outside
    ``optimized_module`` are zero (those tensors are simply not trained),
    clip by global norm 0.1 as optax does (scale ``0.1 / norm`` only when
    ``norm >= 0.1``), Adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0), then
    ``p -= lr * update``;
  * an eval-mode validation; a record needs loss < best and
    (delta bpp < 0.001 or delta PSNR > 0.001).

The working params are updated in place; the best params and optimizer
state are snapshots taken with ``clone()``.
"""

from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from coolchic_tpu_torch.models.coolchic import frame_forward
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.params import tree_clone, tree_leaves
from coolchic_tpu_torch.train.loss import LossOutput, loss_function
from coolchic_tpu_torch.train.presets import TrainerPhase

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


@torch.no_grad()
def eval_metrics(
    params: Params, cfg: CoolChicConfig, target: torch.Tensor, lmbda: float,
    rate_nn_bits: float | torch.Tensor = 0.0,
) -> LossOutput:
    """Eval-mode test: hardround, no noise, bitdepth rounding."""
    decoded, rate, _ = frame_forward(params, cfg, training=False)
    return loss_function(
        decoded, rate, target, lmbda, rate_nn_bits, frame_data_type=cfg.frame_data_type
    )


class AdamState:
    """Adam moments of the trained tensors plus the step count."""

    def __init__(self, mu: List[torch.Tensor], nu: List[torch.Tensor], count: int):
        self.mu, self.nu, self.count = mu, nu, count

    @classmethod
    def zeros(cls, tensors: List[torch.Tensor]) -> "AdamState":
        return cls([torch.zeros_like(t) for t in tensors], [torch.zeros_like(t) for t in tensors], 0)

    def clone(self) -> "AdamState":
        return AdamState([m.clone() for m in self.mu], [v.clone() for v in self.nu], self.count)

    def copy_(self, other: "AdamState") -> None:
        torch._foreach_copy_(self.mu, other.mu)
        torch._foreach_copy_(self.nu, other.nu)
        self.count = other.count


@torch.no_grad()
def clip_adam_update(
    tensors: List[torch.Tensor], grads: List[torch.Tensor], opt: AdamState, lr: float
) -> None:
    """Global-norm clip at 0.1, Adam moments, ``p -= lr * update`` (in place)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < GRAD_CLIP_NORM, torch.ones_like(norm), GRAD_CLIP_NORM / norm)
    torch._foreach_mul_(grads, scale)
    opt.count += 1
    torch._foreach_mul_(opt.mu, ADAM_B1)
    torch._foreach_add_(opt.mu, grads, alpha=1.0 - ADAM_B1)
    torch._foreach_mul_(opt.nu, ADAM_B2)
    torch._foreach_addcmul_(opt.nu, grads, grads, value=1.0 - ADAM_B2)
    denom = torch._foreach_div(opt.nu, 1.0 - ADAM_B2**opt.count)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, ADAM_EPS)
    update = torch._foreach_div(opt.mu, 1.0 - ADAM_B1**opt.count)
    torch._foreach_div_(update, denom)
    torch._foreach_add_(tensors, update, alpha=-lr)


def train_step(
    params: Params,
    tensors: List[torch.Tensor],
    opt: AdamState,
    target: torch.Tensor,
    lmbda: float,
    cfg: CoolChicConfig,
    phase: TrainerPhase,
    lr: float,
    temperature: float,
    noise_parameter: float,
    generator: Optional[torch.Generator],
) -> torch.Tensor:
    """One optimizer step on ``tensors`` (leaves of ``params`` that require
    grad). Returns the training loss (not synchronised)."""
    decoded, rate, _ = frame_forward(
        params,
        cfg,
        quantizer_noise_type=phase.quantizer_noise_type,
        quantizer_type=phase.quantizer_type,
        soft_round_temperature=temperature,
        noise_parameter=noise_parameter,
        training=True,
        generator=generator,
    )
    loss = loss_function(decoded, rate, target, lmbda, frame_data_type=cfg.frame_data_type).loss
    grads = list(torch.autograd.grad(loss, tensors))
    clip_adam_update(tensors, grads, opt, lr)
    return loss.detach()


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


def run_phase(
    params: Params,
    target: torch.Tensor,
    lmbda: float,
    cfg: CoolChicConfig,
    phase: TrainerPhase,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Params, PhaseLogs]:
    """Train ``params`` on ``target`` ([C, H, W] in [0, 1]) for one phase.
    Returns the best params seen (eval-mode loss) and their metrics; the
    input params are left untouched."""
    freq, n_full_blocks, rem, n_blocks_sched = phase_geometry(phase)
    params = tree_clone(params)
    tensors = trained_tensors(params, phase.optimized_module)
    opt = AdamState.zeros(tensors)

    m0 = eval_metrics(params, cfg, target, lmbda)
    best_params, best_opt = tree_clone(params), opt.clone()
    best = (m0.loss.item(), m0.psnr_db.item(), m0.rate_latent_bpp.item())
    cnt_record = 0
    n_evals, n_steps_done = 1, 0

    blocks = [(b, freq) for b in range(n_full_blocks)] + ([(n_full_blocks, rem)] if rem else [])
    for t in tensors:
        t.requires_grad_(True)
    for block_idx, n_steps in blocks:
        cnt_start = block_idx * freq
        if cnt_start - cnt_record > phase.patience:
            if not phase.schedule_lr:
                break
            with torch.no_grad():
                torch._foreach_copy_(tree_leaves(params), tree_leaves(best_params))
            opt.copy_(best_opt)
            cnt_record = cnt_start

        sched_t = max(cnt_start - 1, 0)
        temperature = linear_schedule(*phase.softround_temperature, sched_t, phase.max_itr)
        noise_parameter = linear_schedule(*phase.noise_parameter, sched_t, phase.max_itr)
        if phase.schedule_lr:
            lr = cosine_lr(phase.lr, phase.end_lr, block_idx, n_blocks_sched)
        else:
            lr = phase.lr
        for _ in range(n_steps):
            train_step(params, tensors, opt, target, lmbda, cfg, phase, lr,
                       temperature, noise_parameter, generator)
        n_steps_done += n_steps

        m = eval_metrics(params, cfg, target, lmbda)
        n_evals += 1
        loss, psnr, bpp = m.loss.item(), m.psnr_db.item(), m.rate_latent_bpp.item()
        significant = (bpp - best[2]) < 0.001 or (psnr - best[1]) > 0.001
        if loss < best[0] and significant:
            best_params, best_opt = tree_clone(params), opt.clone()
            best = (loss, psnr, bpp)
            cnt_record = cnt_start + n_steps - 1
    for t in tensors:
        t.requires_grad_(False)
    return best_params, PhaseLogs(*best, n_evals, n_steps_done)
