"""Post-training quantization of the decoder networks: RD grid search.

Counterpart of ``coolchic_tpu/train/quantize_model.py`` and of its ``vmap``
over images. For each module sent to the decoder (arm, synthesis, upsampling,
greedily in that order), every (q_step_weight, q_step_bias) pair of
``Q_STEPS`` is tried with one eval forward, and the pair minimizing
``MSE + lmbda * (R_latent + R_nn) / n_pixels`` wins; R_nn uses the best
exp-Golomb order per parameter family. The search runs on a batch of B
decoders (every leaf with a leading [B] axis): the grid of pairs is shared,
one eval forward tries a pair on all B, and the argmin is per image (the
first minimum, in the pair order of the JAX package). Pairs run one after
another; the losses stay on the device until the module's argmin. One image
is the batch of one. A P / B frame's targets carry its references
(``train/step.py::split_target``).

The hypernet's half (``quantize_model_deltas``) searches the same grid over
the leaves of a predicted weight delta instead: the decoder tried is the
shared base plus the deltas with that module quantized, and the rate counts
the delta's symbols (what a receiver holding the base would pay).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from coolchic_tpu_torch.models.coolchic import coolchic_forward_latents, frame_forward
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.params import tree_map
from coolchic_tpu_torch.train.loss import loss_function
from coolchic_tpu_torch.train.step import row_views, split_target

Params = Dict

MAX_AC_MAX_VAL = 65535  # 16-bit header field

# Possible quantization steps per module (format constants).
Q_STEPS: Dict[str, Dict[str, np.ndarray]] = {
    "arm": {
        "weight": 2.0 ** np.linspace(-8, 0, 9),
        "bias": 2.0 ** np.linspace(-16, 0, 17),
    },
    "upsampling": {
        "weight": 2.0 ** np.linspace(-12, 0, 13),
        "bias": np.array([1.0]),
    },
    "synthesis": {
        "weight": 2.0 ** np.linspace(-12, 0, 13),
        "bias": 2.0 ** np.linspace(-24, 0, 25),
    },
}
EXP_GOL_COUNTS = np.arange(13)

MODULES_TO_SEND = ("arm", "synthesis", "upsampling")


def module_leaves(params: Params, module: str) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(weights, biases) of a module; the upsampling half kernels count as
    weights and the module has no biases."""
    m = params[module]
    if module == "upsampling":
        return list(m["ups"]) + list(m["preconcat"]), []
    return [layer["weight"] for layer in m["layers"]], [layer["bias"] for layer in m["layers"]]


def rebuild_module(params: Params, module: str, weights, biases) -> Params:
    new = dict(params)
    if module == "upsampling":
        n_ups = len(params[module]["ups"])
        new[module] = {"ups": list(weights[:n_ups]), "preconcat": list(weights[n_ups:])}
    else:
        new[module] = {"layers": [{"weight": w, "bias": b} for w, b in zip(weights, biases)]}
    return new


def expgol_bits_all_counts(v: torch.Tensor) -> torch.Tensor:
    """Bits to code integer symbols ``v`` ([..., N]) with exp-Golomb order c,
    for every c in 0..12 at once. Returns [..., 13]."""
    counts = torch.as_tensor(EXP_GOL_COUNTS, dtype=torch.float32, device=v.device)
    av = torch.abs(v)[..., None]
    nbins = 2.0 * torch.floor(torch.log2(av / 2.0**counts + 1.0)) + counts + 1.0 + (av != 0)
    return torch.sum(nbins, dim=-2)


class ModuleQuantInfo(NamedTuple):
    q_step_w: float  # chosen weight q-step
    q_step_b: float  # chosen bias q-step (1.0 when the module has no biases)
    expgol_w: int  # exp-Golomb order of the weights
    expgol_b: int  # exp-Golomb order of the biases
    rate_bits: float  # module rate with those choices


def quantize_leaves(leaves: List[torch.Tensor], q_step: torch.Tensor):
    """round(p / q) * q per [B, ...] leaf with one ``q_step`` per image (a [B]
    tensor), the integer symbols [B, N], and per image whether every symbol
    fits the 16-bit range. The step is always a tensor: a CUDA division by a
    Python number multiplies by its reciprocal instead, which rounds some
    symbols the other way, and the trial of a pair and the winner's
    re-quantization must give the same symbols."""
    q_leaves, ints = [], []
    for p, q in zip(leaves, row_views(q_step, leaves)):
        sent = torch.round(p / q)
        q_leaves.append(sent * q)
        ints.append(sent.flatten(1))
    ints = torch.cat(ints, dim=1)
    return q_leaves, ints, torch.amax(torch.abs(ints), dim=1) <= MAX_AC_MAX_VAL


def _search_module(
    tree: Params,
    module: str,
    evaluate: Callable[[Params, torch.Tensor], torch.Tensor],
    other_nn_rate_bits: torch.Tensor,
) -> Tuple[Params, List[ModuleQuantInfo], int]:
    """The grid search of one module over the [B]-stacked leaves of ``tree``
    (decoders, or deltas). ``evaluate(trial, nn_bits)`` gives the [B] eval
    losses of ``tree`` with the module's leaves replaced by a trial pair's.
    Returns ``tree`` with the module quantized (each image at its own pair),
    the choice per image, and the number of batched eval forwards."""
    weights, biases = module_leaves(tree, module)
    device = weights[0].device
    w_steps = np.asarray(Q_STEPS[module]["weight"], np.float32)
    b_steps = np.asarray(Q_STEPS[module]["bias"], np.float32)
    has_bias = len(biases) > 0
    if not has_bias:
        b_steps = np.array([1.0], np.float32)
    pair_w, pair_b = np.meshgrid(w_steps, b_steps, indexing="ij")
    pair_w, pair_b = pair_w.reshape(-1), pair_b.reshape(-1)

    n_images = weights[0].shape[0]
    zeros = torch.zeros(n_images, device=device)
    steps_w = torch.as_tensor(pair_w, device=device)[:, None].repeat(1, n_images)  # [pairs, B]
    steps_b = torch.as_tensor(pair_b, device=device)[:, None].repeat(1, n_images)
    losses, rates, cnts_w, cnts_b = [], [], [], []
    for dw, db in zip(steps_w, steps_b):
        qw, int_w, valid = quantize_leaves(weights, dw)
        bits_w, cnt_w = torch.min(expgol_bits_all_counts(int_w), dim=-1)
        qb, bits_b, cnt_b = [], zeros, zeros.long()
        if has_bias:
            qb, int_b, valid_b = quantize_leaves(biases, db)
            valid = valid & valid_b
            bits_b, cnt_b = torch.min(expgol_bits_all_counts(int_b), dim=-1)

        loss = evaluate(rebuild_module(tree, module, qw, qb), bits_w + bits_b + other_nn_rate_bits)
        losses.append(torch.where(valid, loss, torch.full_like(loss, float("inf"))))
        rates.append(bits_w + bits_b)
        cnts_w.append(cnt_w)
        cnts_b.append(cnt_b)

    best = torch.argmin(torch.stack(losses), dim=0)  # [B]: each image's pair
    picked = torch.stack([torch.stack(x).gather(0, best[None])[0].double()
                          for x in (rates, cnts_w, cnts_b)]).cpu()
    best = best.cpu().numpy()
    dw, db = pair_w[best], pair_b[best]
    qw, _, _ = quantize_leaves(weights, torch.as_tensor(dw, device=device))
    qb = quantize_leaves(biases, torch.as_tensor(db, device=device))[0] if has_bias else []
    infos = [
        ModuleQuantInfo(
            q_step_w=float(dw[b]),
            q_step_b=float(db[b]),
            expgol_w=int(picked[1, b]),
            expgol_b=int(picked[2, b]),
            rate_bits=float(picked[0, b]),
        )
        for b in range(len(best))
    ]
    return rebuild_module(tree, module, qw, qb), infos, len(pair_w)


@torch.no_grad()
def quantize_module(
    params: Params,
    module: str,
    targets: torch.Tensor,
    lmbdas: torch.Tensor,
    cfg: CoolChicConfig,
    other_nn_rate_bits: torch.Tensor,
    valid_hws: Optional[torch.Tensor] = None,
) -> Tuple[Params, List[ModuleQuantInfo], int]:
    """RD-search the (q_step_w, q_step_b) grid of one module of B decoders.
    Returns the params with that module quantized (each image at its own
    pair), the choice per image, and the number of batched eval forwards."""
    targets, refs = split_target(cfg, targets)

    def evaluate(trial: Params, nn_bits: torch.Tensor) -> torch.Tensor:
        decoded, rate, _ = frame_forward(trial, cfg, training=False, valid_hw=valid_hws, refs=refs)
        return loss_function(decoded, rate, targets, lmbdas, nn_bits, valid_hw=valid_hws).loss

    return _search_module(params, module, evaluate, other_nn_rate_bits)


def quantize_model_batch(
    params: Params,
    targets: torch.Tensor,
    lmbdas: torch.Tensor | Sequence[float],
    cfg: CoolChicConfig,
    valid_hws: Optional[torch.Tensor] = None,
) -> Tuple[Params, List[Dict[str, ModuleQuantInfo]], int]:
    """Quantize arm, synthesis, then upsampling of B decoders greedily.
    Returns the quantized stacked params, the per-module choices of each
    image, and the batched eval forwards run."""
    n_images = targets.shape[0]
    lmbdas = torch.as_tensor(lmbdas, dtype=torch.float32, device=targets.device)
    infos: List[Dict[str, ModuleQuantInfo]] = [{} for _ in range(n_images)]
    other_rate = torch.zeros(n_images, device=targets.device)
    n_evals = 0
    for module in MODULES_TO_SEND:
        params, module_infos, n = quantize_module(
            params, module, targets, lmbdas, cfg, other_rate, valid_hws)
        for image_infos, info in zip(infos, module_infos):
            image_infos[module] = info
        other_rate = other_rate + torch.tensor(
            [info.rate_bits for info in module_infos], device=targets.device)
        n_evals += n
    return params, infos, n_evals


def quantize_model_with_info(
    params: Params, target: torch.Tensor, lmbda: float, cfg: CoolChicConfig,
    valid_hw: Optional[torch.Tensor] = None,
) -> Tuple[Params, Dict[str, ModuleQuantInfo], int]:
    """``quantize_model_batch`` on one image: the quantized params, the
    per-module choices, and the eval forwards run."""
    params, infos, n_evals = quantize_model_batch(
        tree_map(lambda t: t[None], params), target[None], [lmbda], cfg,
        None if valid_hw is None else valid_hw[None])
    return tree_map(lambda t: t[0], params), infos[0], n_evals


def total_nn_rate_bits(infos: Dict[str, ModuleQuantInfo]) -> float:
    return sum(info.rate_bits for info in infos.values())


# --------------------------------------------------------------------------- #
# Hypernet-predicted weight DELTAS: quantize what would be transmitted.
# --------------------------------------------------------------------------- #
def _combine_nets(base: Params, deltas: Dict[str, Params]) -> Params:
    """decoder = shared base + per-image deltas, per module (a base leaf
    broadcasts against a delta with a leading [B] axis)."""
    return {m: tree_map(torch.add, base[m], deltas[m]) for m in base}


@torch.no_grad()
def quantize_delta_module(
    base: Params,
    deltas: Dict[str, Params],
    module: str,
    latents: Sequence[torch.Tensor],
    target: torch.Tensor,
    lmbda: float,
    cfg: CoolChicConfig,
    other_nn_rate_bits: float | torch.Tensor,
) -> Tuple[Dict[str, Params], ModuleQuantInfo]:
    """RD-search the (q_step_w, q_step_b) grid over one module's DELTA
    leaves of one image; the decoder evaluated is base + (deltas with this
    module quantized). ``latents`` are [C, h, w] grids in the forward's
    convention (``coolchic_forward_latents``), ``target`` is [3, H, W].
    Every trial is an eval forward of a batch of one (one kernel launch)."""
    device = target.device
    lmbdas = torch.tensor([lmbda], dtype=torch.float32, device=device)
    latents_b = [y[None] for y in latents]

    def evaluate(trial: Params, nn_bits: torch.Tensor) -> torch.Tensor:
        decoded, rate, _ = coolchic_forward_latents(
            _combine_nets(base, trial), latents_b, cfg, training=False)
        return loss_function(decoded, rate, target[None], lmbdas, nn_bits).loss

    other = torch.as_tensor(other_nn_rate_bits, dtype=torch.float32, device=device).reshape(1)
    new, infos, _ = _search_module(tree_map(lambda t: t[None], deltas), module, evaluate, other)
    return tree_map(lambda t: t[0], new), infos[0]


def quantize_model_deltas(
    base: Params,
    deltas: Dict[str, Params],
    latents: Sequence[torch.Tensor],
    target: torch.Tensor,
    lmbda: float,
    cfg: CoolChicConfig,
) -> Tuple[Dict[str, Params], Dict[str, ModuleQuantInfo]]:
    """Quantize the hypernet-predicted weight deltas of one image greedily
    per module (arm, synthesis, upsampling), measuring the rate on the delta
    symbols, so that a hypernet output is costed as the shared base decoder
    plus quantized deltas.

    Args:
        base: shared decoder nets (arm / upsampling / synthesis, no latents).
        deltas: per-module deltas, same structure as ``base``.
        latents: the image's latent grids, list of [C, h, w].
        target: [3, H, W] image.

    Returns:
        (quantized deltas, per-module ModuleQuantInfo).
    """
    infos: Dict[str, ModuleQuantInfo] = {}
    other_rate = torch.zeros((), device=target.device)
    for module in MODULES_TO_SEND:
        deltas, info = quantize_delta_module(
            base, deltas, module, latents, target, lmbda, cfg, other_rate)
        infos[module] = info
        other_rate = other_rate + info.rate_bits
    return deltas, infos
