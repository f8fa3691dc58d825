"""Post-training quantization of the decoder networks: RD grid search.

Counterpart of ``coolchic_tpu/train/quantize_model.py`` (the hypernet delta
search waits). For each module sent to the decoder (arm, synthesis,
upsampling, greedily in that order), every (q_step_weight, q_step_bias) pair
of ``Q_STEPS`` is tried with one eval forward, and the pair minimizing
``MSE + lmbda * (R_latent + R_nn) / n_pixels`` wins; R_nn uses the best
exp-Golomb order per parameter family. Pairs run one after another; the
losses stay on the device until the module's argmin.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from coolchic_tpu_torch.models.coolchic import frame_forward
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.train.loss import loss_function

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
    """Bits to code integer symbols ``v`` with exp-Golomb order c, for every
    c in 0..12 at once. Returns [13]."""
    counts = torch.as_tensor(EXP_GOL_COUNTS, dtype=torch.float32, device=v.device)
    av = torch.abs(v)[:, None]
    nbins = 2.0 * torch.floor(torch.log2(av / 2.0**counts + 1.0)) + counts + 1.0 + (av != 0)
    return torch.sum(nbins, dim=0)


class ModuleQuantInfo(NamedTuple):
    q_step_w: float  # chosen weight q-step
    q_step_b: float  # chosen bias q-step (1.0 when the module has no biases)
    expgol_w: int  # exp-Golomb order of the weights
    expgol_b: int  # exp-Golomb order of the biases
    rate_bits: float  # module rate with those choices


def quantize_leaves(leaves: List[torch.Tensor], q_step: float):
    """round(p / q) * q per leaf, the integer symbols, and whether every
    symbol fits the 16-bit range."""
    q_leaves, ints = [], []
    valid = torch.ones((), dtype=torch.bool, device=leaves[0].device)
    for p in leaves:
        sent = torch.round(p / q_step)
        valid = valid & (torch.max(torch.abs(sent)) <= MAX_AC_MAX_VAL)
        q_leaves.append(sent * q_step)
        ints.append(sent.reshape(-1))
    return q_leaves, torch.cat(ints), valid


@torch.no_grad()
def quantize_module(
    params: Params,
    module: str,
    target: torch.Tensor,
    lmbda: float,
    cfg: CoolChicConfig,
    other_nn_rate_bits: float,
) -> Tuple[Params, ModuleQuantInfo, int]:
    """RD-search the (q_step_w, q_step_b) grid of one module. Returns the
    params with that module quantized, the choice, and the number of eval
    forwards run."""
    w_steps = np.asarray(Q_STEPS[module]["weight"], np.float32)
    b_steps = np.asarray(Q_STEPS[module]["bias"], np.float32)
    weights, biases = module_leaves(params, module)
    has_bias = len(biases) > 0
    if not has_bias:
        b_steps = np.array([1.0], np.float32)
    pair_w, pair_b = np.meshgrid(w_steps, b_steps, indexing="ij")
    pairs = list(zip(pair_w.reshape(-1).tolist(), pair_b.reshape(-1).tolist()))

    losses, rates, cnts_w, cnts_b = [], [], [], []
    for dw, db in pairs:
        qw, int_w, valid = quantize_leaves(weights, dw)
        bits_w_all = expgol_bits_all_counts(int_w)
        bits_w, cnt_w = torch.min(bits_w_all), torch.argmin(bits_w_all)
        qb = []
        bits_b = torch.zeros((), device=target.device)
        cnt_b = torch.zeros((), dtype=torch.long, device=target.device)
        if has_bias:
            qb, int_b, valid_b = quantize_leaves(biases, db)
            valid = valid & valid_b
            bits_b_all = expgol_bits_all_counts(int_b)
            bits_b, cnt_b = torch.min(bits_b_all), torch.argmin(bits_b_all)

        trial = rebuild_module(params, module, qw, qb)
        decoded, rate, _ = frame_forward(trial, cfg, training=False)
        nn_bits = bits_w + bits_b + other_nn_rate_bits
        loss = loss_function(decoded, rate, target, lmbda, nn_bits).loss
        losses.append(torch.where(valid, loss, torch.full_like(loss, float("inf"))))
        rates.append(bits_w + bits_b)
        cnts_w.append(cnt_w)
        cnts_b.append(cnt_b)

    best = int(torch.argmin(torch.stack(losses)).item())
    dw, db = pairs[best]
    qw, _, _ = quantize_leaves(weights, dw)
    qb = quantize_leaves(biases, db)[0] if has_bias else []
    info = ModuleQuantInfo(
        q_step_w=dw,
        q_step_b=db,
        expgol_w=int(cnts_w[best].item()),
        expgol_b=int(cnts_b[best].item()),
        rate_bits=float(rates[best].item()),
    )
    return rebuild_module(params, module, qw, qb), info, len(pairs)


def quantize_model_with_info(
    params: Params, target: torch.Tensor, lmbda: float, cfg: CoolChicConfig
) -> Tuple[Params, Dict[str, ModuleQuantInfo], int]:
    """Quantize arm, synthesis, then upsampling greedily. Returns the
    quantized params, the per-module choices, and the eval forwards run."""
    infos: Dict[str, ModuleQuantInfo] = {}
    other_rate = 0.0
    n_evals = 0
    for module in MODULES_TO_SEND:
        params, info, n = quantize_module(params, module, target, lmbda, cfg, other_rate)
        infos[module] = info
        other_rate += info.rate_bits
        n_evals += n
    return params, infos, n_evals
