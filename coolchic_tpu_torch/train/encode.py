"""Frame encoding pipeline: warm-up competition, preset phases, NN quantization.

Counterpart of ``coolchic_tpu/train/encode.py`` (``encode_frame_batch``
waits for the batched slice). Warm-up candidates train one after another.
"""

from __future__ import annotations

import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from coolchic_tpu_torch.models.coolchic import init_coolchic_params
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.train.presets import Preset, Warmup
from coolchic_tpu_torch.train.quantize_model import ModuleQuantInfo, quantize_model_with_info
from coolchic_tpu_torch.train.step import eval_metrics, make_generator, run_phase

Params = Dict[str, Any]


class EncodeStats:
    """Work done by one encode: eval forwards, optimizer steps and the wall
    time of each stage (synchronised with the device at stage ends)."""

    def __init__(self):
        self.n_eval_forwards = 0
        self.n_train_steps = 0
        self.stage_seconds: Dict[str, float] = {}
        self._t0 = 0.0

    def start(self, device: torch.device) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self._t0 = time.perf_counter()

    def stop(self, device: torch.device, stage: str) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.stage_seconds[stage] = time.perf_counter() - self._t0


def warmup(
    target: torch.Tensor,
    lmbda: float,
    cfg: CoolChicConfig,
    warmup_cfg: Warmup,
    seed: int = 0,
    stats: Optional[EncodeStats] = None,
) -> Params:
    """Start ``phases[0].candidates`` random decoders, train each for every
    warm-up phase, keep the best ``candidates`` of the next phase, and
    return the winner."""
    device = target.device
    if not warmup_cfg.phases:
        return init_coolchic_params(make_generator(device, seed, 0), cfg, device)
    n0 = warmup_cfg.phases[0].candidates
    cand = [init_coolchic_params(make_generator(device, seed, 0, i), cfg, device) for i in range(n0)]
    losses = None
    for idx_phase, wp in enumerate(warmup_cfg.phases):
        if idx_phase != 0:
            order = sorted(range(len(losses)), key=losses.__getitem__)[: wp.candidates]
            cand = [cand[i] for i in order]
        trained, losses = [], []
        for i, params in enumerate(cand[: wp.candidates]):
            gen = make_generator(device, seed, idx_phase + 1, i)
            params, logs = run_phase(params, target, lmbda, cfg, wp.training_phase, gen)
            trained.append(params)
            losses.append(logs.loss)
            if stats is not None:
                stats.n_eval_forwards += logs.n_eval_forwards
                stats.n_train_steps += logs.n_train_steps
        cand = trained
    return cand[min(range(len(losses)), key=losses.__getitem__)]


class EncodeResult(NamedTuple):
    params: Params
    loss: float
    psnr_db: float
    rate_latent_bpp: float
    stats: EncodeStats


def encode_frame_with_quant_info(
    target: torch.Tensor,
    lmbda: float,
    cfg: CoolChicConfig,
    preset: Preset,
    seed: int = 0,
) -> Tuple[EncodeResult, Optional[Dict[str, ModuleQuantInfo]]]:
    """Warm-up, then every preset phase; after a phase flagged
    ``quantize_model``, the NN-quantization search. ``target`` is [3, H, W]
    in [0, 1] on the device the encode runs on.

    Returns (EncodeResult, infos): infos holds the q-steps and exp-Golomb
    orders per module that the bitstream writer needs, or None when the
    preset never quantizes the networks.
    """
    device = target.device
    stats = EncodeStats()
    stats.start(device)
    params = warmup(target, lmbda, cfg, preset.warmup, seed, stats)
    stats.stop(device, "warmup")
    logs = None
    infos = None
    for idx, phase in enumerate(preset.all_phases):
        stats.start(device)
        gen = make_generator(device, seed, 1000 + idx)
        params, logs = run_phase(params, target, lmbda, cfg, phase, gen)
        stats.n_eval_forwards += logs.n_eval_forwards
        stats.n_train_steps += logs.n_train_steps
        stats.stop(device, f"phase_{idx}")
        if phase.quantize_model:
            stats.start(device)
            params, infos, n_evals = quantize_model_with_info(params, target, lmbda, cfg)
            stats.n_eval_forwards += n_evals
            stats.stop(device, f"quantize_model_{idx}")
    if logs is None:
        m = eval_metrics(params, cfg, target, lmbda)
        stats.n_eval_forwards += 1
        loss, psnr, bpp = m.loss.item(), m.psnr_db.item(), m.rate_latent_bpp.item()
    else:
        loss, psnr, bpp = logs.loss, logs.psnr_db, logs.rate_latent_bpp
    return EncodeResult(params, loss, psnr, bpp, stats), infos
