"""Frame encoding pipeline: warm-up competition, preset phases, NN quantization.

Counterpart of ``coolchic_tpu/train/encode.py``. ``encode_frame_batch``
overfits B images at once on one device, each with its own decoder, rate
weight and (``valid_hws``) true size inside the common buffer; every stage
runs on stacked parameters (``train/step.py``, ``train/quantize_model.py``).
The warm-up trains its candidates as one batch too: for B images the first
warm-up phase is a batch of ``B * candidates`` decoders, and the selection a
sort of each image's candidate losses. ``encode_frame`` is the batch of one.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch

from coolchic_tpu_torch.models.coolchic import init_coolchic_params
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.params import stack_params, tree_map
from coolchic_tpu_torch.train.presets import Preset, Warmup
from coolchic_tpu_torch.train.quantize_model import ModuleQuantInfo, quantize_model_batch
from coolchic_tpu_torch.train.step import BatchPhaseLogs, eval_metrics, make_generator, run_phase_batch
from coolchic_tpu_torch.utils.trace import span

Params = Dict[str, Any]


class EncodeStats:
    """Work done by one encode. Per image-step, as a serial encode of each
    image would count it: eval forwards and optimizer steps (of a batch, the
    sum over its images). Per batch: the batched eval forwards (each one
    kernel launch per plane chunk, whatever the batch size) and the batched
    optimizer steps. And the wall time of each stage: ``with
    stats.stage(device, name):`` synchronises with the device on entry and
    on exit, records the span ``encode.<name>`` (``utils/trace.py``) between
    the two, and keeps its seconds in ``stage_seconds[name]``."""

    def __init__(self):
        self.n_eval_forwards = 0
        self.n_train_steps = 0
        self.n_batched_eval_forwards = 0
        self.n_batched_steps = 0
        self.stage_seconds: Dict[str, float] = {}

    @contextmanager
    def stage(self, device: torch.device, name: str) -> Iterator[None]:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        with span(f"encode.{name}") as s:
            yield
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        self.stage_seconds[name] = 1e-9 * s.ns

    def count_phase(self, logs: BatchPhaseLogs) -> None:
        self.n_eval_forwards += logs.n_eval_forwards * len(logs.loss)
        self.n_train_steps += int(logs.n_train_steps.sum())
        self.n_batched_eval_forwards += logs.n_eval_forwards
        self.n_batched_steps += logs.n_batched_steps


def warmup(
    targets: torch.Tensor,
    lmbdas: torch.Tensor,
    cfg: CoolChicConfig,
    warmup_cfg: Warmup,
    seeds: Sequence[int],
    valid_hws: Optional[torch.Tensor] = None,
    stats: Optional[EncodeStats] = None,
) -> Params:
    """For each of the B images ([B, C, H, W] ``targets``, [B] ``lmbdas``),
    start ``phases[0].candidates`` random decoders, train all B * candidates
    of them as one batch for every warm-up phase, keep each image's best
    ``candidates`` of the next phase, and return the winners, stacked."""
    device = targets.device
    n_images = targets.shape[0]
    if not warmup_cfg.phases:
        return stack_params(
            [init_coolchic_params(make_generator(device, seed, 0), cfg, device) for seed in seeds])
    n_cand = warmup_cfg.phases[0].candidates
    cand = stack_params([  # image-major: candidate i of image b is row b * n_cand + i
        init_coolchic_params(make_generator(device, seed, 0, i), cfg, device)
        for seed in seeds for i in range(n_cand)])
    losses = None
    for idx_phase, wp in enumerate(warmup_cfg.phases):
        if losses is not None:
            cand, n_cand = best_candidates(cand, losses, n_images, wp.candidates), wp.candidates

        def per_candidate(x, n=n_cand):
            if x is None:
                return None
            if n_images == 1:  # the candidates share the target (and references): a view
                return x.expand(n, *x.shape[1:])
            return x.repeat_interleave(n, dim=0)

        gen = make_generator(device, *seeds, idx_phase + 1)
        cand, logs = run_phase_batch(
            cand, per_candidate(targets), per_candidate(lmbdas), cfg, wp.training_phase, gen,
            per_candidate(valid_hws))
        losses = logs.loss
        if stats is not None:
            stats.count_phase(logs)
    return best_candidates(cand, losses, n_images, 1)


def best_candidates(cand: Params, losses: torch.Tensor, n_images: int, keep: int) -> Params:
    """Of ``losses.numel() // n_images`` candidates per image (rows in
    image-major order), each image's ``keep`` best, best first."""
    order = torch.argsort(losses.view(n_images, -1), dim=1, stable=True)[:, :keep]
    rows = (order + torch.arange(n_images)[:, None] * (losses.numel() // n_images)).reshape(-1)
    return tree_map(lambda t: t[rows.to(t.device)], cand)


class EncodeResult(NamedTuple):
    """One image's encode, or a batch's: then ``params`` is stacked and the
    three metrics are [B] tensors on the host."""

    params: Params
    loss: float | torch.Tensor
    psnr_db: float | torch.Tensor
    rate_latent_bpp: float | torch.Tensor
    stats: EncodeStats


def encode_frame_batch(
    targets: torch.Tensor,
    lmbdas: torch.Tensor | Sequence[float],
    cfg: CoolChicConfig,
    preset: Preset,
    seeds: Sequence[int],
    valid_hws: Optional[torch.Tensor] = None,
    with_quant_info: bool = False,
):
    """Overfit a batch of images at once on the device ``targets`` lies on:
    warm-up, then every preset phase; after a phase flagged
    ``quantize_model``, the NN-quantization search.

    Args:
        targets: [B, C, H, W] images in [0, 1]. For mixed sizes, pad each
            into the common buffer and pass its true size in ``valid_hws``.
            A P / B frame (``cfg.frame_type``) carries its decoded
            reference(s) as channels 3:6 (and 6:9).
        lmbdas: [B] rate weights, one per image.
        seeds: B integers, one per image (initial weights, noise).
        valid_hws: optional integer [B, 2] true (H, W) per image: the loss
            and the rate are then masked (``models/masking.py``).
        with_quant_info: also return, per image, the q-steps and exp-Golomb
            orders per module that the bitstream writer needs (None when
            the preset never quantizes the networks).

    Returns:
        EncodeResult with stacked params and [B] metrics; with
        ``with_quant_info``, (EncodeResult, infos).
    """
    device = targets.device
    n_images = targets.shape[0]
    if len(seeds) != n_images:
        raise ValueError(f"{n_images} images but {len(seeds)} seeds")
    lmbdas = torch.as_tensor(lmbdas, dtype=torch.float32, device=device)
    if valid_hws is not None:
        valid_hws = torch.as_tensor(valid_hws, device=device)
    stats = EncodeStats()
    with stats.stage(device, "warmup"):
        params = warmup(targets, lmbdas, cfg, preset.warmup, seeds, valid_hws, stats)
    logs = None
    infos: Optional[List[Dict[str, ModuleQuantInfo]]] = None
    for idx, phase in enumerate(preset.all_phases):
        with stats.stage(device, f"phase_{idx}"):
            gen = make_generator(device, *seeds, 1000 + idx)
            params, logs = run_phase_batch(params, targets, lmbdas, cfg, phase, gen, valid_hws)
            stats.count_phase(logs)
        if phase.quantize_model:
            with stats.stage(device, f"quantize_model_{idx}"):
                params, infos, n_evals = quantize_model_batch(params, targets, lmbdas, cfg, valid_hws)
                stats.n_eval_forwards += n_evals * n_images
                stats.n_batched_eval_forwards += n_evals
    if logs is None:
        m = eval_metrics(params, cfg, targets, lmbdas, valid_hw=valid_hws)
        stats.n_eval_forwards += n_images
        stats.n_batched_eval_forwards += 1
        loss, psnr, bpp = m.loss.cpu(), m.psnr_db.cpu(), m.rate_latent_bpp.cpu()
    else:
        loss, psnr, bpp = logs.loss, logs.psnr_db, logs.rate_latent_bpp
    result = EncodeResult(params, loss, psnr, bpp, stats)
    return (result, infos) if with_quant_info else result


def encode_frame_with_quant_info(
    target: torch.Tensor,
    lmbda: float,
    cfg: CoolChicConfig,
    preset: Preset,
    seed: int = 0,
    valid_hw: Optional[torch.Tensor] = None,
) -> Tuple[EncodeResult, Optional[Dict[str, ModuleQuantInfo]]]:
    """Encode one image: the batch of one. ``target`` is [3, H, W] in [0, 1]
    on the device the encode runs on ([6 | 9, H, W] for a P / B frame: the
    target, then its references).

    Returns (EncodeResult, infos): infos holds the q-steps and exp-Golomb
    orders per module that the bitstream writer needs, or None when the
    preset never quantizes the networks.
    """
    res, infos = encode_frame_batch(
        target[None], [lmbda], cfg, preset, [seed],
        None if valid_hw is None else torch.as_tensor(valid_hw)[None], with_quant_info=True)
    result = EncodeResult(tree_map(lambda t: t[0], res.params), res.loss.item(),
                          res.psnr_db.item(), res.rate_latent_bpp.item(), res.stats)
    return result, None if infos is None else infos[0]


def encode_frame(
    target: torch.Tensor,
    lmbda: float,
    cfg: CoolChicConfig,
    preset: Preset,
    seed: int = 0,
    valid_hw: Optional[torch.Tensor] = None,
) -> EncodeResult:
    """Full single-frame encode (see ``encode_frame_with_quant_info``)."""
    return encode_frame_with_quant_info(target, lmbda, cfg, preset, seed, valid_hw)[0]
