"""Hypernet evaluation analysis: iterations to match the one-shot quality.

Counterpart of ``coolchic_tpu/eval/hypernet.py``: how many per-image
training iterations does a decoder trained from scratch need to reach the
hypernet's one-shot RD loss?
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from coolchic_tpu_torch.models.coolchic import init_coolchic_params
from coolchic_tpu_torch.train.presets import TrainerPhase
from coolchic_tpu_torch.train.step import eval_metrics, make_generator, run_phase


def iterations_to_match(
    wholenet,
    state,
    img: torch.Tensor,
    lmbda: float,
    seed: int,
    max_itr: int = 2000,
    check_every: int = 100,
) -> Dict:
    """Train a fresh per-image decoder from scratch on ``img`` ([3, H, W], on
    the device of ``state``) and report after how many iterations its eval
    loss crosses the hypernet's one-shot loss. The init and the noise of
    each phase come from generators seeded with ``seed``.

    Returns a dict with the one-shot metrics, the per-checkpoint losses of
    the from-scratch run, and ``itr_to_match`` (None if never matched)."""
    cfg = wholenet.cfg
    device = img.device
    with torch.no_grad():
        one_shot_params = wholenet.image_to_coolchic(state, img)
    m_shot = eval_metrics(one_shot_params, cfg, img, lmbda)
    target_loss = float(m_shot.loss)

    params = init_coolchic_params(make_generator(device, seed), cfg, device)
    losses: List[float] = []
    itr_to_match: Optional[int] = None
    phase = TrainerPhase(
        lr=1e-2,
        max_itr=check_every,
        freq_valid=check_every,
        patience=10 * max_itr,
        schedule_lr=False,
        quantizer_type="softround",
        quantizer_noise_type="gaussian",
        softround_temperature=(0.3, 0.3),
        noise_parameter=(0.25, 0.25),
    )
    for i in range(max_itr // check_every):
        params, logs = run_phase(params, img, lmbda, cfg, phase, make_generator(device, seed, i))
        losses.append(float(logs.loss))
        if itr_to_match is None and losses[-1] <= target_loss:
            itr_to_match = (i + 1) * check_every
    return {
        "one_shot_loss": target_loss,
        "one_shot_psnr_db": float(m_shot.psnr_db),
        "one_shot_rate_bpp": float(m_shot.rate_latent_bpp),
        "scratch_losses": losses,
        "itr_to_match": itr_to_match,
        "check_every": check_every,
    }
