"""Per-image finetuning of hypernet-initialized decoders.

Counterpart of ``coolchic_tpu/hypernet/finetune.py``: the amortized encoder
gives a one-shot initialization, and a short standard training run
(``train/step.py::run_phase``) closes most of the gap to full overfitting.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from coolchic_tpu_torch.train.presets import TrainerPhase
from coolchic_tpu_torch.train.step import eval_metrics, make_generator, run_phase


def default_finetune_phases(n_itr: int = 1000) -> Tuple[TrainerPhase, ...]:
    """A short softround + noise phase, then an STE retune."""
    return (
        TrainerPhase(
            lr=1e-3,
            max_itr=n_itr,
            freq_valid=min(100, n_itr),
            patience=10 * n_itr,
            schedule_lr=True,
            quantizer_type="softround",
            quantizer_noise_type="gaussian",
            softround_temperature=(0.3, 0.1),
            noise_parameter=(0.25, 0.1),
        ),
        TrainerPhase(
            lr=1e-4,
            max_itr=max(n_itr // 10, 10),
            freq_valid=10,
            quantizer_type="ste",
            quantizer_noise_type="none",
            softround_temperature=(1e-4, 1e-4),
        ),
    )


def finetune_coolchic(
    wholenet,
    state,
    img: torch.Tensor,  # [3, H, W]
    lmbda: float,
    seed: int = 0,
    phases: Optional[Tuple[TrainerPhase, ...]] = None,
):
    """Per-image params from the amortized encoder, then the standard
    training phases on them (phase i's noise from a generator seeded with
    ``(seed, i)``).

    Returns (the one-shot eval metrics, the finetuned params, the last
    phase's logs)."""
    cfg = wholenet.cfg
    with torch.no_grad():
        params = wholenet.image_to_coolchic(state, img)
    m0 = eval_metrics(params, cfg, img, lmbda)
    logs = None
    for idx, phase in enumerate(phases or default_finetune_phases()):
        params, logs = run_phase(params, img, lmbda, cfg, phase,
                                 make_generator(img.device, seed, idx))
    return m0, params, logs
