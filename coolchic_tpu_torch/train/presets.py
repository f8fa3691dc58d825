"""Encoding presets: training phases and warm-up, read from ``preset_cfg/``.

Counterpart of ``coolchic_tpu/train/presets.py`` and of the recipe part of
``coolchic_tpu/utils/types.py``. The YAML files of ``preset_cfg/`` are the
data; these frozen dataclasses are what the phase engine takes.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, replace
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

from coolchic_tpu_torch.utils.paths import PRESET_CFG_DIR

PRESET_NAMES = ("c3x", "debug")


@dataclass(frozen=True)
class TrainerPhase:
    """One training phase."""

    lr: float = 1e-2
    max_itr: int = 5000
    freq_valid: int = 100
    patience: int = 10000
    quantize_model: bool = False
    schedule_lr: bool = False
    end_lr: float = 1e-5
    softround_temperature: Tuple[float, float] = (0.3, 0.3)
    noise_parameter: Tuple[float, float] = (1.0, 1.0)
    quantizer_noise_type: str = "kumaraswamy"
    quantizer_type: str = "softround"
    # "all" or any subset of ("arm", "upsampling", "synthesis", "latents")
    optimized_module: Tuple[str, ...] = ("all",)

    def __post_init__(self):
        noise_free = ("softround_alone", "hardround", "ste", "true_ste", "none")
        if self.quantizer_type in noise_free and self.quantizer_noise_type != "none":
            raise ValueError(
                f"quantizer_type={self.quantizer_type} requires quantizer_noise_type='none'"
            )
        if self.quantizer_type not in noise_free and self.quantizer_noise_type == "none":
            raise ValueError(f"quantizer_type={self.quantizer_type} requires a noise type")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainerPhase":
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown trainer phase fields {sorted(unknown)}")
        kw = dict(d)
        for k in ("lr", "end_lr"):
            if k in kw:
                kw[k] = float(kw[k])  # YAML reads "1e-2" as a string
        for k in ("softround_temperature", "noise_parameter"):
            if k in kw:
                kw[k] = tuple(float(v) for v in kw[k])
        if "optimized_module" in kw:
            # The reference calls the latent module "latent".
            kw["optimized_module"] = tuple(
                "latents" if m == "latent" else m for m in kw["optimized_module"]
            )
        return cls(**kw)


@dataclass(frozen=True)
class WarmupPhase:
    """Keep the best ``candidates`` systems, then train each one phase."""

    candidates: int
    training_phase: TrainerPhase


@dataclass(frozen=True)
class Warmup:
    phases: Tuple[WarmupPhase, ...] = ()


@dataclass(frozen=True)
class Preset:
    preset_name: str
    all_phases: Tuple[TrainerPhase, ...] = ()
    warmup: Warmup = field(default_factory=Warmup)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Preset":
        phases = tuple(TrainerPhase.from_dict(p) for p in d["all_phases"])
        warm = Warmup(
            tuple(
                WarmupPhase(int(wp["candidates"]), TrainerPhase.from_dict(wp["training_phase"]))
                for wp in d.get("warmup", {}).get("phases", [])
            )
        )
        # A hypernet recipe ("hnet" in its name) may leave the quantization out.
        if phases and "hnet" not in d["preset_name"] and not any(p.quantize_model for p in phases):
            raise ValueError(f"Preset {d['preset_name']} has no phase with NN quantization.")
        return cls(preset_name=d["preset_name"], all_phases=phases, warmup=warm)

    def with_first_phase_itr(self, n_itr: Optional[int]) -> "Preset":
        """The preset with the first phase's ``max_itr`` set to ``n_itr``
        (unchanged when ``n_itr`` is None or 0), as the encoder's ``--n_itr``."""
        if not n_itr:
            return self
        first = replace(self.all_phases[0], max_itr=n_itr)
        return replace(self, all_phases=(first,) + self.all_phases[1:])


def load_preset(name_or_path: str, n_itr: Optional[int] = None) -> Preset:
    """Read ``preset_cfg/<name>.yaml`` (or a YAML path). ``n_itr`` replaces
    the first phase's ``max_itr``, as the encoder's ``--n_itr`` does."""
    import yaml

    path = Path(name_or_path)
    if name_or_path in PRESET_NAMES:
        path = PRESET_CFG_DIR / f"{name_or_path}.yaml"
    with open(path) as f:
        return Preset.from_dict(yaml.safe_load(f)).with_first_phase_itr(n_itr)


def preset_c3x(start_lr: float = 1e-2, n_itr_per_phase: int = 100000) -> Preset:
    """``preset_cfg/c3x.yaml`` with the first phase's ``max_itr`` set to
    ``n_itr_per_phase`` and ``start_lr`` as the warm-up's and the first
    phase's learning rate (the YAML's 10,600 iterations and 1e-2 are
    ``preset_c3x(n_itr_per_phase=10600)``)."""
    preset = load_preset("c3x", n_itr_per_phase)
    warmup = Warmup(tuple(replace(wp, training_phase=replace(wp.training_phase, lr=start_lr))
                          for wp in preset.warmup.phases))
    phases = (replace(preset.all_phases[0], lr=start_lr),) + preset.all_phases[1:]
    return replace(preset, all_phases=phases, warmup=warmup)


def preset_debug(start_lr: float = 1e-2, n_itr_per_phase: int = 100000) -> Preset:
    """``preset_cfg/debug.yaml`` with ``start_lr`` as the first phase's
    learning rate. ``n_itr_per_phase`` is not read: the debug schedule's
    lengths are fixed, as in the JAX package."""
    preset = load_preset("debug")
    return replace(preset, all_phases=(replace(preset.all_phases[0], lr=start_lr),)
                   + preset.all_phases[1:])


def preset_measure_speed(start_lr: float = 1e-2, n_itr_per_phase: int = 100000) -> Preset:
    """One phase of ``n_itr_per_phase`` iterations, then the quantization
    search, after a one-candidate, one-iteration warm-up: a schedule to time
    the encoder (reference: presets.py:435-474)."""
    return Preset(
        preset_name="measure_speed",
        all_phases=(
            TrainerPhase(
                lr=start_lr,
                max_itr=n_itr_per_phase,
                patience=5000,
                schedule_lr=True,
                quantizer_type="softround",
                quantizer_noise_type="gaussian",
                softround_temperature=(0.3, 0.1),
                noise_parameter=(0.25, 0.1),
                quantize_model=True,
            ),
        ),
        warmup=Warmup((WarmupPhase(candidates=1,
                                   training_phase=TrainerPhase(max_itr=1, freq_valid=1)),)),
    )


AVAILABLE_PRESETS: Dict[str, Callable[..., Preset]] = {
    "c3x": preset_c3x,
    "debug": preset_debug,
    "measure_speed": preset_measure_speed,
}
