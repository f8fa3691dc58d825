"""Configuration of one image encode run.

Counterpart of the image-CLI part of ``coolchic_tpu/utils/types.py``
(``DecoderConfig``, ``EncoderConfig``, ``RunConfig``), as plain dataclasses.
Decoder configs are read from ``cfg/dec/*.yaml``; the training recipe from
``preset_cfg/*.yaml`` (``train/presets.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from pathlib import Path
from typing import Optional, Tuple

import torch

from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.train.presets import Preset, load_preset


@dataclass
class DecoderConfig:
    """Decoder architecture descriptor (the default is the flagship width)."""

    config_name: Optional[str] = None
    layers_synthesis: str = "40-1-linear-relu,X-1-linear-none,X-3-residual-relu,X-3-residual-none"
    arm: str = "24,2"
    ups_k_size: int = 8
    ups_preconcat_k_size: int = 7
    n_ft_per_res: str = "1,1,1,1,1,1,1"
    encoder_gain: int = 16

    @classmethod
    def from_yaml(cls, path: str | Path) -> "DecoderConfig":
        import yaml

        with open(path) as f:
            d = yaml.safe_load(f) or {}
        unknown = set(d) - {f.name for f in fields(cls)}
        if unknown:
            raise ValueError(f"unknown decoder config fields {sorted(unknown)} in {path}")
        return cls(**d)

    @property
    def dim_arm(self) -> int:
        return int(self.arm.split(",")[0])

    @property
    def n_hidden_layers_arm(self) -> int:
        return int(self.arm.split(",")[1])

    def to_coolchic_config(
        self, img_size: Tuple[int, int], out_channels: int = 3, frame_data_type: str = "rgb"
    ) -> CoolChicConfig:
        layers = tuple(x for x in self.layers_synthesis.split(",") if x != "")
        n_ft = tuple(int(x) for x in self.n_ft_per_res.split(",") if x != "")
        if not layers:
            raise ValueError("Synthesis should have at least one layer.")
        if set(n_ft) != {1}:
            raise ValueError(f"n_ft_per_res should only contain 1. Found {self.n_ft_per_res}")
        return CoolChicConfig(
            img_size=img_size,
            layers_synthesis=layers,
            n_ft_per_res=n_ft,
            dim_arm=self.dim_arm,
            n_hidden_layers_arm=self.n_hidden_layers_arm,
            encoder_gain=self.encoder_gain,
            ups_k_size=self.ups_k_size,
            ups_preconcat_k_size=self.ups_preconcat_k_size,
            out_channels=out_channels,
            frame_data_type=frame_data_type,
        )


@dataclass
class EncoderConfig:
    """Training recipe of a run: a named preset of ``preset_cfg/`` whose
    first phase lasts ``n_itr`` iterations when given."""

    std_recipe_name: str = "c3x"
    n_itr: Optional[int] = None
    n_train_loops: int = 1
    recipe: Optional[Preset] = None

    def __post_init__(self):
        if self.recipe is None:
            self.recipe = load_preset(self.std_recipe_name, self.n_itr)


@dataclass
class RunConfig:
    input: Path
    lmbda: float = 1e-3
    workdir: Optional[Path] = None
    output: Optional[Path] = None  # the .cool bitstream
    enc_cfg: EncoderConfig = field(default_factory=EncoderConfig)
    dec_cfg: DecoderConfig = field(default_factory=DecoderConfig)


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for and none is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "coolchic_tpu_torch runs on a CUDA device by default, and "
            "torch.cuda.is_available() is False here: pass device='cpu' "
            "(or --device cpu) to run on the CPU"
        )
    return device
