"""Static model configuration of one Cool-chic frame decoder.

Counterpart of ``coolchic_tpu/models/config.py``. Everything that fixes
tensor shapes lives here; the weights live in the parameter dict of
``models/coolchic.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class CoolChicConfig:
    """Architecture of one Cool-chic frame decoder.

    Attributes:
        img_size: (H, W) of the frame to code.
        layers_synthesis: ``"<out_ft>-<kernel_size>-<linear|residual>-<none|relu>"``
            per synthesis layer; ``out_ft == "X"`` means ``out_channels``.
        n_ft_per_res: latent channels of grid i, at resolution
            ``(ceil(H/2^i), ceil(W/2^i))``.
        dim_arm: ARM context size == ARM hidden width (8, 16, 24 or 32).
        n_hidden_layers_arm: residual hidden layers of the ARM.
        encoder_gain: latent multiplier applied before quantization.
        ups_k_size: even kernel size of the x2 upsamplers.
        ups_preconcat_k_size: odd kernel size of the pre-concat filters.
        out_channels: synthesized channels: 3 for an I frame, 6 for a P frame
            and 9 for a B frame (residue, then flows and gains).
        frame_data_type: "rgb" | "yuv444" | "yuv420" (selects the loss).
        frame_type: "I" | "P" | "B"; P and B frames motion-compensate their
            reference frame(s) with the synthesized flows
            (``video/intercoding.py``).
        flow_gain: integer scale of the synthesized flows (written to the
            frame header).
        frozen_zero_grids: latent grids pinned to zero for the whole encode.
    """

    img_size: Tuple[int, int]
    layers_synthesis: Tuple[str, ...] = (
        "48-1-linear-relu",
        "X-1-linear-none",
        "X-3-residual-relu",
        "X-3-residual-none",
    )
    n_ft_per_res: Tuple[int, ...] = (1, 1, 1, 1, 1, 1, 1)
    dim_arm: int = 24
    n_hidden_layers_arm: int = 2
    encoder_gain: int = 16
    ups_k_size: int = 8
    ups_preconcat_k_size: int = 7
    out_channels: int = 3
    frame_data_type: str = "rgb"
    frame_type: str = "I"
    flow_gain: int = 1
    frozen_zero_grids: Tuple[int, ...] = ()

    def __post_init__(self):
        for f in ("layers_synthesis", "n_ft_per_res", "frozen_zero_grids", "img_size"):
            v = getattr(self, f)
            if not isinstance(v, tuple):
                object.__setattr__(self, f, tuple(v))
        if not all(0 <= g < len(self.n_ft_per_res) for g in self.frozen_zero_grids):
            raise ValueError(
                f"frozen_zero_grids {self.frozen_zero_grids} out of range for "
                f"{len(self.n_ft_per_res)} grids"
            )
        if self.dim_arm not in (8, 16, 24, 32):
            raise ValueError(f"ARM context size must be 8, 16, 24 or 32. Found {self.dim_arm}.")
        if self.ups_k_size < 4 or self.ups_k_size % 2:
            raise ValueError(f"Upsampling kernel size must be even and >= 4, found {self.ups_k_size}")
        if self.ups_preconcat_k_size % 2 != 1:
            raise ValueError(
                f"Pre-concat kernel size must be odd, found {self.ups_preconcat_k_size}"
            )
        if self.frame_type not in ("I", "P", "B"):
            raise ValueError(f"frame_type must be I, P or B, found {self.frame_type}")
        want = {"P": 6, "B": 9}.get(self.frame_type)
        if want is not None and self.out_channels != want:
            raise ValueError(f"{self.frame_type} frames synthesize {want} channels, "
                             f"found out_channels = {self.out_channels}")
        self.parsed_synthesis_layers()

    @property
    def latent_n_grids(self) -> int:
        return len(self.n_ft_per_res)

    @property
    def latent_shapes(self) -> Tuple[Tuple[int, int, int], ...]:
        """(C_i, H_i, W_i) of each latent grid, H_i = ceil(H / 2^i)."""
        h, w = self.img_size
        return tuple(
            (self.n_ft_per_res[i], int(math.ceil(h / 2**i)), int(math.ceil(w / 2**i)))
            for i in range(self.latent_n_grids)
        )

    @property
    def n_latents(self) -> int:
        return sum(c * h * w for (c, h, w) in self.latent_shapes)

    @property
    def total_latent_channels(self) -> int:
        return sum(self.n_ft_per_res)

    @property
    def n_pixels(self) -> int:
        return self.img_size[0] * self.img_size[1]

    def parsed_synthesis_layers(self) -> Tuple[Tuple[int, int, bool, bool], ...]:
        """(out_ft, k_size, residual, relu) per synthesis layer."""
        out = []
        for spec in self.layers_synthesis:
            out_ft, k_size, mode, non_linearity = spec.split("-")
            if mode not in ("linear", "residual"):
                raise ValueError(f"Unknown synthesis mode {mode}")
            if non_linearity not in ("none", "relu"):
                raise ValueError(f"Unknown non-linearity {non_linearity}")
            out_ft = self.out_channels if out_ft == "X" else int(out_ft)
            out.append((out_ft, int(k_size), mode == "residual", non_linearity == "relu"))
        return tuple(out)
