"""Text reports of a decoder's architecture and its latent pyramid.
Counterpart of ``coolchic_tpu/utils/console.py``: the same strings."""

from __future__ import annotations

from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.models.coolchic import macs_per_pixel


def pretty_string_coolchic(cfg: CoolChicConfig) -> str:
    """Architecture and its complexity (MAC per decoded pixel) by module."""
    m = macs_per_pixel(cfg)
    s = ""
    title = f"Cool-chic architecture  {m['total']:.0f} MAC / pixel"
    s += f"{title}\n{'-' * len(title)}\n\n"

    share = 100 * m["upsampling"] / m["total"]
    s += f"Upsampling  {m['upsampling']:.0f} MAC/pixel ; {share:.1f} % of the complexity\n"
    s += (
        f"  {cfg.latent_n_grids} latent grids, x2 TConv k={cfg.ups_k_size} "
        f"(symmetric separable), pre-concat Conv k={cfg.ups_preconcat_k_size}\n\n"
    )

    share = 100 * m["arm"] / m["total"]
    s += f"ARM  {m['arm']:.0f} MAC/pixel ; {share:.1f} % of the complexity\n"
    s += f"  {cfg.dim_arm}-pixel context\n"
    for _ in range(cfg.n_hidden_layers_arm):
        s += f"  Linear {cfg.dim_arm:>3} -> {cfg.dim_arm:<3} residual + ReLU\n"
    s += f"  Linear {cfg.dim_arm:>3} -> 2   (mu, log scale)\n\n"

    share = 100 * m["synthesis"] / m["total"]
    s += f"Synthesis  {m['synthesis']:.0f} MAC/pixel ; {share:.1f} % of the complexity\n"
    in_ft = cfg.total_latent_channels
    for out_ft, k, res, relu in cfg.parsed_synthesis_layers():
        kind = "residual" if res else "linear"
        act = " + ReLU" if relu else ""
        s += f"  Conv{k}x{k} {in_ft:>3} -> {out_ft:<3} {kind}{act}\n"
        in_ft = out_ft
    return s


def pretty_string_latents(cfg: CoolChicConfig) -> str:
    """The latent pyramid's grid shapes and its latents per pixel."""
    s = "Latent pyramid:\n"
    for i, (c, h, w) in enumerate(cfg.latent_shapes):
        s += f"  level {i}: [{c}, {h:>5}, {w:>5}]\n"
    s += f"  total: {cfg.n_latents} latents for {cfg.n_pixels} pixels "
    s += f"({cfg.n_latents / cfg.n_pixels:.3f} per pixel)\n"
    return s
