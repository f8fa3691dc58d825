"""Hypernet heads: MLPs mapping backbone features to decoder weights.

Counterpart of ``coolchic_tpu/hypernet/heads.py``. Each head emits a flat
vector per image that is sliced directly into the decoder's parameter
layout (``models/coolchic.py``) with a leading [B] axis.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from coolchic_tpu_torch.hypernet.backbone import get_backbone
from coolchic_tpu_torch.hypernet.blocks import MLP, Conv, LatentHyperNet, upsample_latents
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.models.upsampling import half_kernel_size


def arm_param_count(
    dim_arm: int, n_hidden: int, biases: bool = True, only_biases: bool = False
) -> int:
    if only_biases:  # COIN++-style bias-only deltas
        return dim_arm * n_hidden + 2
    per_hidden = dim_arm * dim_arm + (dim_arm if biases else 0)
    return per_hidden * n_hidden + dim_arm * 2 + (2 if biases else 0)


def synthesis_param_count(
    cfg: CoolChicConfig, biases: bool = True, only_biases: bool = False
) -> int:
    n = 0
    in_ft = cfg.total_latent_channels
    for out_ft, k, _res, _relu in cfg.parsed_synthesis_layers():
        if only_biases:
            n += out_ft
        else:
            n += out_ft * in_ft * k * k + (out_ft if biases else 0)
        in_ft = out_ft
    return n


def upsampling_param_count(cfg: CoolChicConfig) -> int:
    """Per stage: x2 half kernel + 1 bias, pre-concat half kernel + 1 bias.
    The decoder's upsampling biases are dead: their outputs are predicted
    (capacity parity with the reference) and dropped by ``shape_upsampling``."""
    return (cfg.latent_n_grids - 1) * (
        half_kernel_size(cfg.ups_k_size) + 1 + half_kernel_size(cfg.ups_preconcat_k_size) + 1
    )


def shape_arm(flat: torch.Tensor, cfg: CoolChicConfig, only_biases: bool = False) -> Dict:
    """[B, n_params] -> ARM params with a leading [B] axis. With
    ``only_biases`` the flat vector holds the biases only and the weights
    (deltas) are zero."""
    c = cfg.dim_arm
    batch = flat.shape[0]
    layers = []
    p = 0
    for _ in range(cfg.n_hidden_layers_arm):
        if only_biases:
            w = flat.new_zeros((batch, c, c))
        else:
            w = flat[:, p : p + c * c].reshape(-1, c, c)
            p += c * c
        b = flat[:, p : p + c]
        p += c
        layers.append({"weight": w, "bias": b})
    if only_biases:
        w = flat.new_zeros((batch, 2, c))
    else:
        w = flat[:, p : p + 2 * c].reshape(-1, 2, c)
        p += 2 * c
    layers.append({"weight": w, "bias": flat[:, p : p + 2]})
    return {"layers": layers}


def shape_synthesis(flat: torch.Tensor, cfg: CoolChicConfig, only_biases: bool = False) -> Dict:
    layers = []
    batch = flat.shape[0]
    p = 0
    in_ft = cfg.total_latent_channels
    for out_ft, k, _res, _relu in cfg.parsed_synthesis_layers():
        if only_biases:
            w = flat.new_zeros((batch, out_ft, in_ft, k, k))
        else:
            n_w = out_ft * in_ft * k * k
            w = flat[:, p : p + n_w].reshape(-1, out_ft, in_ft, k, k)
            p += n_w
        layers.append({"weight": w, "bias": flat[:, p : p + out_ft]})
        p += out_ft
        in_ft = out_ft
    return {"layers": layers}


def shape_upsampling(flat: torch.Tensor, cfg: CoolChicConfig) -> Dict:
    n_ups = half_kernel_size(cfg.ups_k_size)
    n_pre = half_kernel_size(cfg.ups_preconcat_k_size)
    ups, pre = [], []
    p = 0
    for _ in range(cfg.latent_n_grids - 1):
        ups.append(flat[:, p : p + n_ups])
        p += n_ups + 1  # skip the dead bias output
        pre.append(flat[:, p : p + n_pre])
        p += n_pre + 1
    return {"ups": ups, "preconcat": pre}


def _heads(module: nn.Module, cfg: CoolChicConfig, in_features: int, synthesis_hidden_dim: int,
           synthesis_n_layers: int, arm_hidden_dim: int, arm_n_layers: int,
           output_activation: Optional[str], deltas: bool, only_biases_arm: bool,
           only_biases_synthesis: bool) -> None:
    """The synthesis (``MLP_0``) and ARM (``MLP_1``) heads, in flax's order."""
    module.MLP_0 = MLP(in_features, synthesis_param_count(cfg, only_biases=only_biases_synthesis),
                       synthesis_hidden_dim, synthesis_n_layers, output_activation, deltas)
    module.MLP_1 = MLP(in_features, arm_param_count(cfg.dim_arm, cfg.n_hidden_layers_arm,
                                                    only_biases=only_biases_arm),
                       arm_hidden_dim, arm_n_layers, output_activation, deltas)


class CoolchicHyperNet(nn.Module):
    """Latent encoder + backbone + three weight heads.

    forward(img [B, 3, H, W]) -> (latents: list of [B, 1, h_i, w_i],
    synthesis / arm / upsampling params with a leading [B] axis)."""

    def __init__(
        self,
        cfg: CoolChicConfig,
        backbone_arch: str = "resnet18",
        n_hidden_channels: int = 64,
        synthesis_hidden_dim: int = 1024,
        synthesis_n_layers: int = 3,
        arm_hidden_dim: int = 1024,
        arm_n_layers: int = 3,
        ups_hidden_dim: int = 256,
        ups_n_layers: int = 3,
        output_activation: Optional[str] = "tanh",
        deltas: bool = True,  # zero-init head outputs (delta mode)
        only_biases_arm: bool = False,
        only_biases_synthesis: bool = False,
        double_backbone: bool = False,  # a 2nd backbone over the upsampled latents
    ):
        super().__init__()
        self.cfg = cfg
        self.only_biases_arm = only_biases_arm
        self.only_biases_synthesis = only_biases_synthesis
        self.double_backbone = double_backbone
        self.LatentHyperNet_0 = LatentHyperNet(cfg.latent_n_grids, n_hidden_channels)
        self.ResNet_0, n_feats = get_backbone(backbone_arch)
        if double_backbone:
            self.ResNet_1, n_lat_feats = get_backbone(backbone_arch, cfg.latent_n_grids)
            n_feats += n_lat_feats
        _heads(self, cfg, n_feats, synthesis_hidden_dim, synthesis_n_layers, arm_hidden_dim,
               arm_n_layers, output_activation, deltas, only_biases_arm, only_biases_synthesis)
        self.MLP_2 = MLP(n_feats, upsampling_param_count(cfg), ups_hidden_dim, ups_n_layers,
                         "tanh", deltas)

    def forward(self, img: torch.Tensor):
        latents = self.LatentHyperNet_0(img)
        feats = self.ResNet_0(img)
        if self.double_backbone:
            # The second backbone reads the detached latents resized to the image.
            lat_img = upsample_latents(latents, img.shape[-2:]).detach()
            feats = torch.cat([feats, self.ResNet_1(lat_img)], dim=-1)
        return (
            latents,
            shape_synthesis(self.MLP_0(feats), self.cfg, self.only_biases_synthesis),
            shape_arm(self.MLP_1(feats), self.cfg, self.only_biases_arm),
            shape_upsampling(self.MLP_2(feats), self.cfg),
        )


class SmallCoolchicHyperNet(nn.Module):
    """Compact variant: a plain conv backbone over the image concatenated
    with the detached upsampled latents; synthesis and ARM heads only, the
    upsampling deltas are zero."""

    WIDTHS = ((64, 3), (128, 3), (256, 3), (512, 3), (1024, 1))

    def __init__(
        self,
        cfg: CoolChicConfig,
        n_hidden_channels: int = 64,
        synthesis_hidden_dim: int = 1024,
        synthesis_n_layers: int = 3,
        arm_hidden_dim: int = 1024,
        arm_n_layers: int = 3,
        output_activation: Optional[str] = "tanh",
        deltas: bool = True,
        only_biases_arm: bool = False,
        only_biases_synthesis: bool = False,
    ):
        super().__init__()
        self.cfg = cfg
        self.only_biases_arm = only_biases_arm
        self.only_biases_synthesis = only_biases_synthesis
        self.LatentHyperNet_0 = LatentHyperNet(cfg.latent_n_grids, n_hidden_channels)
        in_ch = 3 + cfg.latent_n_grids
        for i, (width, k) in enumerate(self.WIDTHS):
            self.add_module(f"Conv_{i}", Conv(in_ch, width, k))
            in_ch = width
        _heads(self, cfg, in_ch, synthesis_hidden_dim, synthesis_n_layers, arm_hidden_dim,
               arm_n_layers, output_activation, deltas, only_biases_arm, only_biases_synthesis)

    def forward(self, img: torch.Tensor):
        latents = self.LatentHyperNet_0(img)
        lat_img = upsample_latents(latents, img.shape[-2:]).detach()
        x = torch.cat([img, lat_img], dim=1)
        for i, (width, _k) in enumerate(self.WIDTHS):
            x = getattr(self, f"Conv_{i}")(x)
            if width != 1024:
                x = torch.relu(x)
        feats = x.mean(dim=(2, 3))
        batch = img.shape[0]
        cfg = self.cfg
        ups_zero = {
            "ups": [img.new_zeros((batch, half_kernel_size(cfg.ups_k_size)))
                    for _ in range(cfg.latent_n_grids - 1)],
            "preconcat": [img.new_zeros((batch, half_kernel_size(cfg.ups_preconcat_k_size)))
                          for _ in range(cfg.latent_n_grids - 1)],
        }
        return (
            latents,
            shape_synthesis(self.MLP_0(feats), cfg, self.only_biases_synthesis),
            shape_arm(self.MLP_1(feats), cfg, self.only_biases_arm),
            ups_zero,
        )
