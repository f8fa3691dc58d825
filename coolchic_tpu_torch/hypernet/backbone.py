"""ResNet feature-extraction backbones, in NCHW.

Counterpart of ``coolchic_tpu/hypernet/backbone.py``: trained from scratch
(no download of ImageNet weights), GroupNorm(32) in place of BatchNorm so
that the hypernet is a pure function of its weights. Submodule names are
flax's (``Conv_0``, ``GroupNorm_1``, ``BasicBlock_5``, ...). The stem's
max-pool pads with -inf, as flax's does; the 1x1 stride-2 shortcut pads
nothing (flax's ``"SAME"`` for a 1x1 kernel).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from coolchic_tpu_torch.hypernet.blocks import Conv, GroupNorm


def stem_pool(x: torch.Tensor) -> torch.Tensor:
    """flax ``max_pool(x, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)))``:
    the padding is -inf, never a maximum."""
    return F.max_pool2d(x, 3, stride=2, padding=1)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, filters: int, strides: int = 1):
        super().__init__()
        self.Conv_0 = Conv(in_channels, filters, 3, stride=strides, padding=1, bias=False)
        self.GroupNorm_0 = GroupNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, padding=1, bias=False)
        self.GroupNorm_1 = GroupNorm(filters)
        # flax adds the shortcut where the residual's shape differs: in a
        # ResNet, exactly where the channels change.
        self.shortcut = in_channels != filters or strides != 1
        if self.shortcut:
            self.Conv_2 = Conv(in_channels, filters, 1, stride=strides, padding=0, bias=False)
            self.GroupNorm_2 = GroupNorm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = self.GroupNorm_1(self.Conv_1(y))
        residual = self.GroupNorm_2(self.Conv_2(x)) if self.shortcut else x
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_channels: int, filters: int, strides: int = 1):
        super().__init__()
        self.Conv_0 = Conv(in_channels, filters, 1, bias=False)
        self.GroupNorm_0 = GroupNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, stride=strides, padding=1, bias=False)
        self.GroupNorm_1 = GroupNorm(filters)
        self.Conv_2 = Conv(filters, 4 * filters, 1, bias=False)
        self.GroupNorm_2 = GroupNorm(4 * filters)
        self.shortcut = in_channels != 4 * filters or strides != 1
        if self.shortcut:
            self.Conv_3 = Conv(in_channels, 4 * filters, 1, stride=strides, padding=0, bias=False)
            self.GroupNorm_3 = GroupNorm(4 * filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = torch.relu(self.GroupNorm_1(self.Conv_1(y)))
        y = self.GroupNorm_2(self.Conv_2(y))
        residual = self.GroupNorm_3(self.Conv_3(x)) if self.shortcut else x
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """Stem + 4 stages + global average pool (no classification head):
    [B, C_in, H, W] -> [B, F]."""

    def __init__(self, stage_sizes: Sequence[int], block: type = BasicBlock, in_channels: int = 3):
        super().__init__()
        self.Conv_0 = Conv(in_channels, 64, 7, stride=2, padding=3, bias=False)
        self.GroupNorm_0 = GroupNorm(64)
        self.blocks = []
        ch = 64
        for i, n_blocks in enumerate(stage_sizes):
            filters = 64 * 2**i
            for j in range(n_blocks):
                name = f"{block.__name__}_{len(self.blocks)}"
                self.add_module(name, block(ch, filters, 2 if (i > 0 and j == 0) else 1))
                self.blocks.append(name)
                ch = filters * block.expansion
        self.n_features = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = stem_pool(torch.relu(self.GroupNorm_0(self.Conv_0(x))))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def get_backbone(arch: str = "resnet18", in_channels: int = 3) -> Tuple[ResNet, int]:
    """(module, n_output_features)."""
    if arch == "resnet18":
        return ResNet((2, 2, 2, 2), BasicBlock, in_channels), 512
    if arch == "resnet50":
        return ResNet((3, 4, 6, 3), Bottleneck, in_channels), 2048
    if arch == "resnet101":
        return ResNet((3, 4, 23, 3), Bottleneck, in_channels), 2048
    raise ValueError(f"Unknown backbone arch {arch}")
