"""ConvNeXt-style building blocks and the latent encoder, in NCHW.

Counterpart of ``coolchic_tpu/hypernet/blocks.py`` (flax, NHWC). Each
submodule carries the name flax gives it (``Conv_0``, ``LayerNorm_0``,
``ConvNeXtBlock_1``, ``Dense_3``, ...), so a flax parameter tree and a
state dict of these modules differ only in layout (``hypernet/bridge.py``).
The layers below reproduce flax's numerics where torch's defaults differ:

* ``Conv``: flax's ``"SAME"`` padding is symmetric for the odd kernels at
  stride 1 used here, and pads nothing for the 1x1 stride-2 shortcut;
* ``LayerNorm``: flax normalizes NHWC's last axis, the channels, with
  epsilon 1e-6: in NCHW a layer norm over dim 1;
* ``GroupNorm``: flax's epsilon is 1e-6 (torch's 1e-5);
* ``gelu``: flax's ``nn.gelu`` is the tanh approximation;
* the downsampling average pool pads one zero row and column and counts
  them (``count_include_pad``), which ``ceil_mode`` would not;
* ``upsample_latents``: ``jax.image.resize(..., "bicubic")`` is Keys' cubic
  (a = -0.5) with half-pixel centres, taps outside the input dropped and
  each output's weights renormalized; torch's bicubic (a = -0.75, clamped
  edges) is not it, so the resize is two weight matrices built the same way.

Initializers follow flax's (training starts from them): ``own_init`` of each
leaf module draws its tensors from a ``torch.Generator``; ``init_params``
gathers them into a state dict.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# flax's variance_scaling divides by the std of a standard normal truncated
# to [-2, 2] so that the truncated draw keeps the variance asked for.
_TRUNC_STD = 0.87962566103423978


def truncated_normal(shape, std: float, generator: torch.Generator, device) -> torch.Tensor:
    """``jax.random.truncated_normal(-2, 2) * std``: a standard normal cut at
    +-2, then scaled (its own std is 0.88 std)."""
    t = torch.empty(shape, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t * std


def lecun_normal(shape, fan_in: int, generator: torch.Generator, device) -> torch.Tensor:
    """flax's default kernel init: variance 1 / fan_in, truncated normal."""
    return truncated_normal(shape, math.sqrt(1.0 / fan_in) / _TRUNC_STD, generator, device)


class Conv(nn.Conv2d):
    """flax ``nn.Conv``: symmetric ``padding`` (0 for a 1x1 kernel, whatever
    the stride); ``kernel_init`` "lecun" (flax's default) or "trunc02"
    (``truncated_normal(0.02)``), zero bias."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 padding: Optional[int] = None, groups: int = 1, bias: bool = True,
                 kernel_init: str = "lecun"):
        super().__init__(in_ch, out_ch, k, stride=stride,
                         padding=(k - 1) // 2 if padding is None else padding,
                         groups=groups, bias=bias)
        self.kernel_init = kernel_init

    def own_init(self, generator, device) -> Dict[str, torch.Tensor]:
        shape = tuple(self.weight.shape)
        if self.kernel_init == "trunc02":
            out = {"weight": truncated_normal(shape, 0.02, generator, device)}
        else:
            out = {"weight": lecun_normal(shape, shape[1] * shape[2] * shape[3], generator, device)}
        if self.bias is not None:
            out["bias"] = torch.zeros(shape[0], device=device)
        return out


class Dense(nn.Linear):
    """flax ``nn.Dense``: lecun-normal kernel and zero bias, or both zero
    (``zero_init``, the delta heads' output layers)."""

    def __init__(self, in_features: int, out_features: int, zero_init: bool = False):
        super().__init__(in_features, out_features)
        self.zero_init = zero_init

    def own_init(self, generator, device) -> Dict[str, torch.Tensor]:
        shape = tuple(self.weight.shape)
        if self.zero_init:
            weight = torch.zeros(shape, device=device)
        else:
            weight = lecun_normal(shape, shape[1], generator, device)
        return {"weight": weight, "bias": torch.zeros(shape[0], device=device)}


class LayerNorm(nn.Module):
    """flax ``LayerNorm(epsilon=1e-6)`` of an NHWC tensor, on NCHW: the
    channels (dim 1) of each pixel are normalized."""

    def __init__(self, n_channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n_channels))
        self.bias = nn.Parameter(torch.zeros(n_channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],), self.weight, self.bias, self.eps)
        return y.permute(0, 3, 1, 2)

    def own_init(self, generator, device) -> Dict[str, torch.Tensor]:
        n = self.weight.shape[0]
        return {"weight": torch.ones(n, device=device), "bias": torch.zeros(n, device=device)}


class GroupNorm(nn.GroupNorm):
    """flax ``GroupNorm(num_groups=32)``: contiguous channel groups, as
    torch's, with flax's epsilon 1e-6."""

    def __init__(self, n_channels: int, num_groups: int = 32, eps: float = 1e-6):
        super().__init__(num_groups, n_channels, eps=eps)

    def own_init(self, generator, device) -> Dict[str, torch.Tensor]:
        n = self.num_channels
        return {"weight": torch.ones(n, device=device), "bias": torch.zeros(n, device=device)}


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def init_params(module: nn.Module, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """A state dict for ``module`` drawn with flax's initializers (the
    modules' ``own_init``); ``module`` itself is not touched (it may live on
    the meta device)."""
    out = {}
    for prefix, sub in module.named_modules():
        if hasattr(sub, "own_init"):
            for name, t in sub.own_init(generator, device).items():
                out[f"{prefix}.{name}" if prefix else name] = t
    missing = set(module.state_dict()) - set(out)
    if missing:
        raise ValueError(f"no initializer for {sorted(missing)}")
    return out


def avg_pool_down(x: torch.Tensor, stride: int) -> torch.Tensor:
    """flax ``avg_pool(x, (2, 2), strides, padding=((0, 1), (0, 1)))``: the
    padded zero row and column count in the averages."""
    return F.avg_pool2d(F.pad(x, (0, 1, 0, 1)), 2, stride=stride)


class ConvNeXtBlock(nn.Module):
    """Depthwise 7x7 -> LN -> 1x1 x4 -> GELU -> 1x1, layer-scaled residual."""

    def __init__(self, n_channels: int, layer_scale_init: float = 1e-6):
        super().__init__()
        c = n_channels
        self.Conv_0 = Conv(c, c, 7, groups=c, kernel_init="trunc02")
        self.LayerNorm_0 = LayerNorm(c)
        self.Conv_1 = Conv(c, 4 * c, 1, kernel_init="trunc02")
        self.Conv_2 = Conv(4 * c, c, 1, kernel_init="trunc02")
        self.layer_scale = nn.Parameter(torch.full((c,), layer_scale_init))
        self.layer_scale_init = layer_scale_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = self.Conv_2(gelu(self.Conv_1(self.LayerNorm_0(self.Conv_0(x)))))
        return self.layer_scale[:, None, None] * z + x

    def own_init(self, generator, device) -> Dict[str, torch.Tensor]:
        return {"layer_scale": torch.full(tuple(self.layer_scale.shape), self.layer_scale_init,
                                          device=device)}


class ResidualBlock(nn.Module):
    """ConvNeXt residual block with optional downsampling: (strided 3x3 ->
    LN -> GELU -> block) + (average pool -> 1x1), then two blocks."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 downsample_n: int = 1):
        super().__init__()
        out_ch = out_channels or in_channels
        self.downsample_n = downsample_n
        self.Conv_0 = Conv(in_channels, out_ch, 3, stride=downsample_n, padding=1, kernel_init="trunc02")
        self.LayerNorm_0 = LayerNorm(out_ch)
        self.ConvNeXtBlock_0 = ConvNeXtBlock(out_ch)
        self.Conv_1 = Conv(in_channels, out_ch, 1, kernel_init="trunc02")
        self.ConvNeXtBlock_1 = ConvNeXtBlock(out_ch)
        self.ConvNeXtBlock_2 = ConvNeXtBlock(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = self.ConvNeXtBlock_0(gelu(self.LayerNorm_0(self.Conv_0(x))))
        y = avg_pool_down(x, self.downsample_n) if self.downsample_n > 1 else x
        z = z + self.Conv_1(y)
        return self.ConvNeXtBlock_2(self.ConvNeXtBlock_1(z))


class LatentHyperNet(nn.Module):
    """Pyramidal latent encoder: one ResidualBlock per latent level (x2
    downsampling between levels) with a 1x1 head per level.

    Input [B, 3, H, W]; output: list of [B, 1, ceil(H / 2^i), ceil(W / 2^i)]."""

    def __init__(self, n_latents: int = 7, n_hidden_channels: int = 64, in_channels: int = 3):
        super().__init__()
        self.n_latents = n_latents
        for i in range(n_latents):
            self.add_module(f"ResidualBlock_{i}", ResidualBlock(
                in_channels if i == 0 else n_hidden_channels, n_hidden_channels,
                downsample_n=1 if i == 0 else 2))
            self.add_module(f"Conv_{i}", Conv(n_hidden_channels, 1, 1, kernel_init="trunc02"))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outputs = []
        for i in range(self.n_latents):
            x = getattr(self, f"ResidualBlock_{i}")(x)
            outputs.append(getattr(self, f"Conv_{i}")(x))
        return outputs


@lru_cache(maxsize=64)
def _device_resize_weights(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """``resize_weights`` on ``device``, copied there once (a forward then
    copies nothing from the host, as a CUDA graph's capture requires)."""
    return resize_weights(in_size, out_size).to(device)


def resize_weights(in_size: int, out_size: int) -> torch.Tensor:
    """[out, in] weights of ``jax.image.resize(..., "bicubic")`` along one
    axis (``jax._src.image.scale.compute_weight_mat``): Keys' cubic with
    a = -0.5 at half-pixel centres, the kernel widened by the downscale
    factor (JAX antialiases a downscale), each output's weights divided by
    their sum (so taps past the edge are dropped, not clamped), and an
    output whose centre falls outside the input set to zero."""
    scale = out_size / in_size
    kernel_scale = max(1.0 / scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float64) + 0.5) / scale - 0.5
    x = (sample[:, None] - torch.arange(in_size, dtype=torch.float64)[None, :]).abs() / kernel_scale
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = torch.where(x >= 2.0, torch.zeros_like(w), w)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None], w, torch.zeros_like(w)).to(torch.float32)


def upsample_latents(latents: Sequence[torch.Tensor], img_size: Tuple[int, int]) -> torch.Tensor:
    """Every latent grid [B, 1, h, w] resized (bicubic, as JAX's) to the
    image size and concatenated on the channels: [B, n_grids, H, W] (the
    double-backbone and small hypernets read it)."""
    h, w = img_size
    resized = []
    for y in latents:
        wy = _device_resize_weights(y.shape[-2], h, y.device)
        wx = _device_resize_weights(y.shape[-1], w, y.device)
        resized.append(wy @ y @ wx.T)
    return torch.cat(resized, dim=1)


class MLP(nn.Module):
    """input -> hidden -> [hidden] * n_hidden_layers -> output, ReLU
    activations, optional output activation; ``zero_init_output`` starts
    the output (the deltas) at zero."""

    def __init__(self, in_features: int, output_size: int, hidden_size: int, n_hidden_layers: int,
                 output_activation: Optional[str] = None, zero_init_output: bool = False):
        super().__init__()
        if output_activation not in (None, "tanh", "relu", "leaky_relu"):
            raise ValueError(f"Unknown output activation {output_activation}")
        self.n_layers = n_hidden_layers + 2
        self.output_activation = output_activation
        self.Dense_0 = Dense(in_features, hidden_size)
        for i in range(1, n_hidden_layers + 1):
            self.add_module(f"Dense_{i}", Dense(hidden_size, hidden_size))
        self.add_module(f"Dense_{n_hidden_layers + 1}",
                        Dense(hidden_size, output_size, zero_init=zero_init_output))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers - 1):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        x = getattr(self, f"Dense_{self.n_layers - 1}")(x)
        if self.output_activation == "tanh":
            x = torch.tanh(x)
        elif self.output_activation == "relu":
            x = torch.relu(x)
        elif self.output_activation == "leaky_relu":
            x = F.leaky_relu(x, negative_slope=0.2)
        return x
