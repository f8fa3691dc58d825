"""Synthesis transform: a small stack of 2-D convolutions.

Counterpart of ``coolchic_tpu/models/synthesis.py``. Each layer:
replicate-pad, convolve, optional residual add, then optional ReLU.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from coolchic_tpu_torch.models.masking import replicate_extend

SynParams = Dict[str, List[Dict[str, torch.Tensor]]]


def init_synthesis_params(
    generator: torch.Generator,
    input_ft: int,
    parsed_layers: Sequence[Tuple[int, int, bool, bool]],
    device,
) -> SynParams:
    """Zero biases; residual layers start at zero; linear layers are
    U(-sqrt(k), sqrt(k)) / out_ft^2 with k = 1 / (C_in * kernel_size^2)."""
    layers = []
    in_ft = input_ft
    for out_ft, k_size, residual, _relu in parsed_layers:
        shape = (out_ft, in_ft, k_size, k_size)
        if residual:
            weight = torch.zeros(shape, device=device)
        else:
            sqrt_k = math.sqrt(1.0 / (in_ft * k_size * k_size))
            u = torch.rand(shape, generator=generator, device=device)
            weight = (u - 0.5) * 2.0 * sqrt_k / out_ft**2
        layers.append({"weight": weight, "bias": torch.zeros(out_ft, device=device)})
        in_ft = out_ft
    return {"layers": layers}


def synthesis_apply(
    params: SynParams,
    x: torch.Tensor,
    parsed_layers: Sequence[Tuple[int, int, bool, bool]],
    valid_hw: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[C_in, H, W] dense latent -> [C_out, H, W] image; with a leading [B]
    axis on ``x`` and on every weight and bias, B decoders at once: the
    images' channels lie side by side on the channel axis and each layer is
    one convolution with ``groups = B``.

    ``valid_hw`` ([2] or [B, 2], see ``models/masking.py``): before every
    k > 1 convolution the buffer is replicate-extended at the true image
    edge; 1x1 layers are pointwise and need nothing.
    """
    b = x.shape[0] if x.dim() == 4 else 1
    h, w = x.shape[-2:]
    y = x.reshape(1, -1, h, w)
    for layer, (_out_ft, k_size, residual, relu) in zip(params["layers"], parsed_layers):
        pad = (k_size - 1) // 2
        if pad and valid_hw is not None:
            hv, wv = valid_hw[..., 0, None], valid_hw[..., 1, None]  # against [B, C]
            y = replicate_extend(y.view(b, -1, h, w), hv, wv).view(y.shape)
        inp = F.pad(y, (pad, pad, pad, pad), mode="replicate") if pad else y
        weight = layer["weight"].reshape(-1, *layer["weight"].shape[-3:])
        out = F.conv2d(inp, weight, layer["bias"].reshape(-1), groups=b)
        if residual:
            out = out + y
        if relu:
            out = torch.relu(out)
        y = out
    return y.view(*x.shape[:-3], -1, h, w)
