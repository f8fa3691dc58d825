"""Learned upsampling: symmetric separable filters, cascaded x2 steps.

Counterpart of ``coolchic_tpu/models/upsampling.py``. Half kernels are the
parameters and are mirrored at use time. Each x2 step is two 1-D transposed
convolutions (stride 2) over the edge-padded running tensor, cropped by
``2*(k//2) - 1 + k//2``; each pre-concat filter is two zero-padded 1-D
convolutions plus a residual. The latent channels ride the batch axis, so one
1-channel kernel serves every channel.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

UpsParams = Dict[str, List[torch.Tensor]]


def half_kernel_size(target_k_size: int) -> int:
    return (target_k_size + 1) // 2


def symmetric_kernel_1d(half: torch.Tensor, target_k_size: int) -> torch.Tensor:
    """(a b c) -> (a b c c b a) for even k, (a b c b a) for odd k."""
    return torch.cat([half, torch.flip(half, (0,))[target_k_size % 2 :]])


def init_upsampling_params(
    ups_k_size: int,
    ups_preconcat_k_size: int,
    n_ups_kernel: int,
    n_ups_preconcat_kernel: int,
    device,
) -> UpsParams:
    """x2 filters: bilinear taps (1/4, 3/4) for k < 8, else the 4-tap core,
    right-aligned; pre-concat filters: Dirac (last element 1)."""
    n_half_ups = half_kernel_size(ups_k_size)
    if ups_k_size < 8:
        core = [1.0 / 4.0, 3.0 / 4.0]
    else:
        core = [0.0351562, 0.1054687, -0.2617187, -0.8789063]
    n_half_pre = half_kernel_size(ups_preconcat_k_size)

    def ups_half():
        h = torch.zeros(n_half_ups, device=device)
        h[n_half_ups - len(core) :] = torch.tensor(core, device=device)
        return h

    def pre_half():
        h = torch.zeros(n_half_pre, device=device)
        h[-1] = 1.0
        return h

    return {
        "ups": [ups_half() for _ in range(n_ups_kernel)],
        "preconcat": [pre_half() for _ in range(n_ups_preconcat_kernel)],
    }


def upsample_x2(x: torch.Tensor, half: torch.Tensor, k: int) -> torch.Tensor:
    """[C, H, W] -> [C, 2H, 2W]: edge-pad by k//2, transposed conv of stride
    2 along each axis, crop ``2*(k//2) - 1 + k//2``."""
    w1d = symmetric_kernel_1d(half, k)
    p0 = k // 2
    crop = 2 * p0 - 1 + k // 2
    _, h, w = x.shape
    y = F.pad(x[:, None], (0, 0, p0, p0), mode="replicate")
    y = F.conv_transpose2d(y, w1d.view(1, 1, k, 1), stride=(2, 1))[:, :, crop : crop + 2 * h]
    y = F.pad(y, (p0, p0, 0, 0), mode="replicate")
    y = F.conv_transpose2d(y, w1d.view(1, 1, 1, k), stride=(1, 2))[..., crop : crop + 2 * w]
    return y[:, 0]


def preconcat_filter(x: torch.Tensor, half: torch.Tensor, k: int) -> torch.Tensor:
    """Symmetric separable odd filter, zero padding, plus a residual."""
    w1d = symmetric_kernel_1d(half, k)
    y = F.conv2d(x[:, None], w1d.view(1, 1, k, 1), padding=(k // 2, 0))
    y = F.conv2d(y, w1d.view(1, 1, 1, k), padding=(0, k // 2))
    return y[:, 0] + x


def upsampling_apply(
    params: UpsParams,
    latents: Sequence[torch.Tensor],
    ups_k_size: int,
    ups_preconcat_k_size: int,
) -> torch.Tensor:
    """Cascade from the smallest grid up to a dense [sum(C_i), H_0, W_0].

    At each step the filtered high-resolution grid is concatenated before
    the upsampled running tensor (cropped to the ceil-divided target), so the
    final channel order is grid 0, grid 1, ..., grid L-1.
    """
    n_ups = len(params["ups"])
    n_pre = len(params["preconcat"])
    latents_rev = list(reversed(latents))
    acc = latents_rev[0]
    for idx, target in enumerate(latents_rev[1:]):
        x = upsample_x2(acc, params["ups"][idx % n_ups], ups_k_size)
        x = x[:, : target.shape[-2], : target.shape[-1]]
        high = preconcat_filter(target, params["preconcat"][idx % n_pre], ups_preconcat_k_size)
        acc = torch.cat([high, x], dim=0)
    return acc
