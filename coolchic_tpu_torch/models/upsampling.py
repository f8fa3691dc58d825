"""Learned upsampling: symmetric separable filters, cascaded x2 steps.

Counterpart of ``coolchic_tpu/models/upsampling.py``. Half kernels are the
parameters and are mirrored at use time. Each x2 step is two 1-D transposed
convolutions (stride 2) over the edge-padded running tensor, cropped by
``2*(k//2) - 1 + k//2``; each pre-concat filter is two zero-padded 1-D
convolutions plus a residual. The latent channels ride the batch axis, so one
1-channel kernel serves every channel; a batch of images rides the channel
axis as groups, each image with its own filters.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from coolchic_tpu_torch.models.masking import level_valid_hw, replicate_extend

UpsParams = Dict[str, List[torch.Tensor]]


def half_kernel_size(target_k_size: int) -> int:
    return (target_k_size + 1) // 2


def symmetric_kernel_1d(half: torch.Tensor, target_k_size: int) -> torch.Tensor:
    """(a b c) -> (a b c c b a) for even k, (a b c b a) for odd k, along the
    last axis."""
    return torch.cat([half, torch.flip(half, (-1,))[..., target_k_size % 2 :]], dim=-1)


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
    """[C, B, H, W] -> [C, B, 2H, 2W] with one filter per image (``half``
    [B, n], or [n] when B = 1): edge-pad by k//2, transposed conv of stride 2
    along each axis with the images as groups, crop ``2*(k//2) - 1 + k//2``."""
    w1d = symmetric_kernel_1d(half, k)
    p0 = k // 2
    crop = 2 * p0 - 1 + k // 2
    _, b, h, w = x.shape
    y = F.pad(x, (0, 0, p0, p0), mode="replicate")
    y = F.conv_transpose2d(y, w1d.reshape(b, 1, k, 1), stride=(2, 1), groups=b)
    y = F.pad(y[:, :, crop : crop + 2 * h], (p0, p0, 0, 0), mode="replicate")
    y = F.conv_transpose2d(y, w1d.reshape(b, 1, 1, k), stride=(1, 2), groups=b)
    return y[..., crop : crop + 2 * w]


def preconcat_filter(x: torch.Tensor, half: torch.Tensor, k: int) -> torch.Tensor:
    """Symmetric separable odd filter on [C, B, H, W] (one filter per image,
    the images as groups), zero padding, plus a residual."""
    w1d = symmetric_kernel_1d(half, k)
    b = x.shape[1]
    y = F.conv2d(x, w1d.reshape(b, 1, k, 1), padding=(k // 2, 0), groups=b)
    y = F.conv2d(y, w1d.reshape(b, 1, 1, k), padding=(0, k // 2), groups=b)
    return y + x


def upsampling_apply(
    params: UpsParams,
    latents: Sequence[torch.Tensor],
    ups_k_size: int,
    ups_preconcat_k_size: int,
    valid_hw: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Cascade from the smallest grid up to a dense [sum(C_i), H_0, W_0]; on
    [B, C_i, H_i, W_i] grids with [B, n] half kernels, B cascades at once to
    [B, sum(C_i), H_0, W_0].

    At each step the filtered high-resolution grid is concatenated before
    the upsampled running tensor (cropped to the ceil-divided target), so the
    final channel order is grid 0, grid 1, ..., grid L-1. Inside, the tensors
    are [C, B, H, W]: the latent channels ride the convolutions' batch axis,
    so one 1-channel filter serves every channel, and the images ride their
    channel axis with ``groups = B``, so each image keeps its own filter.

    ``valid_hw`` ([2] or [B, 2], see ``models/masking.py``): before each
    replicate-padded x2 step the running tensor is replicate-extended at its
    level's true edge. The zero-padded pre-concat filter needs nothing, since
    padded latents are zeros already.
    """
    batched = latents[0].dim() == 4
    n_ups = len(params["ups"])
    n_pre = len(params["preconcat"])
    latents_rev = [y.transpose(0, 1) if batched else y[:, None] for y in reversed(latents)]
    n = len(latents_rev)
    acc = latents_rev[0]
    for idx, target in enumerate(latents_rev[1:]):
        if valid_hw is not None:
            acc = replicate_extend(acc, *level_valid_hw(valid_hw, n - 1 - idx))
        x = upsample_x2(acc, params["ups"][idx % n_ups], ups_k_size)
        x = x[..., : target.shape[-2], : target.shape[-1]]
        high = preconcat_filter(target, params["preconcat"][idx % n_pre], ups_preconcat_k_size)
        acc = torch.cat([high, x], dim=0)
    return acc.transpose(0, 1) if batched else acc[:, 0]
