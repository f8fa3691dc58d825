"""Mixed-size batching: a smaller image inside a padded buffer, with the
semantics of the unpadded encode.

Counterpart of ``coolchic_tpu/models/masking.py``. ``valid_hw`` is an integer
tensor, ``[2]`` (true height, width) for one image or ``[B, 2]`` for a batch,
never a Python int, so one batch holds different true sizes. Three operations
keep the padded math exact:

  * latents outside the valid pyramid are forced to zero: the ARM context and
    the pre-concat filter pad with zeros, so valid positions see what the
    unpadded encode's padding would give them;
  * the rate is masked, which takes padded latents out of the RD cost;
  * before every replicate-padded op (x2 upsampling, k > 1 synthesis
    convolutions) the buffer beyond the valid edge is overwritten with the
    replicated edge: replicate padding at the true image boundary.
"""

from __future__ import annotations

from typing import Tuple

import torch


def valid_mask_2d(
    buf_h: int, buf_w: int, hv: torch.Tensor, wv: torch.Tensor, dtype=torch.float32
) -> torch.Tensor:
    """[..., buf_h, buf_w] mask, 1 inside the valid (hv, wv) region and 0
    outside; the leading axes are those of ``hv`` / ``wv`` ([] or [B])."""
    row = torch.arange(buf_h, device=hv.device) < hv[..., None]
    col = torch.arange(buf_w, device=wv.device) < wv[..., None]
    return (row[..., :, None] & col[..., None, :]).to(dtype)


def replicate_extend(x: torch.Tensor, hv: torch.Tensor, wv: torch.Tensor) -> torch.Tensor:
    """Overwrite everything beyond the valid (hv, wv) region of a
    [..., H, W] tensor with the replicated valid edge. ``hv`` and ``wv``
    broadcast against the leading axes of ``x`` (right-aligned): [] for one
    image, [B] for [C, B, H, W], [B, 1] for [B, C, H, W]. A gather along each
    axis, whose backward is a scatter-add."""
    h, w = x.shape[-2], x.shape[-1]
    ri = torch.minimum(torch.arange(h, device=x.device), hv[..., None] - 1)
    ci = torch.minimum(torch.arange(w, device=x.device), wv[..., None] - 1)
    ri, ci = ri[..., :, None], ci[..., None, :]
    lead = (1,) * (x.dim() - ri.dim())  # take_along_dim wants equal ranks
    x = torch.take_along_dim(x, ri.reshape(lead + ri.shape), dim=-2)
    return torch.take_along_dim(x, ci.reshape(lead + ci.shape), dim=-1)


def level_valid_hw(valid_hw: torch.Tensor, level: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ceil-divided valid dims of latent grid ``level`` (the ceil division of
    ``CoolChicConfig.latent_shapes``), each [] or [B]."""
    s = 1 << level
    return (valid_hw[..., 0] + s - 1) // s, (valid_hw[..., 1] + s - 1) // s
