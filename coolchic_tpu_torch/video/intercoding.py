"""Inter-frame tools: optical-flow warping and bi-prediction.

Counterpart of ``coolchic_tpu/video/intercoding.py``, plain PyTorch (the
JAX package computes these in plain ``jnp`` too, outside any Pallas kernel).
Every function takes a leading [B] axis: a batch of B frames, each with its
own flows and references (B = 1 for one frame).

The float functions are the training forward of P/B frames and are
differentiable in the flows and gains. The references carry no gradient:
the bilinear taps are gathered at detached integer positions, and the
gradient reaches a flow only through the fractional offsets ``fx`` / ``fy``.
The clips give JAX's gradient at a tie (``models/quantizer.py::
clip_like_jax``): a zero flow puts every border sample on a clip bound.

``inter_predict_int`` is the decoder's fixed-point motion compensation
(``bitstream/inter.py::process_inter_int``, on int32 tensors), the eval
forward of P/B frames: the encoder's estimate is then what the stream
decodes to.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from coolchic_tpu_torch.models.quantizer import clip_like_jax


def _grid(h: int, w: int, like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row and column index of every pixel, [H, W] each, of ``like``'s type."""
    yy = torch.arange(h, dtype=like.dtype, device=like.device)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=like.dtype, device=like.device)[None, :].expand(h, w)
    return yy, xx


def _gather(x: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """``x[b, :, yi[b], xi[b]]`` for every b: x [B, C, H, W], integer indices
    [B, H, W] -> [B, C, H, W]."""
    b, c, h, w = x.shape
    idx = (yi.long() * w + xi).reshape(b, 1, h * w).expand(b, c, h * w)
    return torch.gather(x.reshape(b, c, h * w), 2, idx).reshape(b, c, h, w)


def _bilinear(x: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of ``x`` [B, C, H, W] at positions ``sx`` / ``sy``
    [B, H, W] that lie inside the frame; differentiable in the positions."""
    _, _, h, w = x.shape
    x0f, y0f = torch.floor(sx.detach()), torch.floor(sy.detach())
    x0, y0 = x0f.long(), y0f.long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = (sx - x0f).unsqueeze(1)
    fy = (sy - y0f).unsqueeze(1)
    x = x.detach()
    return (
        _gather(x, y0, x0) * (1 - fx) * (1 - fy)
        + _gather(x, y0, x1) * fx * (1 - fy)
        + _gather(x, y1, x0) * (1 - fx) * fy
        + _gather(x, y1, x1) * fx * fy
    )


def warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear backward warp of ``x`` [B, C, H, W] by ``flow`` [B, 2, H, W]
    (dx, dy in pixels), border padding, and zero where the sample position
    leaves the frame."""
    _, _, h, w = x.shape
    yy, xx = _grid(h, w, flow)
    sx = xx + flow[:, 0]
    sy = yy + flow[:, 1]
    inb = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    out = _bilinear(x, clip_like_jax(sx, 0.0, w - 1), clip_like_jax(sy, 0.0, h - 1))
    return out * inb.unsqueeze(1)


def bipred(ref0: torch.Tensor, ref1: torch.Tensor, flow0: torch.Tensor, flow1: torch.Tensor,
           beta: torch.Tensor | float = 0.5) -> torch.Tensor:
    """Bi-directional prediction: the beta-weighted blend of two warped
    references."""
    return beta * warp(ref0, flow0) + (1.0 - beta) * warp(ref1, flow1)


def warp_decoder_style(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear backward warp with the sample position clamped to the frame
    (the edge is replicated, never zeroed): the float twin of the
    decoder's fixed-point warp."""
    _, _, h, w = x.shape
    yy, xx = _grid(h, w, flow)
    sx = clip_like_jax(xx + flow[:, 0], 0.0, w - 1)
    sy = clip_like_jax(yy + flow[:, 1], 0.0, h - 1)
    return _bilinear(x, sx, sy)


def inter_predict(raw_out: torch.Tensor, ref0: torch.Tensor, ref1: Optional[torch.Tensor],
                  flow_gain: int | float = 1) -> torch.Tensor:
    """Float inter reconstruction from the synthesis output [B, 6|9, H, W],
    the training forward of P/B frames. Channels:

      P (6): residue[0:3], flow xy[3:5], alpha[5]
      B (9): residue[0:3], flow0 xy[3:5], alpha[5], flow1 xy[6:8], beta[8]

    with each gain channel mapped through ``clip(v + 0.5, 0, 1)``."""
    c = raw_out.shape[1]
    alpha = clip_like_jax(raw_out[:, 5] + 0.5, 0.0, 1.0).unsqueeze(1)
    if c == 6:
        pred = warp_decoder_style(ref0, raw_out[:, 3:5] * flow_gain)
        return pred * alpha + raw_out[:, :3]
    if c != 9 or ref1 is None:
        raise ValueError(f"inter prediction takes 6 channels and one reference or 9 and two, "
                         f"found {c} channels")
    beta = clip_like_jax(raw_out[:, 8] + 0.5, 0.0, 1.0).unsqueeze(1)
    p0 = warp_decoder_style(ref0, raw_out[:, 3:5] * flow_gain) * beta
    p1 = warp_decoder_style(ref1, raw_out[:, 6:8] * flow_gain) * (1.0 - beta)
    return (p0 + p1) * alpha + raw_out[:, :3]


# The decoder's fixed-point motion compensation on int32 tensors (eval only).
PREC = 12  # SYN_LAYER_PRECISION (bitstream/inter.py)
ONE = 1 << PREC
HALF = 1 << (PREC - 1)
FLOW_CLAMP = 1 << 22  # |flow| in 12-frac units: flow * flow_gain (<= 255) stays in int32


def _gain_int(raw_ch: torch.Tensor, invert: bool) -> torch.Tensor:
    g = torch.clamp(raw_ch + HALF, 0, ONE)
    return (ONE - g) if invert else g


def _floor_axis(p: torch.Tensor, n: int):
    """Cell, next cell and 12-frac offset of a fixed-point position, with
    the decoder's rules: exact negative multiples land one cell lower, and
    a position outside [0, n - 1) takes the edge cell with no offset."""
    b0 = torch.where(p < 0, (p - (ONE - 1)) >> PREC, p >> PREC)
    d = p - (b0 << PREC)
    out = (b0 < 0) | (b0 >= n - 1)
    b0 = torch.clamp(b0, 0, n - 1)
    return b0, torch.where(out, b0, b0 + 1), torch.where(out, 0, d)


def _warp_int(ref: torch.Tensor, raw: torch.Tensor, xy_idx: int, gain_idx: int, flow_gain: int,
              add_residue: bool, invert_gain: bool = False) -> torch.Tensor:
    """Integer bilinear warp of ``ref`` [B, 3, H, W] (12-frac int32) by the
    flow of ``raw`` channels [xy_idx, xy_idx + 1], times the gain channel."""
    _, _, h, w = ref.shape
    yy, xx = _grid(h, w, raw)
    fl = torch.clamp(raw[:, xy_idx : xy_idx + 2], -FLOW_CLAMP, FLOW_CLAMP)
    bx0, bx1, dx = _floor_axis(fl[:, 0] * flow_gain + (xx << PREC), w)
    by0, by1, dy = _floor_axis(fl[:, 1] * flow_gain + (yy << PREC), h)
    dx, dy = dx.unsqueeze(1), dy.unsqueeze(1)
    gain = _gain_int(raw[:, gain_idx], invert_gain).unsqueeze(1)
    a = _gather(ref, by0, bx0)
    b = _gather(ref, by0, bx1)
    cc = _gather(ref, by1, bx0)
    d = _gather(ref, by1, bx1)
    h0 = a + (((b - a) * dx) >> PREC)
    h1 = cc + (((d - cc) * dx) >> PREC)
    v = ((h1 - h0) * dy) >> PREC
    out = ((h0 + v) * gain) >> PREC
    return out + raw[:, :3] if add_residue else out


@torch.no_grad()
def inter_predict_int(raw12: torch.Tensor, ref0_12: torch.Tensor, ref1_12: Optional[torch.Tensor],
                      flow_gain: int) -> torch.Tensor:
    """Integer inter reconstruction: ``raw12`` is the [B, 6|9, H, W]
    synthesis output and the references are stored [B, 3, H, W] frames, all
    int32 at 12 fractional bits. Equal, frame by frame, to
    ``bitstream/inter.py::process_inter_int`` wherever no flow exceeds the
    clamp."""
    c = raw12.shape[1]
    if c == 6:
        return _warp_int(ref0_12, raw12, xy_idx=3, gain_idx=5, flow_gain=flow_gain,
                         add_residue=True)
    if c != 9 or ref1_12 is None:
        raise ValueError(f"inter prediction takes 6 channels and one reference or 9 and two, "
                         f"found {c} channels")
    p0 = _warp_int(ref0_12, raw12, xy_idx=3, gain_idx=8, flow_gain=flow_gain, add_residue=False)
    p1 = _warp_int(ref1_12, raw12, xy_idx=6, gain_idx=8, flow_gain=flow_gain, add_residue=False,
                   invert_gain=True)
    gain = _gain_int(raw12[:, 5], invert=False).unsqueeze(1)
    return (((p0 + p1) * gain) >> PREC) + raw12[:, :3]


@torch.no_grad()
def inter_levels(raw_out: torch.Tensor, ref0: torch.Tensor, ref1: Optional[torch.Tensor],
                 flow_gain: int, bitdepth: int = 8) -> torch.Tensor:
    """The integer levels [B, 3, H, W] (int32, 0 .. 2^bitdepth - 1) a decoder
    reconstructs from the float synthesis output [B, 6|9, H, W] and the
    decoded float references [B, 3, H, W]: the output at 12 fractional bits,
    each reference through the decoder's storage
    ``(round(ref * max_dyn) << 12) // max_dyn``, the fixed-point prediction,
    then ``clip((out * max_dyn + 2048) >> 12, 0, max_dyn)``."""
    md = (1 << bitdepth) - 1

    def store12(ref):
        return (torch.round(ref * float(md)).to(torch.int32) << PREC) // md

    raw12 = torch.round(raw_out * float(ONE)).to(torch.int32)
    out12 = inter_predict_int(raw12, store12(ref0), None if ref1 is None else store12(ref1),
                              flow_gain)
    return torch.clamp((out12 * md + HALF) >> PREC, 0, md)
