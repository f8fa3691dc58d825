"""Fixed-point inter-frame prediction: integer twins of the reference
decoder's motion compensation (reference: coolchic/cpp/ccdecapi.cpp:496-671
warp / bpred / process_inter), vectorized in numpy. Counterpart of
``coolchic_tpu/bitstream/inter.py``; only the decoder uses it so far.

A decoded inter frame carries extra synthesis channels at 12 fractional
bits (SYN_LAYER_PRECISION):

  * P (6 ch): residue[0:3], flow xy[3:5], alpha[5]
  * B (9 ch): residue[0:3], flow0 xy[3:5], alpha[5], flow1 xy[6:8], beta[8]

and the prediction is
  P:  out = warp(ref0, flow * flow_gain) * alpha + residue
  B:  out = (warp(ref0, flow0) * beta + warp(ref1, flow1) * (1 - beta))
            * alpha + residue
with every multiply/shift in int32/int64 arithmetic exactly as the C++.
"""

from __future__ import annotations

import numpy as np

PREC = 12  # SYN_LAYER_PRECISION
ONE = 1 << PREC
HALF = 1 << (PREC - 1)


def _gain(raw_ch: np.ndarray, invert: bool) -> np.ndarray:
    """gain = clip(raw + 0.5, 0, 1) in 12-frac ints; invert -> 1 - gain
    (reference: ccdecapi.cpp:555-566)."""
    g = np.clip(raw_ch + HALF, 0, ONE)
    return (ONE - g) if invert else g


def warp_int(
    ref: np.ndarray,
    raw: np.ndarray,
    xy_idx: int,
    gain_idx: int,
    flow_gain: int,
    add_residue: bool,
    invert_gain: bool = False,
) -> np.ndarray:
    """Integer bilinear warp of ``ref`` [3, H, W] (12-frac) by the flow
    stored in ``raw`` channels [xy_idx, xy_idx+1], scaled by the per-pixel
    gain channel (reference: ccdecapi.cpp:496-600 warp)."""
    _, h, w = ref.shape
    raw = raw.astype(np.int64)
    ref = ref.astype(np.int64)
    yy, xx = np.meshgrid(np.arange(h, dtype=np.int64),
                         np.arange(w, dtype=np.int64), indexing="ij")
    px = raw[xy_idx] * flow_gain + (xx << PREC)
    py = raw[xy_idx + 1] * flow_gain + (yy << PREC)

    # floor with the reference's negative-branch quirk: exact negative
    # multiples land one cell lower ((px - (ONE-1)) >> PREC).
    bx0 = np.where(px < 0, (px - (ONE - 1)) >> PREC, px >> PREC)
    dx = px - (bx0 << PREC)
    low = bx0 < 0
    high = bx0 >= w - 1
    bx0 = np.clip(bx0, 0, w - 1)
    bx1 = np.where(low | high, bx0, bx0 + 1)
    dx = np.where(low | high, 0, dx)

    by0 = np.where(py < 0, (py - (ONE - 1)) >> PREC, py >> PREC)
    dy = py - (by0 << PREC)
    lowy = by0 < 0
    highy = by0 >= h - 1
    by0 = np.clip(by0, 0, h - 1)
    by1 = np.where(lowy | highy, by0, by0 + 1)
    dy = np.where(lowy | highy, 0, dy)

    gain = _gain(raw[gain_idx], invert_gain)

    out = np.empty((3, h, w), np.int64)
    for c in range(3):
        plane = ref[c]
        a = plane[by0, bx0]
        b = plane[by0, bx1]
        cc = plane[by1, bx0]
        d = plane[by1, bx1]
        h0 = a + (((b - a) * dx) >> PREC)
        h1 = cc + (((d - cc) * dx) >> PREC)
        v = ((h1 - h0) * dy) >> PREC
        out[c] = ((h0 + v) * gain) >> PREC
        if add_residue:
            out[c] += raw[c]
    return out


def bpred_int(pred0: np.ndarray, pred1: np.ndarray, raw: np.ndarray,
              gain_idx: int) -> np.ndarray:
    """(pred0 + pred1) * alpha + residue (reference: ccdecapi.cpp:602-646)."""
    raw = raw.astype(np.int64)
    gain = _gain(raw[gain_idx], invert=False)
    return (((pred0 + pred1) * gain) >> PREC) + raw[:3]


def process_inter_int(
    raw: np.ndarray,
    ref0: np.ndarray | None,
    ref1: np.ndarray | None,
    flow_gain: int,
) -> np.ndarray:
    """Inter reconstruction of one decoded frame
    (reference: ccdecapi.cpp:649-671 process_inter). ``raw`` is the
    [6 or 9, H, W] synthesis output at 12 frac bits; refs are stored
    [3, H, W] 12-frac reference frames."""
    c = raw.shape[0]
    if c == 6:
        if ref0 is None:
            raise ValueError("P frame without a reference")
        return warp_int(ref0, raw, xy_idx=3, gain_idx=5, flow_gain=flow_gain,
                        add_residue=True)
    if c != 9:
        raise ValueError(f"inter frame must have 6 or 9 channels, got {c}")
    if ref0 is None or ref1 is None:
        raise ValueError("B frame needs two refs")
    p0 = warp_int(ref0, raw, xy_idx=3, gain_idx=8, flow_gain=flow_gain,
                  add_residue=False)
    p1 = warp_int(ref1, raw, xy_idx=6, gain_idx=8, flow_gain=flow_gain,
                  add_residue=False, invert_gain=True)
    return bpred_int(p0, p1, raw, gain_idx=5)
