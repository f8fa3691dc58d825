"""Fixed-point (integer) ARM: bit-exact twin of the C++ decoder's ARM.

Counterpart of ``coolchic_tpu/bitstream/armint.py``. It stays numpy on the
host: the int32 products must wrap and the divisions truncate toward zero
exactly as the C++ decoder's do.

The bitstream's latent entropy coding is driven by (mu, log sigma) computed
with int32 arithmetic so encoder and decoder agree bit for bit
(reference: coolchic/enc/bitstream/armint.py:19-261, C-style to-zero
division at :95-109; C++ twin coolchic/cpp/arm_cpu.cpp).

Weights are fixed point with 8 fractional bits, biases with 16
(reference: enc/utils/misc.py:147-150, cpp/common.h:26-27).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from coolchic_tpu_torch.models.arm import MASK_SIZE, context_offsets

FPFB = 8  # fractional bits
FPFM = 1 << FPFB


def _round_half_away_int32(x: np.ndarray) -> np.ndarray:
    """round-half-away-from-zero then truncate toward zero, as the reference
    float->int conversion (armint.py:200-204)."""
    y = x + np.sign(x) * 0.5
    return np.where(y < 0, -(-y).astype(np.int32), y.astype(np.int32)).astype(np.int32)


def _div_to_zero(x: np.ndarray, d: int) -> np.ndarray:
    """C-style integer division (truncate toward zero) after adding the
    rounding offset sign(x) * d/2 (reference: armint.py:95-109)."""
    x = x + np.sign(x).astype(np.int32) * np.int32(d // 2)
    neg = -((-x) // d)
    pos = x // d
    return np.where(x < 0, neg, pos).astype(np.int32)


def integerize_arm_params(arm_params: Dict) -> List[Dict[str, np.ndarray]]:
    """Convert float ARM params (already quantized to multiples of their
    q-step) into the fixed-point representation: weight*2^8, bias*2^16
    (reference: armint.py:190-209)."""
    layers = []
    for layer in arm_params["layers"]:
        w = np.asarray(layer["weight"], np.float64) * FPFM
        b = np.asarray(layer["bias"], np.float64) * FPFM * FPFM
        layers.append(
            {"weight": _round_half_away_int32(w), "bias": _round_half_away_int32(b)}
        )
    return layers


def armint_forward(
    int_layers: List[Dict[str, np.ndarray]], ctx_int: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Integer ARM forward.

    Args:
        int_layers: output of ``integerize_arm_params``.
        ctx_int: [M, C] int32 contexts = latent values * 2^8.

    Returns:
        (mu_int [M], log_scale_int [M]) int32, at 8 fractional bits — these
        are exactly the ``mu*256`` / ``log_scale*256`` ints fed to the latent
        entropy coder (reference: armint.py:211-261,
        enc/bitstream/encode.py:549-567).
    """
    x = ctx_int.astype(np.int32)
    for layer in int_layers[:-1]:
        xx = x @ layer["weight"].T.astype(np.int32) + layer["bias"] + x * np.int32(FPFM)
        x = np.maximum(_div_to_zero(xx, FPFM), 0)
    head = int_layers[-1]
    xx = x @ head["weight"].T.astype(np.int32) + head["bias"]
    out = _div_to_zero(xx, FPFM)
    return out[:, 0], out[:, 1]


def context_int(latent_grid: np.ndarray, dim_arm: int) -> np.ndarray:
    """[C*H*W, dim_arm] int32 teacher-forced contexts (latent * 2^8), zero
    padded, matching models/arm.get_neighbors ordering."""
    pad = (MASK_SIZE - 1) // 2
    x = np.asarray(latent_grid, np.int32) * np.int32(FPFM)
    if x.ndim == 2:
        x = x[None]
    c, h, w = x.shape
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad)))
    cols = [xp[:, dy : dy + h, dx : dx + w] for dy, dx in context_offsets(dim_arm)]
    return np.stack(cols, -1).reshape(c * h * w, dim_arm).astype(np.int32)
