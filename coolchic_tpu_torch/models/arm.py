"""Auto-Regressive Module (ARM): Laplace entropy model over causal contexts.

Counterpart of ``coolchic_tpu/models/arm.py``. This module is the plain
PyTorch version of the ARM rate: the training forward runs it (it needs the
backward), and the CUDA kernel of ``ops/arm_rate.py`` is held to it.

Context of pixel (i, j): ``dim_arm`` values of the latent plane zero-padded
by 4, at the (dy, dx) offsets of ``context_offsets`` (format constants: the
C++ decoder hardcodes the same stencils).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from coolchic_tpu_torch.models.quantizer import clip_like_jax

MASK_SIZE = 9
PAD = (MASK_SIZE - 1) // 2  # 4

# Indices of the context pixels inside the flattened 9x9 causal window.
# fmt: off
NON_ZERO_PIXEL_CTX_INDEX: Dict[int, Tuple[int, ...]] = {
    8: (13, 22, 30, 31, 32, 37, 38, 39),
    16: (13, 14, 20, 21, 22, 23, 24, 28, 29, 30, 31, 32, 33, 37, 38, 39),
    24: (4, 11, 12, 13, 14, 15, 19, 20, 21, 22, 23, 24, 25, 28, 29, 30, 31,
         32, 33, 34, 36, 37, 38, 39),
    32: (2, 3, 4, 5, 10, 11, 12, 13, 14, 15, 16, 19, 20, 21, 22, 23, 24, 25,
         26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39),
}
# fmt: on

ArmParams = Dict[str, List[Dict[str, torch.Tensor]]]


def context_offsets(dim_arm: int) -> Tuple[Tuple[int, int], ...]:
    """(dy, dx) of each context pixel in the window zero-padded by 4:
    context p of pixel (i, j) is ``x_pad[i + dy, j + dx]``."""
    return tuple((idx // MASK_SIZE, idx % MASK_SIZE) for idx in NON_ZERO_PIXEL_CTX_INDEX[dim_arm])


def get_neighbors(x: torch.Tensor, dim_arm: int) -> torch.Tensor:
    """Causal contexts of a [..., C, H, W] grid as [..., C*H*W, dim_arm],
    raster order, channel-major (``dim_arm`` shifted slices of the zero-padded
    grid)."""
    c, h, w = x.shape[-3:]
    # Planes on one axis: stacking slices of more than three axes would copy
    # each slice to a contiguous tensor first.
    x_pad = F.pad(x.reshape(-1, h, w), (PAD, PAD, PAD, PAD))
    ctx = [x_pad[:, dy : dy + h, dx : dx + w] for (dy, dx) in context_offsets(dim_arm)]
    return torch.stack(ctx, dim=-1).reshape(*x.shape[:-3], c * h * w, dim_arm)


def init_arm_params(
    generator: torch.Generator, dim_arm: int, n_hidden_layers_arm: int, device
) -> ArmParams:
    """Hidden (residual) layers start at zero; the 2-wide head is
    N(0, 1) / 2^2; biases are zero."""
    layers = [
        {
            "weight": torch.zeros(dim_arm, dim_arm, device=device),
            "bias": torch.zeros(dim_arm, device=device),
        }
        for _ in range(n_hidden_layers_arm)
    ]
    out_channels = 2
    head = torch.randn(out_channels, dim_arm, generator=generator, device=device)
    layers.append(
        {"weight": head / out_channels**2, "bias": torch.zeros(out_channels, device=device)}
    )
    return {"layers": layers}


OUTER_SUM_CHUNK = 4096  # rows per batch entry of rows_outer_sum


def rows_outer_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^T b`` per image, [B, M, O] x [B, M, C] -> [B, O, C], with the sum
    over the M rows split into chunks of ``OUTER_SUM_CHUNK`` rows that are
    multiplied as separate batch entries and then added. One batched product of B > 1
    images would give each image's O x C result to a single thread block that
    walks all M rows (half a million here) alone."""
    n_images, m, _ = a.shape
    if n_images == 1:  # a plain product, whose sum the library splits itself (0.13 ms of a step)
        return (a[0].T @ b[0])[None]
    chunk = OUTER_SUM_CHUNK
    n_chunks = m // chunk
    main = n_chunks * chunk
    out = a[:, main:].mT @ b[:, main:]
    if n_chunks:
        parts = (a[:, :main].reshape(n_images, n_chunks, chunk, -1).mT
                 @ b[:, :main].reshape(n_images, n_chunks, chunk, -1))
        out = out + parts.sum(dim=1)
    return out


class BatchedLinear(torch.autograd.Function):
    """``x W^T + b`` of B layers at once: x [B, M, C], W [B, O, C], b [B, O].
    The backward takes the weights' gradient with ``rows_outer_sum``."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return torch.baddbmm(bias.unsqueeze(-2), x, weight.mT)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        return grad @ weight, rows_outer_sum(grad, x), grad.sum(dim=-2)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``x W^T + b`` on [M, C] rows, or of B layers at once on [B, M, C]."""
    if x.dim() == 3:
        return BatchedLinear.apply(x, weight, bias)
    return x @ weight.T + bias


def arm_apply(
    params: ArmParams, ctx: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ARM MLP on [M, C] contexts: residual layers ``relu(x W^T + b + x)``,
    then the 2-wide head. Returns (mu, scale, log_scale), each [M], with
    ``scale = exp(clip(log_scale - 4, -4.6, 5))``. With a leading [B] axis
    on the contexts and on every weight and bias, B ARMs run at once
    (batched matrix products)."""
    x = ctx
    layers = params["layers"]
    for layer in layers[:-1]:
        x = torch.relu(linear(x, layer["weight"], layer["bias"]) + x)
    head = layers[-1]
    raw = linear(x, head["weight"], head["bias"])
    mu = raw[..., 0]
    log_scale = raw[..., 1]
    scale = torch.exp(clip_like_jax(log_scale - 4.0, -4.6, 5.0))
    return mu, scale, log_scale


def laplace_cdf(x: torch.Tensor, mu: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    shifted = x - mu
    return 0.5 - 0.5 * torch.sign(shifted) * torch.expm1(-torch.abs(shifted) / scale)


def latent_rate_bits(y_hat: torch.Tensor, mu: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """-log2(CDF(y + 1/2) - CDF(y - 1/2)), the probability clamped at 2^-16."""
    proba = clip_like_jax(
        laplace_cdf(y_hat + 0.5, mu, scale) - laplace_cdf(y_hat - 0.5, mu, scale), 2.0**-16
    )
    return -torch.log2(proba)


# Where rtol = atol = 1e-4 stops covering what f32 resolves (see rate_tolerance).
STEEP_SCALE = 0.125
TAIL_RATE = 12.0


def rate_tolerance(rate: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-latent tolerance for comparing two f32 evaluations of the rate
    whose ARM sums run in different orders (or whose exp / expm1 differ by
    an ulp), given the reference ``rate`` and ``scale``.

    Every latent is held at rtol = atol = 1e-4. Two kinds get one more term:

      * steep, ``scale < STEEP_SCALE``: the rate moves by at most
        ~1/(scale ln 2) bits per unit of mu, and another summation order
        moves mu by ~1e-6, so add ``2^-17 / (scale ln 2)`` (2x margin): up
        to ~1.1e-3 bits at the 0.01 scale floor, under 1e-4 above 1/8;
      * tail, ``rate > TAIL_RATE``: the probability 2^-rate is a difference
        of two CDF values near 0 or 1, so an ulp of those values moves the
        rate by ~2^(rate - 23) / ln 2 bits; add ``2^(rate - 21)`` (2x
        margin). Below 12 bits one such ulp stays under 1e-4 (1 + rate).
    """
    r = rate.abs()
    steep = torch.where(scale < STEEP_SCALE, 2.0**-17 / (scale * math.log(2.0)), 0.0)
    tail = torch.where(r > TAIL_RATE, torch.exp2(r - 21.0), 0.0)
    return 1e-4 + 1e-4 * r + steep + tail


def arm_rate_plain(
    latents: Sequence[torch.Tensor], params: ArmParams, dim_arm: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flat rate [n_latents] over a pyramid of [C, H, W] grids, in forward
    order (grid-major, then channel, then raster), plus mu and log_scale.
    With a leading [B] axis on the grids and the params: [B, n_latents]."""
    flat = torch.cat([y.flatten(-3) for y in latents], dim=-1)
    ctx = torch.cat([get_neighbors(y, dim_arm) for y in latents], dim=-2)
    mu, scale, log_scale = arm_apply(params, ctx)
    return latent_rate_bits(flat, mu, scale), mu, log_scale
