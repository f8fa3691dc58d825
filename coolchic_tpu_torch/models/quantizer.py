"""Differentiable quantization simulators (softround / noise / STE).

Counterpart of ``coolchic_tpu/models/quantizer.py``; ``.detach()`` takes the
place of ``stop_gradient``. The noise is either drawn here from a
``torch.Generator`` or handed in as a raw draw (``noise``: U(0, 1) samples
for Kumaraswamy, N(0, 1) samples for Gaussian), so tests can feed both
packages the same numbers.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import torch

QUANTIZER_NOISE_TYPES = ("kumaraswamy", "gaussian", "none")
QUANTIZER_TYPES = ("softround_alone", "softround", "hardround", "ste", "none", "true_ste")


def softround(x: torch.Tensor, t: float | torch.Tensor) -> torch.Tensor:
    """floor(x) + tanh(d/t) / (2 tanh(1/2t)) + 1/2, d = x - floor(x) - 1/2.
    ``t`` a number (tanh(1/2t) on the host) or a 0-d tensor (on its device,
    in its precision, as JAX computes it for a traced temperature)."""
    floor_x = torch.floor(x)
    delta = x - floor_x - 0.5
    if isinstance(t, torch.Tensor):
        return floor_x + 0.5 * torch.tanh(delta / t) / torch.tanh(0.5 / t) + 0.5
    return floor_x + 0.5 * torch.tanh(delta / t) / math.tanh(1.0 / (2.0 * t)) + 0.5


def kumaraswamy_noise(uniform_noise: torch.Tensor, a: float | torch.Tensor) -> torch.Tensor:
    """U(0, 1) -> Kumaraswamy(a, b(a)) shifted to (-1/2, 1/2), mode at 1/2."""
    b = (2.0**a * (a - 1.0) + 1.0) / a
    return (1.0 - (1.0 - uniform_noise) ** (1.0 / b)) ** (1.0 / a) - 0.5


def clip_like_jax(x: torch.Tensor, lo: float, hi: Optional[float] = None) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` (no upper bound when ``hi`` is None) with its
    gradient: where ``x`` equals a bound the gradient is split 0.5 / 0.5
    between ``x`` and the bound, so ``x`` gets half of it (``torch.clamp``
    passes all of it). Use it where the JAX package clips on a
    differentiable path."""
    x = torch.maximum(x, _bound(lo, x.dtype, x.device))
    return x if hi is None else torch.minimum(x, _bound(hi, x.dtype, x.device))


@lru_cache(maxsize=64)
def _bound(value: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A 0-dim constant, made once per device (no copy or launch per call)."""
    return torch.tensor(value, dtype=dtype, device=device)


def draw_noise(
    x: torch.Tensor, quantizer_noise_type: str, generator: Optional[torch.Generator]
) -> Optional[torch.Tensor]:
    """Raw noise draw for ``quantize`` (None when the type needs none)."""
    if quantizer_noise_type == "gaussian":
        return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    if quantizer_noise_type == "kumaraswamy":
        return torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return None


def quantize(
    x: torch.Tensor,
    quantizer_noise_type: str = "kumaraswamy",
    quantizer_type: str = "softround",
    soft_round_temperature: float | torch.Tensor = 0.3,
    noise_parameter: float | torch.Tensor = 1.0,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Simulate quantization of ``x``.

    Modes: ``none`` x + n; ``softround_alone`` softround(x); ``softround``
    softround(softround(x) + n); ``hardround`` round(x); ``ste`` forward
    round(x), backward through softround; ``true_ste`` forward round(x),
    backward identity. n is Gaussian (std ``noise_parameter``) or
    Kumaraswamy (a = ``noise_parameter``), from ``noise`` when given, else
    drawn with ``generator``. The temperature and the noise parameter are
    numbers or 0-d tensors (a CUDA graph's step reads them from the device).
    """
    if quantizer_noise_type not in QUANTIZER_NOISE_TYPES:
        raise ValueError(f"unknown quantizer_noise_type {quantizer_noise_type}")
    if quantizer_type not in QUANTIZER_TYPES:
        raise ValueError(f"unknown quantizer_type {quantizer_type}")

    n = None
    if quantizer_noise_type != "none":
        raw = noise if noise is not None else draw_noise(x, quantizer_noise_type, generator)
        if quantizer_noise_type == "gaussian":
            n = raw * noise_parameter
        else:
            n = kumaraswamy_noise(raw, noise_parameter)

    t = soft_round_temperature
    if quantizer_type == "none":
        return x if n is None else x + n
    if quantizer_type == "softround_alone":
        return softround(x, t)
    if quantizer_type == "softround":
        return softround(softround(x, t) + n, t)
    if quantizer_type == "ste":
        y = softround(x, t)
        return y + (torch.round(x) - y).detach()
    if quantizer_type == "true_ste":
        return x + (torch.round(x) - x).detach()
    return torch.round(x)
