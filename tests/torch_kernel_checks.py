"""Checks of the port's two CUDA kernels against their references, shared by
the tests and ``chip_smoke.py``. It imports torch and the port only, so that
it runs where JAX is not installed.

* The ARM rate (``ops/arm_rate.py``): the references of an f32 rate are the
  plain version in float64 (latents and weights cast) and the plain version
  in f32 (``models/arm.py``), both held with ``models.arm.rate_tolerance``.
* The upsampling filters' weight gradient (``ops/ups_filter.py``): the
  calls of one backward of the default decoder's cascade, as the kernel
  receives them, and the error of a weight gradient against the plain
  version in float64.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from coolchic_tpu_torch.models.arm import (
    STEEP_SCALE, TAIL_RATE, ArmParams, arm_rate_plain, rate_tolerance,
)
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.models.coolchic import init_coolchic_params
from coolchic_tpu_torch.models.upsampling import upsampling_apply
from coolchic_tpu_torch.ops import ups_filter

# --------------------------------------------------------------------------- #
# The ARM rate
# --------------------------------------------------------------------------- #
# Inputs past the integers TF32 holds exactly: (dim_arm, n_hidden) of the
# cases, each run on every seed of LARGE_SEEDS (a fixed range, not picked).
LARGE_ARMS = ((24, 0), (24, 1), (24, 2), (24, 3), (32, 2), (16, 2), (8, 1))
LARGE_SEEDS = range(1, 40)
LARGE_PLANES = ((1, 1), (5, 3), (17, 33), (37, 130))


def large_latent_case(dim_arm: int, n_hidden: int, seed: int) -> Tuple[Dict, List[np.ndarray]]:
    """ARM params and [1, H, W] latent planes as numpy f32, from a numpy seed.
    Params: first hidden weight 0.2 N(0, 1), further hidden ones 0.05 N(0, 1),
    head N(0, 1) / 4, zero biases. Planes ``LARGE_PLANES`` of round(N(0, 3))
    latents with one in 64 set to +-(2049 .. 3000)."""
    rng = np.random.default_rng(seed)
    layers = [{"weight": rng.standard_normal((dim_arm, dim_arm)) * (0.2 if i == 0 else 0.05),
               "bias": np.zeros(dim_arm)} for i in range(n_hidden)]
    layers.append({"weight": rng.standard_normal((2, dim_arm)) / 4, "bias": np.zeros(2)})
    params = {"layers": [{k: v.astype(np.float32) for k, v in layer.items()} for layer in layers]}
    latents = []
    for h, w in LARGE_PLANES:
        lat = np.round(rng.standard_normal((1, h, w)) * 3.0)
        big = rng.integers(2049, 3001, (1, h, w)) * rng.choice([-1, 1], (1, h, w))
        latents.append(np.where(rng.random((1, h, w)) < 1 / 64, big, lat).astype(np.float32))
    return params, latents


def compare_rates(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor) -> Dict:
    """``got`` against the reference ``want`` (with its Laplace ``scale``):
    the largest error, whether every latent is within ``rate_tolerance``,
    and the latents beyond rtol = atol = 1e-4 by the extra term they fall
    under (``neither`` must be 0)."""
    err = (got - want).abs()
    beyond = err > 1e-4 + 1e-4 * want.abs()
    steep, tail = scale < STEEP_SCALE, want.abs() > TAIL_RATE
    return {
        "max_abs_err": err.max().item() if err.numel() else 0.0,
        "ok": bool(torch.all(err <= rate_tolerance(want, scale))),
        "n_beyond_1e-4": {
            "steep": int((beyond & steep & ~tail).sum()),
            "tail": int((beyond & tail & ~steep).sum()),
            "steep_and_tail": int((beyond & steep & tail).sum()),
            "neither": int((beyond & ~steep & ~tail).sum()),
        },
    }


def holds(res: Dict) -> bool:
    """A ``compare_rates`` result within tolerance with ``neither`` = 0."""
    return res["ok"] and res["n_beyond_1e-4"]["neither"] == 0


def arm_rate_f64(
    latents: Sequence[torch.Tensor], params: ArmParams, dim_arm: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain rate with latents and weights cast to float64, and its
    Laplace scale, both cast back to float32."""
    p64 = {"layers": [{k: v.double() for k, v in layer.items()} for layer in params["layers"]]}
    rate, _, log_scale = arm_rate_plain([y.double() for y in latents], p64, dim_arm)
    scale = torch.exp(torch.clamp(log_scale - 4.0, -4.6, 5.0))
    return rate.float(), scale.float()


def check_rate(got: torch.Tensor, latents: Sequence[torch.Tensor], params: ArmParams,
               dim_arm: int) -> Dict:
    """``got`` against the float64 and the f32 plain rates (on the latents'
    device: cuBLAS on a GPU), and the f32 plain rate against float64.
    ``f32_holds`` says whether the f32 plain rate is itself within tolerance
    of float64: where it is not, it is no yardstick."""
    want64, scale64 = arm_rate_f64(latents, params, dim_arm)
    plain, _, log_scale = arm_rate_plain(latents, params, dim_arm)
    scale = torch.exp(torch.clamp(log_scale - 4.0, -4.6, 5.0))
    return {
        "vs_f64": compare_rates(got, want64, scale64),
        "vs_f32": compare_rates(got, plain, scale),
        "f32_holds": holds(compare_rates(plain, want64, scale64)),
        "plain_f32_max_abs_err_f64": (plain - want64).abs().max().item(),
    }


# --------------------------------------------------------------------------- #
# The upsampling filters' weight gradient
# --------------------------------------------------------------------------- #
@contextmanager
def recorded_weight_grads() -> Iterator[List[Tuple]]:
    """Within the block, each weight gradient's (x, gy, k, transposed, axis)
    as ``ups_filter.weight_grad`` receives them, in the backward's order,
    into the list it yields (the tensors themselves, not copies). Wraps the
    module's ``weight_grad``, which ``_Filter1d.backward`` looks up at each
    call, and puts it back on leaving the block, also on an error."""
    calls: List[Tuple] = []
    real = ups_filter.weight_grad

    def recorded(x, gy, k, transposed, axis):
        calls.append((x.detach(), gy.detach(), k, transposed, axis))
        return real(x, gy, k, transposed, axis)

    ups_filter.weight_grad = recorded
    try:
        yield calls
    finally:
        ups_filter.weight_grad = real


def cascade_weight_grads(img_size, n_images: int, device, seed: int = 0) -> List[Tuple]:
    """The weight gradients of one backward of the default decoder's
    upsampling (7 grids) at ``img_size`` for ``n_images`` images, from
    random latents and half kernels: (x, gy, k, transposed, axis) as the
    kernel received them (24, in the backward's order), strides and all, so
    that a second launch on them takes the same launch geometry."""
    cfg = CoolChicConfig(img_size=img_size)
    gen = torch.Generator(device).manual_seed(seed)
    latents = [torch.randn((n_images, *s), generator=gen, device=device).requires_grad_()
               for s in cfg.latent_shapes]
    ups = init_coolchic_params(gen, cfg, device)["upsampling"]
    ups = {key: [(h + 0.05 * torch.randn((n_images, h.shape[0]), generator=gen, device=device))
                 .requires_grad_() for h in halves] for key, halves in ups.items()}
    out = upsampling_apply(ups, latents, cfg.ups_k_size, cfg.ups_preconcat_k_size)
    weight = torch.randn(out.shape, generator=gen, device=device)
    with recorded_weight_grads() as calls:
        torch.autograd.grad((out * weight).sum(), ups["ups"] + ups["preconcat"])
    return calls


def weight_grad_error(got: torch.Tensor, x: torch.Tensor, gy: torch.Tensor, k: int,
                      transposed: bool, axis: int) -> float:
    """Largest error of an f32 weight gradient [B, k] against the plain
    version in float64, each tap's relative to its sum of |terms|: what an
    f32 sum of those terms can be held to whatever their cancellation (a
    term left out moves it by about 1 / terms)."""
    x, gy = x.double(), gy.double()
    want = ups_filter.weight_grad_plain(x, gy, k, transposed, axis)
    scale = ups_filter.weight_grad_plain(x.abs(), gy.abs(), k, transposed, axis)
    return ((got.double() - want).abs() / scale.clamp_min(1e-30)).max().item()
