"""Checks of the upsampling filters' weight-gradient kernel
(``ops/ups_filter.py``), shared by the tests and ``chip_smoke.py``."""

from __future__ import annotations

from typing import List, Tuple

import torch

from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.models.coolchic import init_coolchic_params
from coolchic_tpu_torch.models.upsampling import upsampling_apply
from coolchic_tpu_torch.ops import ups_filter


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
    with ups_filter.capture_calls() as calls:
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
