"""What the benchmark makes from the seed and hands to the program and to the
reference alike: images on the device, the raw quantization noise in the
program's draw order (from one generator, or from one generator per step
keyed as the program keys it).

``synthetic_images`` is a copy of ``chip_smoke.py::synthetic_image`` (smooth
gradients plus texture plus noise, [3, H, W] in [0, 1]) drawn with a
``torch.Generator`` on the device instead of numpy, for a batch at once: each
image has its own noise and its own shift of the two textures.
"""

from __future__ import annotations

import hashlib
import math
from typing import List, Sequence

import torch


def synthetic_images(n: int, height: int, width: int, seed: int, device) -> torch.Tensor:
    """[n, 3, H, W] float32 images in [0, 1]; the same seed gives the same images."""
    g = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn((n, 3, height, width), generator=g, device=device)
    shift = torch.rand((n, 2, 1, 1), generator=g, device=device) * (2.0 * math.pi)
    y = torch.arange(height, device=device, dtype=torch.float32).view(1, height, 1)
    x = torch.arange(width, device=device, dtype=torch.float32).view(1, 1, width)
    img = torch.stack([
        (0.2 + 0.6 * x / width).expand(n, height, width),
        0.3 + 0.4 * torch.sin(2 * math.pi * y / height + shift[:, 0]) * torch.cos(2 * math.pi * x / (0.7 * width)),
        0.5 + 0.3 * torch.sin(x / 9.0 + shift[:, 1]) * torch.sin(y / 13.0),
    ], dim=1)
    return torch.clamp(img + 0.04 * noise, 0.0, 1.0)


def noise_draws(shapes: Sequence, n_images: int, n_steps: int, seed: int, device) -> List[List[torch.Tensor]]:
    """The raw gaussian noise of ``n_steps`` training steps as the program
    draws it from a generator seeded with ``seed``: per step, one
    [B, C, h, w] ``randn`` per latent grid, in grid order."""
    g = torch.Generator(device=device).manual_seed(seed)
    return [[torch.randn((n_images, *s), generator=g, device=device) for s in shapes]
            for _ in range(n_steps)]


def keyed_seed(*keys: int) -> int:
    """The seed of the generator that the program makes for a tuple of
    integers (``train/step.py::make_generator``: the first 7 bytes of the
    SHA-256 of the tuple's ``repr``, little-endian). ``train_wholenet`` draws
    the noise of its step i from the generator of ``(seed, i)``."""
    return int.from_bytes(hashlib.sha256(repr(tuple(keys)).encode()).digest()[:7], "little")


def keyed_noise_draws(shapes: Sequence, n_images: int, n_steps: int, seed: int, device):
    """As ``noise_draws``, with step i drawn from the generator of ``keyed_seed(seed, i)``."""
    return [noise_draws(shapes, n_images, 1, keyed_seed(seed, i), device)[0] for i in range(n_steps)]
