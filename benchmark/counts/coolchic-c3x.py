"""FLOP and byte counts of the coolchic-c3x decoder, from its sizes.

The multiply-accumulates per pixel copy ``coolchic_tpu_torch/models/
coolchic.py::macs_per_pixel`` (2,241 MAC/px for the default decoder at
512x768: ARM 1,600, upsampling 79, synthesis 562). A FLOP is 2 MAC. A
training step counts 3 forwards (the forward, and a backward of twice its
work); no recomputation is counted, whatever the program does.
"""

from __future__ import annotations

import math
from typing import Dict

TRAIN_FORWARDS = 3  # forward + backward (2x)


def parsed_synthesis(config: Dict):
    out = []
    for spec in config["layers_synthesis"]:
        ft, k, mode, _act = spec.split("-")
        out.append((3 if ft == "X" else int(ft), int(k)))
    return out


def latent_shapes(config: Dict, height: int, width: int):
    return [(c, math.ceil(height / 2 ** i), math.ceil(width / 2 ** i))
            for i, c in enumerate(config["n_ft_per_res"])]


def n_latents(config: Dict, height: int, width: int) -> int:
    return sum(c * h * w for c, h, w in latent_shapes(config, height, width))


def macs_per_pixel(config: Dict, height: int, width: int) -> Dict[str, float]:
    """Multiply-accumulates per decoded pixel of one forward, by module."""
    n_pix = height * width
    shapes = latent_shapes(config, height, width)
    dim, n_hidden = config["dim_arm"], config["n_hidden_layers_arm"]
    arm = n_latents(config, height, width) * (n_hidden * dim * dim + dim * 2)
    # Each x2 step: two polyphase 1-D passes of ups_k / 2 taps over every
    # output pixel, and the pre-concat filter's two 1-D passes over its grid.
    ups, acc = 0, shapes[-1][0] * shapes[-1][1] * shapes[-1][2]
    for c, h, w in reversed(shapes[:-1]):
        up = 4 * acc
        ups += up * config["ups_k_size"] + c * h * w * 2 * config["ups_preconcat_k_size"]
        acc = up + c * h * w
    syn, in_ft = 0, sum(config["n_ft_per_res"])
    for out_ft, k in parsed_synthesis(config):
        syn += n_pix * in_ft * out_ft * k * k
        in_ft = out_ft
    return {"arm": arm / n_pix, "upsampling": ups / n_pix, "synthesis": syn / n_pix,
            "total": (arm + ups + syn) / n_pix}


def forward_flops(config: Dict, height: int, width: int) -> float:
    """FLOPs of one image's forward."""
    return 2.0 * macs_per_pixel(config, height, width)["total"] * height * width


def train_step_flops(config: Dict, height: int, width: int) -> float:
    """FLOPs of one optimizer step of one image."""
    return TRAIN_FORWARDS * forward_flops(config, height, width)


def arm_kernel(config: Dict, height: int, width: int, n_images: int) -> Dict[str, float]:
    """The eval ARM-rate kernel over ``n_images`` pyramids: its FLOPs
    (2 x latents x (n_hidden dim^2 + 2 dim)) and its bytes (each latent read
    once as f32 and its rate written once as f32)."""
    dim, n_hidden = config["dim_arm"], config["n_hidden_layers_arm"]
    n = n_latents(config, height, width) * n_images
    return {"flops": 2.0 * n * (n_hidden * dim * dim + 2 * dim), "bytes": 8.0 * n}
