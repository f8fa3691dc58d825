"""FLOP counts of the hypernet-delta-r18 whole net, from its sizes.

Counted are the multiply-accumulates of the convolutions and the dense layers
(what ``torch.utils.flop_counter.FlopCounterMode`` counts), not the norms,
activations or pools: the latent encoder (a strided 3x3, a 1x1 shortcut and
three ConvNeXt blocks per grid, and each grid's 1x1 head), the resnet18, the
three MLP heads, and one decoder per image (the coolchic-c3x counts of
``counts/coolchic-c3x.py``, copied: ARM, upsampling, synthesis). A FLOP is 2
MAC; a training sample counts 3 forwards.
"""

from __future__ import annotations

import math
from typing import Dict

TRAIN_FORWARDS = 3
RESNET18 = ((64, 2), (128, 2), (256, 2), (512, 2))


def _half(n: int) -> int:
    return math.ceil(n / 2)


def latent_encoder_macs(config: Dict, height: int, width: int) -> float:
    c, total = config["n_hidden_channels"], 0
    h, w, c_in = height, width, 3
    for i in range(len(config["n_ft_per_res"])):
        if i:
            h, w = _half(h), _half(w)
        px = h * w
        total += px * c * c_in * 9 + px * c * c_in  # strided 3x3, 1x1 shortcut
        total += 3 * px * (c * 49 + 2 * c * 4 * c)  # ConvNeXt: depthwise 7x7, 1x1 up and down
        total += px * c  # the grid's 1x1 head
        c_in = c
    return total


def resnet18_macs(height: int, width: int) -> float:
    h, w = _half(height), _half(width)
    total = h * w * 64 * 3 * 49  # stem 7x7, stride 2
    h, w = _half(h), _half(w)  # max-pool
    c_in = 64
    for stage, (c, n) in enumerate(RESNET18):
        for j in range(n):
            if stage and not j:
                h, w = _half(h), _half(w)
            total += h * w * c * (c_in * 9 + c * 9)
            if c_in != c:
                total += h * w * c * c_in  # 1x1 shortcut
            c_in = c
    return total


def head_outputs(config: Dict) -> Dict[str, int]:
    """Outputs of the synthesis, ARM and upsampling heads."""
    syn, in_ft = 0, len(config["n_ft_per_res"])
    for spec in config["layers_synthesis"]:
        ft, k = spec.split("-")[:2]
        out = 3 if ft == "X" else int(ft)
        syn += out * in_ft * int(k) ** 2 + out
        in_ft = out
    d = config["dim_arm"]
    arm = config["n_hidden_layers_arm"] * (d * d + d) + 2 * d + 2
    ups = (len(config["n_ft_per_res"]) - 1) * ((config["ups_k_size"] + 1) // 2 + 1
                                               + (config["ups_preconcat_k_size"] + 1) // 2 + 1)
    return {"synthesis": syn, "arm": arm, "upsampling": ups}


def heads_macs(config: Dict, n_features: int = 512) -> float:
    outs = head_outputs(config)
    total = 0
    for name, hidden, layers in (("synthesis", config["synthesis_hidden_dim"], config["synthesis_n_layers"]),
                                 ("arm", config["arm_hidden_dim"], config["arm_n_layers"]),
                                 ("upsampling", config["ups_hidden_dim"], config["ups_n_layers"])):
        total += n_features * hidden + layers * hidden * hidden + hidden * outs[name]
    return total


def decoder_macs(config: Dict, height: int, width: int) -> Dict[str, float]:
    shapes = [(c, math.ceil(height / 2 ** i), math.ceil(width / 2 ** i))
              for i, c in enumerate(config["n_ft_per_res"])]
    d, n_hidden = config["dim_arm"], config["n_hidden_layers_arm"]
    arm = sum(c * h * w for c, h, w in shapes) * (n_hidden * d * d + 2 * d)
    ups, acc = 0, shapes[-1][0] * shapes[-1][1] * shapes[-1][2]
    for c, h, w in reversed(shapes[:-1]):
        up = 4 * acc
        ups += up * config["ups_k_size"] + c * h * w * 2 * config["ups_preconcat_k_size"]
        acc = up + c * h * w
    syn, in_ft = 0, sum(config["n_ft_per_res"])
    for spec in config["layers_synthesis"]:
        ft, k = spec.split("-")[:2]
        out = 3 if ft == "X" else int(ft)
        syn += height * width * in_ft * out * int(k) ** 2
        in_ft = out
    return {"arm": arm, "upsampling": ups, "synthesis": syn}


def sample_macs(config: Dict, height: int | None = None, width: int | None = None) -> Dict[str, float]:
    """Multiply-accumulates of one image's forward, by part."""
    height, width = height or config["patch_size"][0], width or config["patch_size"][1]
    return {"latent_encoder": latent_encoder_macs(config, height, width),
            "resnet18": resnet18_macs(height, width), "heads": heads_macs(config),
            **{f"decoder_{k}": v for k, v in decoder_macs(config, height, width).items()}}


def train_sample_flops(config: Dict) -> float:
    """FLOPs of training on one sample at the configuration's patch size."""
    return TRAIN_FORWARDS * 2.0 * sum(sample_macs(config).values())
