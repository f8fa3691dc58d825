"""The FLOP counts of ``benchmark/counts/`` against
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference's
forward, part by part, on the CPU.

The upsampling's count is the program's polyphase arithmetic (two 1-D passes
of k/2 taps over every output pixel), which counts the first pass over the
whole output where the transposed convolution computes half of it: it reads
21 % over what the operators do at 512x768 (9 % at 64x96), on a part that is
3.5 % of the total, so the step's count is 0.7 % high.
"""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness.core import BENCH_DIR, load_module, read_json
from benchmark.reference import coolchic as cc
from benchmark.reference import hypernet as hn


def flops(fn, *args):
    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    return counter.get_total_flops(), out


@pytest.mark.parametrize("hw", [(64, 96), (512, 768)])
def test_decoder_counts(hw):
    h, w = hw
    config = read_json(BENCH_DIR / "configs" / "coolchic-c3x.json")
    counts = load_module(BENCH_DIR / "counts" / "coolchic-c3x.py")
    g = torch.Generator().manual_seed(0)
    p = cc.image_params(cc.init_params(g, config, h, w, 1, "cpu"), 0)
    y = [torch.round(3 * torch.randn(lat.shape, generator=g)) for lat in p["latents"]]
    macs = counts.macs_per_pixel(config, h, w)
    arm, _ = flops(cc.arm_rate, y, p["arm"], config["dim_arm"])
    ups, dense = flops(cc.upsampling, y, p["upsampling"], config["ups_k_size"], config["ups_preconcat_k_size"])
    syn, _ = flops(cc.synthesis, dense, p["synthesis"], cc.parse_synthesis(config["layers_synthesis"]))
    assert arm == 2 * macs["arm"] * h * w
    assert syn == 2 * macs["synthesis"] * h * w
    assert ups <= 2 * macs["upsampling"] * h * w <= 1.25 * ups
    assert counts.train_step_flops(config, h, w) == 3 * 2 * macs["total"] * h * w
    kernel = counts.arm_kernel(config, h, w, 2)
    assert kernel["flops"] == 2 * arm and kernel["bytes"] == 2 * 8 * counts.n_latents(config, h, w)


def test_default_decoder_is_2241_mac_per_pixel():
    config = read_json(BENCH_DIR / "configs" / "coolchic-c3x.json")
    counts = load_module(BENCH_DIR / "counts" / "coolchic-c3x.py")
    macs = counts.macs_per_pixel(config, 512, 768)
    assert round(macs["total"]) == 2241 and round(macs["arm"]) == 1600 and round(macs["synthesis"]) == 562


def test_hypernet_counts():
    config = read_json(BENCH_DIR / "configs" / "hypernet-delta-r18.json")
    counts = load_module(BENCH_DIR / "counts" / "hypernet-delta-r18.py")
    driver = load_module(BENCH_DIR / "drivers" / "hypernet_train.py")
    from coolchic_tpu_torch.hypernet import DeltaWholeNet
    from coolchic_tpu_torch.models.config import CoolChicConfig

    net = DeltaWholeNet(CoolChicConfig(img_size=(64, 64), layers_synthesis=tuple(config["layers_synthesis"])),
                        backbone_arch=config["backbone_arch"])
    shapes = {k: tuple(v.shape) for k, v in net.module.state_dict().items()}
    g = torch.Generator().manual_seed(0)
    sd = driver.init_hypernet(shapes, 1e-3, g, "cpu")
    assert sum(v.numel() for v in sd.values()) == 21_792_392
    x = torch.rand(1, 3, 64, 64, generator=g)
    macs = counts.sample_macs(config, 64, 64)
    assert flops(hn.latent_encoder, sd, x, len(config["n_ft_per_res"]))[0] == 2 * macs["latent_encoder"]
    r18, feats = flops(hn.resnet18, sd, x)
    assert r18 == 2 * macs["resnet18"]
    heads, _ = flops(lambda f: [hn.mlp(sd, f"MLP_{i}", f) for i in range(3)], feats)
    assert heads == 2 * macs["heads"]
    # About 26 GFLOP per 256x256 sample's forward, as FlopCounterMode reads the program's.
    assert 25.5e9 < counts.train_sample_flops(config) / 3 < 26.5e9
