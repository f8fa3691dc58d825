#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one GPU: build, kernel checks,
and one full-width image encode through the port's entry point.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. build: compile every kernel of ``coolchic_tpu_torch/csrc`` with nvcc
     (one process per source, started together).
  2. arm_rate kernel vs its plain PyTorch version (``models/arm.py``) for
     (dim_arm, n_hidden) in {(8,1), (16,2), (24,2), (32,2)} on planes
     16x24, 37x130 and 512x768, then on the 7-grid pyramid of a 512x768
     image (the main path's shapes). Two comparisons per case:
       * against the plain version with the ARM matmuls summed in the
         kernel's order (sequential FMA, emulated exactly in float64):
         rtol = atol = 1e-4;
       * against the plain version as the port runs it (cuBLAS matmuls):
         ``models.arm.rate_tolerance``: rtol = atol = 1e-4, with one more
         term for two kinds of latent only, because cuBLAS sums in an order
         that depends on the shape. Where the Laplace scale is under 1/8 the
         ~1e-6 that moves mu moves the rate by up to ~1.1e-3 bits (at the
         0.01 floor); over 12 bits an ulp of the CDF values moves a tail
         latent's rate by ~2^(rate - 23) / ln 2.
  3. main path: encode a synthetic 512x768 RGB image (numpy seed 0) with the
     default DecoderConfig (arm 24,2; 40-wide synthesis; 7 grids) and the
     c3x recipe of preset_cfg/c3x.yaml, iteration counts cut (printed),
     through ``coolchic_tpu_torch.encode.encode_one_run``: warm-up 5 -> 2
     candidates, three phases, the full NN-quantization search. Checks that
     every eval forward launched the kernel, that loss / PSNR / rate are
     finite, that the PSNR estimate beats the flat-mean image, and that the
     final params give the same eval loss on the card (kernel) as on the CPU
     (plain ARM).
Then a ``kernels`` JSON line, the card's name and power limit, and the
final ``{"ok": true, "device": ...}`` line. Any failure raises (exit != 0).

TF32 is off for the whole run (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), so plain and kernel paths are f32.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "smoke_out"  # encode outputs of the main-path run (gitignored)

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit).
PEAK_F32_FLOPS = 67e12  # CUDA cores, no tensor cores
PEAK_BYTES_PER_S = 3.35e12

ARM_CASES = [(8, 1), (16, 2), (24, 2), (32, 2)]
PLANES = [(16, 24), (37, 130), (512, 768)]
IMG_H, IMG_W = 512, 768

# Iteration cuts of the c3x recipe for the main-path run.
WARMUP_MAX_ITR = 100  # c3x: 400 per warm-up phase
PHASE_MAX_ITR = (1000, 200, 100)  # c3x: 10600 (--n_itr), 1500, 1000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, n_warmup: int = 3, n_iter: int = 20, per_sample: int = 10) -> float:
    """Device time of one call (CUDA events): the median over ``n_iter``
    samples of ``per_sample`` back-to-back calls, divided by ``per_sample``,
    so that the host's launch overhead overlaps the device work."""
    import torch

    for _ in range(n_warmup):
        fn()
    times = []
    for _ in range(n_iter):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_sample):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_sample)
    return statistics.median(times)


def kernel_ms(latents, params, dim_arm, n_hidden) -> float:
    """Time of the kernel alone, on buffers prepared once (the wrapper's
    packing and concatenation are not timed)."""
    import torch

    from coolchic_tpu_torch.ops import arm_rate as ar

    flat = torch.cat([y.reshape(-1) for y in latents])
    rate = torch.empty_like(flat)
    weights = ar.pack_arm_weights(params, dim_arm, n_hidden)
    planes = ar.plane_table(latents)
    return time_ms(lambda: ar.launch_arm_rate(flat, rate, weights, planes, dim_arm, n_hidden))


def phase_build() -> None:
    from coolchic_tpu_torch.ops.build import CSRC_DIR, load_library
    from concurrent.futures import ThreadPoolExecutor

    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        results = dict(zip(names, pool.map(load_library, names)))
    regs = {
        name: [line.strip() for line in log.splitlines() if "registers" in line]
        for name, (_, log) in results.items()
    }
    emit({"phase": "build", "kernels": names, "seconds": time.perf_counter() - t0,
          "ptxas": regs})


def fma_order_rate(latents, params, dim_arm):
    """The plain rate with every ARM matmul summed as the kernel sums it:
    k ascending, one fused multiply-add per term (exact in float64, then
    rounded to float32 once per step)."""
    import torch

    from coolchic_tpu_torch.models.arm import get_neighbors, latent_rate_bits

    def mm(x, w):
        acc = torch.zeros(x.shape[0], w.shape[0], device=x.device)
        for k in range(x.shape[1]):
            acc = (acc.double() + x[:, k : k + 1].double() * w[:, k][None].double()).float()
        return acc

    x = torch.cat([get_neighbors(y, dim_arm) for y in latents])
    layers = params["layers"]
    for layer in layers[:-1]:
        x = torch.relu(mm(x, layer["weight"]) + layer["bias"] + x)
    raw = mm(x, layers[-1]["weight"]) + layers[-1]["bias"]
    scale = torch.exp(torch.clamp(raw[:, 1] - 4.0, -4.6, 5.0))
    flat = torch.cat([y.reshape(-1) for y in latents])
    return latent_rate_bits(flat, raw[:, 0], scale)


def arm_case_params(dim_arm, n_hidden, gen):
    import torch

    from coolchic_tpu_torch.models.arm import init_arm_params

    params = init_arm_params(gen, dim_arm, n_hidden, "cuda")
    w0 = params["layers"][0]["weight"]
    params["layers"][0]["weight"] = torch.randn(w0.shape, generator=gen, device="cuda") * 0.2
    return params


def compare(got, latents, params, dim_arm) -> dict:
    import torch

    from coolchic_tpu_torch.models.arm import (
        STEEP_SCALE, TAIL_RATE, arm_rate_plain, rate_tolerance,
    )

    plain, _, log_scale = arm_rate_plain(latents, params, dim_arm)
    scale = torch.exp(torch.clamp(log_scale - 4.0, -4.6, 5.0))
    ordered = fma_order_rate(latents, params, dim_arm)
    torch.cuda.synchronize()
    ok_ordered = bool(torch.allclose(got, ordered, rtol=1e-4, atol=1e-4))
    err = (got - plain).abs()
    ok_plain = bool(torch.all(err <= rate_tolerance(plain, scale)))
    # Latents beyond rtol = atol = 1e-4, by the extra term they fall under.
    beyond = err > 1e-4 + 1e-4 * plain.abs()
    steep, tail = scale < STEEP_SCALE, plain.abs() > TAIL_RATE
    out = {
        "max_abs_err": err.max().item(),
        "max_abs_err_fma_order": (got - ordered).abs().max().item(),
        "ok_fma_order_1e-4": ok_ordered,
        "ok_plain_rate_tolerance": ok_plain,
        "n_beyond_1e-4": {
            "steep": int((beyond & steep & ~tail).sum()),
            "tail": int((beyond & tail & ~steep).sum()),
            "steep_and_tail": int((beyond & steep & tail).sum()),
            "neither": int((beyond & ~steep & ~tail).sum()),
        },
    }
    if not (ok_ordered and ok_plain):
        raise AssertionError(f"arm_rate kernel disagrees with its plain version: {out}")
    return out


def phase_kernel_checks() -> dict:
    """Kernel vs plain on single planes and on the main path's pyramid.
    Returns the pyramid numbers for the ``kernels`` line."""
    import torch

    from coolchic_tpu_torch.models.arm import arm_rate_plain
    from coolchic_tpu_torch.models.config import CoolChicConfig
    from coolchic_tpu_torch.ops import arm_rate as ar

    for dim_arm, n_hidden in ARM_CASES:
        gen = torch.Generator("cuda").manual_seed(dim_arm)
        params = arm_case_params(dim_arm, n_hidden, gen)
        for hw in PLANES:
            lat = torch.round(torch.randn(hw, generator=gen, device="cuda") * 3.0)
            got = ar.arm_rate(lat, params, dim_arm, n_hidden).reshape(-1)
            line = {"phase": "arm_rate_plane", "dim_arm": dim_arm, "n_hidden": n_hidden,
                    "hw": list(hw), **compare(got, [lat[None]], params, dim_arm)}
            if hw == PLANES[-1]:
                line["ms"] = kernel_ms([lat[None]], params, dim_arm, n_hidden)
                line["plain_ms"] = time_ms(lambda: arm_rate_plain([lat[None]], params, dim_arm))
            emit(line)

    # The main path's shapes: 7 grids of a 512x768 image, flagship ARM.
    cfg = CoolChicConfig(img_size=(IMG_H, IMG_W))
    dim_arm, n_hidden = cfg.dim_arm, cfg.n_hidden_layers_arm
    gen = torch.Generator("cuda").manual_seed(1234)
    params = arm_case_params(dim_arm, n_hidden, gen)
    latents = [torch.round(torch.randn(s, generator=gen, device="cuda") * 3.0)
               for s in cfg.latent_shapes]
    got = ar.arm_rate_pyramid(latents, params, dim_arm, n_hidden)
    per_plane = torch.cat([ar.arm_rate(y[0], params, dim_arm, n_hidden).reshape(-1)
                           for y in latents])
    torch.cuda.synchronize()
    if not torch.equal(got, per_plane):
        raise AssertionError("pyramid launch and per-plane launches disagree on the order")
    res = compare(got, latents, params, dim_arm)
    ms = kernel_ms(latents, params, dim_arm, n_hidden)
    wrapper_ms = time_ms(lambda: ar.arm_rate_pyramid(latents, params, dim_arm, n_hidden))
    plain_ms = time_ms(lambda: arm_rate_plain(latents, params, dim_arm))

    n = cfg.n_latents
    flops = n * (2 * (n_hidden * dim_arm * dim_arm + 2 * dim_arm) + 2 * n_hidden * dim_arm + 2)
    n_weights = n_hidden * (dim_arm * dim_arm + dim_arm) + 2 * dim_arm + 2
    n_bytes = 4 * (2 * n + n_weights)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES_PER_S
    out = {
        "max_abs_err": res["max_abs_err"], "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    emit({"phase": "arm_rate_pyramid", "latent_shapes": [list(s) for s in cfg.latent_shapes],
          "n_latents": n, "dim_arm": dim_arm, "n_hidden": n_hidden, "flops": flops,
          "bytes": n_bytes, **res, **out})
    return out


def synthetic_image(h: int, w: int):
    """Smooth gradients plus texture, [3, H, W] in [0, 1], numpy seed 0."""
    import numpy as np

    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([
        0.2 + 0.6 * x / w,
        0.3 + 0.4 * np.sin(2 * np.pi * y / h) * np.cos(2 * np.pi * x / (0.7 * w)),
        0.5 + 0.3 * np.sin(x / 9.0) * np.sin(y / 13.0),
    ])
    img += 0.04 * rng.standard_normal(img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def phase_main_path() -> int:
    """Encode through the entry point; returns the kernel launches it made."""
    from dataclasses import replace

    import numpy as np
    import torch

    from coolchic_tpu_torch.encode import encode_one_run
    from coolchic_tpu_torch.io.image import write_ppm
    from coolchic_tpu_torch.ops import arm_rate as ar
    from coolchic_tpu_torch.params import from_numpy_pytree, to_numpy_pytree
    from coolchic_tpu_torch.train.presets import Warmup, load_preset
    from coolchic_tpu_torch.train.step import eval_metrics
    from coolchic_tpu_torch.utils.types import DecoderConfig, EncoderConfig, RunConfig

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    img = synthetic_image(IMG_H, IMG_W)
    path = OUT_DIR / "synthetic_512x768.ppm"
    write_ppm(img, 8, str(path))
    img = np.round(img * 255.0) / 255.0  # what the encoder reads back

    full = load_preset("c3x")
    enc = EncoderConfig(std_recipe_name="c3x", n_itr=PHASE_MAX_ITR[0])  # --n_itr
    cut = enc.recipe
    enc.recipe = replace(
        cut,
        warmup=Warmup(tuple(
            replace(wp, training_phase=replace(wp.training_phase, max_itr=WARMUP_MAX_ITR))
            for wp in cut.warmup.phases)),
        all_phases=cut.all_phases[:1] + tuple(
            replace(p, max_itr=n) for p, n in zip(cut.all_phases[1:], PHASE_MAX_ITR[1:])),
    )
    reductions = {
        "warmup_max_itr": [wp.training_phase.max_itr for wp in full.warmup.phases],
        "warmup_max_itr_run": [wp.training_phase.max_itr for wp in enc.recipe.warmup.phases],
        "phase_max_itr": [p.max_itr for p in full.all_phases],
        "phase_max_itr_run": [p.max_itr for p in enc.recipe.all_phases],
    }
    dec = DecoderConfig()
    emit({"phase": "main_path_config", "img_size": [IMG_H, IMG_W], "dec_cfg": vars(dec),
          "candidates": [wp.candidates for wp in enc.recipe.warmup.phases], "reduced": reductions})

    run_cfg = RunConfig(input=path, lmbda=1e-3, workdir=OUT_DIR, enc_cfg=enc, dec_cfg=dec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ar.launch_count = 0
    run = encode_one_run(run_cfg, seed=0, device="cuda")
    launches = ar.launch_count
    stats = run.result.stats

    cfg = dec.to_coolchic_config((IMG_H, IMG_W))
    launches_per_forward = math.ceil(sum(c for c, _, _ in cfg.latent_shapes) / ar.MAX_PLANES)
    if launches != stats.n_eval_forwards * launches_per_forward:
        raise AssertionError(f"{launches} kernel launches for {stats.n_eval_forwards} eval forwards")
    row = run.row
    for k in ("loss", "psnr_db_estimate", "rate_latent_bpp", "rate_nn_bpp"):
        if not math.isfinite(row[k]):
            raise AssertionError(f"{k} is not finite: {row[k]}")
    flat_psnr = -10.0 * math.log10(float(np.mean((img - img.mean(axis=(1, 2), keepdims=True)) ** 2)))
    if not row["psnr_db_estimate"] > flat_psnr:
        raise AssertionError(f"PSNR {row['psnr_db_estimate']} <= flat-mean PSNR {flat_psnr}")
    params = run.result.params
    for latent, shape in zip(params["latents"], cfg.latent_shapes):
        if tuple(latent.shape) != shape or not torch.isfinite(latent).all():
            raise AssertionError(f"latent {tuple(latent.shape)} vs {shape} or not finite")

    # The final params on the card (ARM kernel) and on the CPU (plain ARM).
    target = torch.tensor(img, device="cuda")
    m_gpu = eval_metrics(params, cfg, target, 1e-3)
    m_cpu = eval_metrics(from_numpy_pytree(to_numpy_pytree(params), "cpu"), cfg, target.cpu(), 1e-3)
    cross = {k: (getattr(m_gpu, k).item(), getattr(m_cpu, k).item())
             for k in ("loss", "psnr_db", "rate_latent_bpp")}
    if abs(cross["rate_latent_bpp"][0] - cross["rate_latent_bpp"][1]) > 1e-4 * cross["rate_latent_bpp"][1]:
        raise AssertionError(f"card and CPU rates differ: {cross}")
    if abs(cross["psnr_db"][0] - cross["psnr_db"][1]) > 0.01:
        raise AssertionError(f"card and CPU PSNR differ: {cross}")

    train_s = sum(v for k, v in stats.stage_seconds.items() if not k.startswith("quantize"))
    emit({
        "phase": "main_path",
        "row": row,
        "flat_mean_psnr_db": flat_psnr,
        "stage_seconds": stats.stage_seconds,
        "n_train_steps": stats.n_train_steps,
        "train_steps_per_s": stats.n_train_steps / train_s,
        "n_eval_forwards": stats.n_eval_forwards,
        "arm_rate_launches": launches,
        "launches_per_eval_forward": launches_per_forward,
        "nn_quant": {m: i._asdict() for m, i in run.infos.items()},
        "card_vs_cpu_eval": cross,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    })
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a GPU",
              file=sys.stderr)
        return 1
    if not (REPO / "coolchic_tpu_torch").is_dir():
        print(f"chip_smoke: no coolchic_tpu_torch package beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    phase_build()
    pyramid = phase_kernel_checks()
    launches = phase_main_path()
    emit({"kernels": [{
        "name": "arm_rate",
        "route": "cuda",
        "source": "coolchic_tpu_torch/csrc/arm_rate.cu",
        "replaces": "coolchic_tpu/ops/pallas_arm.py:86",
        "launches": launches,
        "max_abs_err": pyramid["max_abs_err"],
        "ms": pyramid["ms"],
        "plain_ms": pyramid["plain_ms"],
        "bound_ms": pyramid["bound_ms"],
        "bound_by": pyramid["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
    }], "seconds": time.perf_counter() - t0})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
