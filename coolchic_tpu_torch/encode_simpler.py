"""Single-image encode written out step by step: no config expansion, no
video, every stage a plain function call. Counterpart of
``coolchic_tpu/encode_simpler.py``, with the same flags plus ``--device``.

    python -m coolchic_tpu_torch.encode_simpler -i img.png -o img.cool \\
        --lmbda 1e-3 [--budget fast] [--dim_arm 24] ... [--device cuda]

The stages, in order:
  1. load the image and build the decoder's architecture,
  2. the warm-up's competition of candidate decoders,
  3. the preset's training phases (one ``run_phase`` each),
  4. after a phase flagged ``quantize_model``, the networks' quantization
     (an RD grid search),
  5. the bitstream written and decoded back by the integer pipeline.

The noise of each stage comes from the generators ``encode_frame`` would
use for the same seed. Runs on the GPU unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Dict, Optional


def _build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="simple single-image cool-chic encode")
    p.add_argument("-i", "--input", required=True, help="png/ppm image")
    p.add_argument("-o", "--output", default=None, help="bitstream path (.cool)")
    p.add_argument("--lmbda", type=float, default=1e-3)
    p.add_argument("--budget", choices=["debug", "fast", "medium", "slow"], default="fast")
    p.add_argument("--dim_arm", type=int, default=24)
    p.add_argument("--n_hidden_layers_arm", type=int, default=2)
    p.add_argument("--n_ft_per_res", default="1,1,1,1,1,1,1")
    p.add_argument(
        "--layers_synthesis",
        default="48-1-linear-relu,X-1-linear-none,X-3-residual-relu,X-3-residual-none",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def encode(args: argparse.Namespace) -> Dict[str, Optional[float]]:
    """Run the five stages; returns the encode's numbers: the estimate of
    the last phase (``loss``, ``psnr_db_estimate``, ``rate_latent_bpp``), and
    with ``--output`` the stream's ``bytes``, ``rate_bpp`` and decoded
    ``psnr_db`` (None without it)."""
    import numpy as np
    import torch

    from coolchic_tpu_torch.bitstream import decode_bitstream, encode_image_bitstream
    from coolchic_tpu_torch.io.image import load_frame_data_from_file
    from coolchic_tpu_torch.models.config import CoolChicConfig
    from coolchic_tpu_torch.params import tree_map
    from coolchic_tpu_torch.train.encode import warmup
    from coolchic_tpu_torch.train.presets import preset_c3x, preset_debug
    from coolchic_tpu_torch.train.quantize_model import quantize_model_with_info
    from coolchic_tpu_torch.train.step import make_generator, run_phase
    from coolchic_tpu_torch.utils.types import resolve_device

    # ---- 1. image + model architecture.
    device = resolve_device(args.device)
    fd = load_frame_data_from_file(str(args.input))
    target = torch.tensor(fd.data, device=device)
    cfg = CoolChicConfig(
        img_size=fd.img_size,
        n_ft_per_res=tuple(int(x) for x in args.n_ft_per_res.split(",")),
        layers_synthesis=tuple(args.layers_synthesis.split(",")),
        dim_arm=args.dim_arm,
        n_hidden_layers_arm=args.n_hidden_layers_arm,
    )
    if args.budget == "debug":
        preset = preset_debug()
    else:
        itrs = {"fast": 10_600, "medium": 30_000, "slow": 100_000}[args.budget]
        preset = preset_c3x(n_itr_per_phase=itrs)
    t0 = time.time()

    # ---- 2. warm-up: candidate initializations compete (a batch of one image).
    lmbdas = torch.tensor([args.lmbda], device=device)
    params = tree_map(lambda t: t[0],
                      warmup(target[None], lmbdas, cfg, preset.warmup, [args.seed]))
    print(f"warm-up done in {time.time() - t0:.1f} s")

    # ---- 3. training phases.
    infos, logs = None, None
    for idx, phase in enumerate(preset.all_phases):
        params, logs = run_phase(params, target, args.lmbda, cfg, phase,
                                 make_generator(device, args.seed, 1000 + idx))
        print(
            f"phase {idx}: {phase.max_itr:>6} itr | loss {logs.loss:.6f} "
            f"| psnr {logs.psnr_db:6.2f} dB | "
            f"{logs.rate_latent_bpp:.4f} bpp | {time.time() - t0:6.1f} s"
        )
        # ---- 4. post-training quantization of the networks.
        if phase.quantize_model:
            params, infos, _ = quantize_model_with_info(params, target, args.lmbda, cfg)

    out = {"loss": logs.loss, "psnr_db_estimate": logs.psnr_db,
           "rate_latent_bpp": logs.rate_latent_bpp, "bytes": None, "rate_bpp": None,
           "psnr_db": None}
    # ---- 5. bitstream + decode verification.
    if args.output and infos is not None:
        bs = encode_image_bitstream(
            params, cfg,
            {m: {"weight": float(i.q_step_w), "bias": float(i.q_step_b)} for m, i in infos.items()},
            {m: {"weight": int(i.expgol_w), "bias": int(i.expgol_b)} for m, i in infos.items()},
            bitdepth=fd.bitdepth, frame_data_type=fd.frame_data_type,
        )
        Path(args.output).write_bytes(bs)
        decoded, _ = decode_bitstream(bs, integer_pipeline=True)
        mse = float(np.mean((decoded - np.asarray(fd.data)) ** 2))
        out.update(bytes=len(bs), rate_bpp=len(bs) * 8 / cfg.n_pixels,
                   psnr_db=float(-10 * np.log10(mse + 1e-12)))
        print(
            f"bitstream: {len(bs)} bytes ({out['rate_bpp']:.4f} bpp), decoded PSNR "
            f"{out['psnr_db']:.2f} dB -> {args.output}"
        )
    return out


def main(argv=None) -> int:
    encode(_build_argparser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
