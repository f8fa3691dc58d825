"""Encode CLI of the port: overfit, quantize the networks, write the
``.cool`` bitstream, for an image or a ``.yuv`` video.

Usage:
    python -m coolchic_tpu_torch.encode --input img.png --output img.cool \\
        --lmbda 1e-3 --enc_preset c3x --n_itr 10000 \\
        --dec_cfg cfg/dec/hop.yaml --workdir out/ [--device cuda]
    python -m coolchic_tpu_torch.encode --config runs.yaml [--device cuda]

``--config`` names a ``UserConfig`` YAML (``utils/types.py``): ``input``,
``lmbda`` and ``dec_cfg`` each a value or a list, expanded into the
cartesian product of runs, which are encoded one after another. When it
expands into several runs, run ``i`` writes into ``<workdir>/run_<i>`` and to
``<output stem>_<i><suffix>``, so that no run overwrites another's files.

A ``.yuv`` input (size, bitdepth and chroma format from its name, as
``seq_1920x1080_25fps_420_8b.yuv``) is a video: its GOP comes from the
encoder config's ``intra_period`` / ``p_period`` (``--config``), each frame
is overfitted in coding order (``video/encoder.py``), and ``--output`` gets
one multi-frame stream; ``results_best.tsv`` has the JAX encoder's video
columns and the workdir a ``video_encoder.pkl`` checkpoint.

For an image, writes the bitstream to ``--output`` and, into the workdir,
``results_best.tsv`` (the JAX encoder's columns, then ``rate_nn_bpp``) and
``params_quantized.npz`` (the quantized parameters in the JAX layout, keys
like ``arm/layers/0/weight``, plus ``q_step/<module>/<weight|bias>`` and
``expgol/<module>/<weight|bias>``). ``rate_bpp`` is the size of the real
stream, and ``psnr_db`` is measured on that stream decoded by the integer
pipeline (``bitstream/decode.py``), which is what a user of the file gets.
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch


def _build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="coolchic_tpu_torch image / video encoder")
    p.add_argument("--config", type=Path, default=None, help="UserConfig YAML")
    p.add_argument("--input", type=Path, default=None, help=".png / .ppm image or .yuv video")
    p.add_argument("--output", type=Path, default=None, help=".cool bitstream to write")
    p.add_argument("--workdir", type=Path, default=None)
    p.add_argument("--lmbda", type=float, default=1e-3)
    p.add_argument("--enc_preset", type=str, default="c3x", choices=["c3x", "debug"])
    p.add_argument("--n_itr", type=int, default=None, help="max_itr of the first phase")
    p.add_argument("--n_train_loops", type=int, default=1)
    p.add_argument("--dec_cfg", type=Path, default=None, help="DecoderConfig YAML")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hls_sig_blksize", type=int, default=16)
    p.add_argument("--disable_wandb", action="store_true",
                   help="turn off experiment logging (wandb, when installed)")
    p.add_argument("--device", type=str, default="cuda")
    return p


@dataclass
class EncodeRun:
    row: Dict[str, object]  # the results_best.tsv row
    result: object  # train.encode.EncodeResult of the best loop; a video's VideoEncoder
    infos: Optional[Dict]  # per-module ModuleQuantInfo
    bitstream: Optional[bytes] = None  # the .cool stream (None without NN quantization)


def write_results(workdir: Path, row: Dict[str, object]) -> None:
    """``results_best.tsv``: a header line and the row."""
    workdir.mkdir(parents=True, exist_ok=True)
    with open(workdir / "results_best.tsv", "w") as f:
        f.write("\t".join(row.keys()) + "\n")
        f.write("\t".join(str(v) for v in row.values()) + "\n")


def save_quantized_params(path: Path, params: Dict, infos: Optional[Dict]) -> None:
    from coolchic_tpu_torch.params import flatten_with_paths, to_numpy_pytree

    arrays = flatten_with_paths(to_numpy_pytree(params))
    for module, info in (infos or {}).items():
        arrays[f"q_step/{module}/weight"] = np.float32(info.q_step_w)
        arrays[f"q_step/{module}/bias"] = np.float32(info.q_step_b)
        arrays[f"expgol/{module}/weight"] = np.int32(info.expgol_w)
        arrays[f"expgol/{module}/bias"] = np.int32(info.expgol_b)
    np.savez(path, **arrays)


def encode_one_run(
    run_cfg, seed: int = 0, device: str | torch.device = "cuda", hls_sig_blksize: int = 16
) -> EncodeRun:
    """Encode one (image, lmbda, decoder config) run on ``device``: overfit
    and quantize there, then write the bitstream and decode it back on the
    host (integer pipeline) for the reported PSNR. A ``.yuv`` input is a
    video: ``encode_video_run``."""
    from coolchic_tpu_torch.bitstream import decode_bitstream, encode_image_bitstream
    from coolchic_tpu_torch.io.image import load_frame_data_from_file
    from coolchic_tpu_torch.train.encode import encode_frame_with_quant_info
    from coolchic_tpu_torch.utils.types import resolve_device

    if str(run_cfg.input).endswith(".yuv"):
        return encode_video_run(run_cfg, seed, device, hls_sig_blksize)
    device = resolve_device(device)
    fd = load_frame_data_from_file(str(run_cfg.input))
    cfg = run_cfg.dec_cfg.to_coolchic_config(fd.img_size)
    preset = run_cfg.enc_cfg.recipe
    target = torch.tensor(fd.data, device=device)

    best = None
    t0 = time.perf_counter()
    for loop in range(run_cfg.enc_cfg.n_train_loops):
        result, infos = encode_frame_with_quant_info(
            target, run_cfg.lmbda, cfg, preset, seed=seed + loop
        )
        if best is None or result.loss < best[0].loss:
            best = (result, infos)
    elapsed = time.perf_counter() - t0
    result, infos = best

    # Without NN quantization (a preset that never quantizes) there is no
    # decodable stream: the rate is nan and the PSNR stays the estimate.
    bitstream = None
    real_bpp, psnr_decoded = float("nan"), result.psnr_db
    if infos is not None:
        bitstream = encode_image_bitstream(
            result.params,
            cfg,
            {m: {"weight": float(i.q_step_w), "bias": float(i.q_step_b)} for m, i in infos.items()},
            {m: {"weight": int(i.expgol_w), "bias": int(i.expgol_b)} for m, i in infos.items()},
            bitdepth=fd.bitdepth,
            frame_data_type=fd.frame_data_type,
            hls_sig_blksize=hls_sig_blksize,
        )
        if run_cfg.output:
            Path(run_cfg.output).parent.mkdir(parents=True, exist_ok=True)
            Path(run_cfg.output).write_bytes(bitstream)
        real_bpp = len(bitstream) * 8 / cfg.n_pixels
        decoded_img, _ = decode_bitstream(bitstream, integer_pipeline=True)
        mse = float(np.mean((decoded_img - fd.data) ** 2))
        psnr_decoded = float(-10.0 * np.log10(mse + 1e-12))

    rate_nn_bits = sum(i.rate_bits for i in infos.values()) if infos else 0.0
    row = {
        "seq_name": Path(run_cfg.input).stem,
        "lmbda": run_cfg.lmbda,
        "rate_bpp": real_bpp,
        "n_pixels": cfg.n_pixels,
        "psnr_db": psnr_decoded,
        "psnr_db_estimate": result.psnr_db,
        "rate_latent_bpp": result.rate_latent_bpp,
        "loss": result.loss,
        "encoding_time_sec": elapsed,
        "rate_nn_bpp": rate_nn_bits / cfg.n_pixels,
    }
    if run_cfg.workdir:
        write_results(Path(run_cfg.workdir), row)
        save_quantized_params(Path(run_cfg.workdir) / "params_quantized.npz", result.params, infos)
    return EncodeRun(row, result, infos, bitstream)


def encode_video_run(
    run_cfg, seed: int = 0, device: str | torch.device = "cuda", hls_sig_blksize: int = 16
) -> EncodeRun:
    """Encode a .yuv sequence on ``device``: the GOP of the encoder config's
    ``intra_period`` / ``p_period`` (``p_period`` 0: ``max(intra_period, 1)``),
    one decoder per frame in coding order, one multi-frame stream. The row
    has the JAX encoder's video columns: ``psnr_db`` and ``rate_latent_bpp``
    are the means of the frames' estimates, ``rate_bpp`` the stream's size
    over all frames, ``loss`` nan. ``EncodeRun.result`` is the
    ``VideoEncoder``."""
    from coolchic_tpu_torch.io.image import parse_yuv_size
    from coolchic_tpu_torch.utils.types import resolve_device
    from coolchic_tpu_torch.video import CodingStructure, VideoEncoder

    device = resolve_device(device)
    w, h = parse_yuv_size(str(run_cfg.input))
    # 4:2:0 content trains with the 4:1:1-weighted MSE.
    fdt = "yuv420" if "420" in str(run_cfg.input) else "yuv444"
    cfg = run_cfg.dec_cfg.to_coolchic_config((h, w), frame_data_type=fdt)
    enc_cfg = run_cfg.enc_cfg
    cs = CodingStructure(intra_period=enc_cfg.intra_period,
                         p_period=enc_cfg.p_period or max(enc_cfg.intra_period, 1),
                         seq_name=Path(run_cfg.input).stem)
    enc = VideoEncoder(cs, cfg, enc_cfg.recipe, lmbda=run_cfg.lmbda,
                       n_loops=enc_cfg.n_train_loops, device=device)
    t0 = time.perf_counter()
    enc.encode(str(run_cfg.input), seed=seed, workdir=run_cfg.workdir)
    elapsed = time.perf_counter() - t0
    bitstream = enc.to_bitstream(hls_sig_blksize)
    if run_cfg.output:
        Path(run_cfg.output).parent.mkdir(parents=True, exist_ok=True)
        Path(run_cfg.output).write_bytes(bitstream)
    frames = list(enc.all_frame_encoders.values())
    row = {
        "seq_name": Path(run_cfg.input).stem,
        "lmbda": run_cfg.lmbda,
        "rate_bpp": len(bitstream) * 8 / (cfg.n_pixels * len(frames)),
        "n_pixels": cfg.n_pixels,
        "psnr_db": float(np.mean([e.psnr_db for e in frames])),
        "rate_latent_bpp": float(np.mean([e.rate_latent_bpp for e in frames])),
        "loss": float("nan"),
        "encoding_time_sec": elapsed,
    }
    if run_cfg.workdir:
        write_results(Path(run_cfg.workdir), row)
    return EncodeRun(row, enc, None, bitstream)


def main(argv=None) -> int:
    parser = _build_argparser()
    args = parser.parse_args(argv)
    from dataclasses import replace

    from coolchic_tpu_torch.utils import logging as cclog
    from coolchic_tpu_torch.utils.types import DecoderConfig, EncoderConfig, UserConfig

    if args.config is not None:
        user_cfg = UserConfig.from_yaml(args.config)
    else:
        if args.input is None:
            parser.error("--input or --config required")
        user_cfg = UserConfig(
            input=[args.input],
            lmbda=[args.lmbda],
            workdir=args.workdir,
            output=args.output,
            enc_cfg=EncoderConfig(
                std_recipe_name=args.enc_preset, n_itr=args.n_itr,
                n_train_loops=args.n_train_loops),
            dec_cfg=[DecoderConfig.from_yaml(args.dec_cfg) if args.dec_cfg else DecoderConfig()],
        )
    runs = user_cfg.get_run_configs()
    for i, run_cfg in enumerate(runs):
        if len(runs) > 1:  # a place of its own for each run's files
            out, wd = run_cfg.output, run_cfg.workdir
            run_cfg = replace(
                run_cfg,
                workdir=None if wd is None else wd / f"run_{i:03d}",
                output=None if out is None else out.with_name(f"{out.stem}_{i:03d}{out.suffix}"))
        # One logging run per encode run, as the JAX CLI opens.
        cclog.init(config={"input": str(run_cfg.input), "lmbda": run_cfg.lmbda,
                           "recipe": run_cfg.enc_cfg.std_recipe_name},
                   disable=args.disable_wandb)
        row = encode_one_run(run_cfg, args.seed, args.device, args.hls_sig_blksize).row
        cclog.log(row, step=i)
        cclog.finish()
        estimate = f" (estimate {row['psnr_db_estimate']:.3f})" if "psnr_db_estimate" in row else ""
        print(
            f"{row['seq_name']}: lmbda={row['lmbda']:.1e} psnr={row['psnr_db']:.3f} dB{estimate} "
            f"rate={row['rate_bpp']:.4f} bpp (latents estimated {row['rate_latent_bpp']:.4f}) "
            f"({row['encoding_time_sec']:.1f} s)"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
