"""Image encode CLI of the port: overfit, quantize the networks, write the
``.cool`` bitstream.

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

Writes the bitstream to ``--output`` and, into the workdir,
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
    p = argparse.ArgumentParser(description="coolchic_tpu_torch image encoder")
    p.add_argument("--config", type=Path, default=None, help="UserConfig YAML")
    p.add_argument("--input", type=Path, default=None, help=".png or .ppm image")
    p.add_argument("--output", type=Path, default=None, help=".cool bitstream to write")
    p.add_argument("--workdir", type=Path, default=None)
    p.add_argument("--lmbda", type=float, default=1e-3)
    p.add_argument("--enc_preset", type=str, default="c3x", choices=["c3x", "debug"])
    p.add_argument("--n_itr", type=int, default=None, help="max_itr of the first phase")
    p.add_argument("--n_train_loops", type=int, default=1)
    p.add_argument("--dec_cfg", type=Path, default=None, help="DecoderConfig YAML")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hls_sig_blksize", type=int, default=16)
    p.add_argument("--device", type=str, default="cuda")
    return p


@dataclass
class EncodeRun:
    row: Dict[str, object]  # the results_best.tsv row
    result: object  # train.encode.EncodeResult of the best loop
    infos: Optional[Dict]  # per-module ModuleQuantInfo
    bitstream: Optional[bytes] = None  # the .cool stream (None without NN quantization)


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
    host (integer pipeline) for the reported PSNR."""
    from coolchic_tpu_torch.bitstream import decode_bitstream, encode_image_bitstream
    from coolchic_tpu_torch.io.image import load_frame_data_from_file
    from coolchic_tpu_torch.train.encode import encode_frame_with_quant_info
    from coolchic_tpu_torch.utils.types import resolve_device

    if str(run_cfg.input).endswith(".yuv"):
        raise NotImplementedError(
            f"{run_cfg.input}: .yuv inputs are video, which the video slice of the port "
            "(video/*, the P/B branches of frame_forward) will encode")
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
        workdir = Path(run_cfg.workdir)
        workdir.mkdir(parents=True, exist_ok=True)
        with open(workdir / "results_best.tsv", "w") as f:
            f.write("\t".join(row.keys()) + "\n")
            f.write("\t".join(str(v) for v in row.values()) + "\n")
        save_quantized_params(workdir / "params_quantized.npz", result.params, infos)
    return EncodeRun(row, result, infos, bitstream)


def main(argv=None) -> int:
    parser = _build_argparser()
    args = parser.parse_args(argv)
    from dataclasses import replace

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
        row = encode_one_run(run_cfg, args.seed, args.device, args.hls_sig_blksize).row
        print(
            f"{row['seq_name']}: lmbda={row['lmbda']:.1e} psnr={row['psnr_db']:.3f} dB "
            f"(estimate {row['psnr_db_estimate']:.3f}) rate={row['rate_bpp']:.4f} bpp "
            f"(latents estimated {row['rate_latent_bpp']:.4f}) ({row['encoding_time_sec']:.1f} s)"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
