"""Latent-retrain CLI: reload a trained video encoder's checkpoint,
re-initialize one frame's latent grids and retrain only them. Counterpart of
``coolchic_tpu/retrain_latents.py``, with the same flags plus ``--device``.

    python -m coolchic_tpu_torch.retrain_latents --checkpoint=wd/video_encoder.pkl \\
        --input=img.png --init=zeros --n_itr=1000 [--device cuda]

``--frame`` is the frame's index in coding order; its target is read at its
display order, a 4:2:0 frame with its chroma repeated 2x2, and a P / B frame
gets its decoded references from the checkpoint, as the video encoder
trained it. The checkpoint is written back with the retrained latents; the
frame's stored stream is dropped, so that ``to_bitstream`` writes it anew
(the networks and their quantization are unchanged). Runs on the GPU unless
given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict


def _build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="coolchic_tpu_torch latent retrainer")
    p.add_argument("--checkpoint", type=Path, required=True, help="video_encoder.pkl")
    p.add_argument("--input", type=Path, required=True)
    p.add_argument("--init", choices=["zeros", "noise", "keep"], default="zeros")
    p.add_argument("--n_itr", type=int, default=1000)
    p.add_argument("--lmbda", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--frame", type=int, default=0, help="coding-order index")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def retrain(args: argparse.Namespace) -> Dict[str, float]:
    """Retrain the latents; returns the eval loss and PSNR before (after the
    re-initialization) and after."""
    import numpy as np
    import torch

    from coolchic_tpu_torch.params import from_numpy_pytree, to_numpy_pytree
    from coolchic_tpu_torch.train.presets import TrainerPhase
    from coolchic_tpu_torch.train.step import eval_metrics, make_generator, run_phase
    from coolchic_tpu_torch.utils.types import resolve_device
    from coolchic_tpu_torch.video import load_video_encoder

    device = resolve_device(args.device)
    enc = load_video_encoder(args.checkpoint, device=device)
    entry = enc.all_frame_encoders[str(args.frame)]
    frame = enc.coding_structure.get_frame_from_coding_order(args.frame)
    cfg = enc.frame_cfg(frame.frame_type)
    lmbda = args.lmbda or entry.manager.lmbda
    params = from_numpy_pytree(entry.params, device)
    target = torch.tensor(np.concatenate(
        [enc._load_frame(str(args.input), frame.display_order), *enc._refs_for(frame)]),
        device=device)

    if args.init == "zeros":
        params["latents"] = [torch.zeros_like(t) for t in params["latents"]]
    elif args.init == "noise":
        params["latents"] = [
            1e-2 * torch.randn(t.shape, generator=make_generator(device, args.seed, i),
                               device=device)
            for i, t in enumerate(params["latents"])
        ]

    m0 = eval_metrics(params, cfg, target, lmbda)
    print(f"before: loss {m0.loss.item():.5f} psnr {m0.psnr_db.item():.2f} dB")

    phase = TrainerPhase(
        lr=1e-2,
        max_itr=args.n_itr,
        freq_valid=min(100, args.n_itr),
        schedule_lr=True,
        quantizer_type="softround",
        quantizer_noise_type="gaussian",
        softround_temperature=(0.3, 0.1),
        noise_parameter=(0.25, 0.1),
        optimized_module=("latents",),
    )
    params, logs = run_phase(params, target, lmbda, cfg, phase,
                             make_generator(device, args.seed + 1))
    print(f"after : loss {logs.loss:.5f} psnr {logs.psnr_db:.2f} dB "
          f"bpp {logs.rate_latent_bpp:.4f}")

    entry.params = to_numpy_pytree(params)
    entry.frame_bytes = None
    enc.save(args.checkpoint)
    print(f"updated {args.checkpoint}")
    return {"loss_before": m0.loss.item(), "psnr_db_before": m0.psnr_db.item(),
            "loss_after": logs.loss, "psnr_db_after": logs.psnr_db,
            "rate_latent_bpp_after": logs.rate_latent_bpp}


def main(argv=None) -> int:
    retrain(_build_argparser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
