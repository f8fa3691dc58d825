"""End-to-end sanity check of the port: encode -> bitstream -> decode.

The port's twin of ``test/sanity_check.py`` (``python -m test.sanity_check``
for the JAX package; reference: test/sanity_check.py:1-126):

    python -m coolchic_tpu_torch.utils.sanity_check [--device cpu]

encodes a small crop with the debug preset and a vlop-like decoder, writes
the bitstream, decodes it with the float pipeline on the same device, and
requires:
  (a) |encoder-estimated PSNR - decoded PSNR| < 0.1 dB
  (b) |real latent bpp - estimated bpp| / estimated < 20 % (when the
      estimate is over 0.05 bpp)

Without ``--image`` a deterministic synthetic 64x96 crop is used; with it,
the top-left 128x192 crop of the file.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--image", default=None, help="optional input image path (.png / .ppm)")
    p.add_argument("--lmbda", type=float, default=1e-3)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    import torch

    from coolchic_tpu_torch.bitstream import decode_bitstream, encode_image_bitstream
    from coolchic_tpu_torch.train.encode import encode_frame_with_quant_info
    from coolchic_tpu_torch.utils.types import DecoderConfig, EncoderConfig, resolve_device

    device = resolve_device(args.device)
    if args.image:
        from coolchic_tpu_torch.io.image import load_frame_data_from_file

        target_np = load_frame_data_from_file(args.image).data[:, :128, :192]
    else:
        h, w = 64, 96
        yy, xx = np.meshgrid(
            np.linspace(0, 1, h, dtype=np.float32),
            np.linspace(0, 1, w, dtype=np.float32),
            indexing="ij",
        )
        target_np = np.stack(
            [
                0.5 + 0.4 * np.sin(7 * xx) * np.cos(3 * yy),
                yy * 0.8 + 0.1,
                0.5 * (xx + yy),
            ],
            0,
        )
    target = torch.tensor(target_np, device=device)

    dec_cfg = DecoderConfig(
        arm="8,1",
        layers_synthesis="8-1-linear-relu,X-1-linear-none,X-3-residual-none",
        n_ft_per_res="1,1,1,1",
    )  # vlop-like (reference uses cfg/dec/vlop.cfg)
    cfg = dec_cfg.to_coolchic_config(tuple(target.shape[-2:]))
    preset = EncoderConfig(std_recipe_name="debug").recipe

    print("Encoding (debug preset)...")
    result, infos = encode_frame_with_quant_info(target, args.lmbda, cfg, preset, seed=0)
    est_psnr, est_bpp = result.psnr_db, result.rate_latent_bpp

    nn_q_step = {m: {"weight": float(i.q_step_w), "bias": float(i.q_step_b)}
                 for m, i in infos.items()}
    nn_expgol = {m: {"weight": int(i.expgol_w), "bias": int(i.expgol_b)}
                 for m, i in infos.items()}
    bitstream = encode_image_bitstream(result.params, cfg, nn_q_step, nn_expgol)

    print("Decoding...")
    img, info = decode_bitstream(bitstream, device=device)
    dec_psnr = -10.0 * np.log10(np.mean((img - target_np) ** 2) + 1e-10)
    latent_bytes = sum(info["frame_header"].n_bytes_per_latent)
    real_latent_bpp = latent_bytes * 8 / cfg.n_pixels
    real_total_bpp = len(bitstream) * 8 / cfg.n_pixels

    print(f"estimated PSNR : {est_psnr:8.4f} dB")
    print(f"decoded  PSNR  : {dec_psnr:8.4f} dB")
    print(f"estimated bpp  : {est_bpp:8.4f} (latents)")
    print(f"real latent bpp: {real_latent_bpp:8.4f}")
    print(f"real total bpp : {real_total_bpp:8.4f} (incl. NN + headers)")

    ok = True
    if abs(dec_psnr - est_psnr) >= 0.1:
        print("FAIL: PSNR mismatch >= 0.1 dB")
        ok = False
    if est_bpp > 0.05 and abs(real_latent_bpp - est_bpp) / est_bpp >= 0.2:
        print("FAIL: latent rate mismatch >= 20 %")
        ok = False
    print("Sanity check " + ("PASSED" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
