"""Decode CLI of the port (counterpart of ``coolchic_tpu/decode.py``).

Usage:
    python -m coolchic_tpu_torch.decode -i bitstream.cool -o out.png [--device cuda]
    python -m coolchic_tpu_torch.decode -i bitstream.cool -o out.ppm --int
    python -m coolchic_tpu_torch.decode -i bitstream.cool -o out.yuv
    python -m coolchic_tpu_torch.decode -i streams_dir/ -o out_dir/ --threads 8

A single image is reconstructed by the float pipeline on ``--device`` (CUDA
unless ``--device cpu``), or with ``--int`` by the fixed-point pipeline of
the C++ backend, which is host code and needs no GPU. ``.yuv`` outputs and
directory mode (every ``*.cool`` inside, on a C thread pool:
cpp/frame_decoder.cpp ccz_decode_many) always run the integer pipeline.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


def _write_yuv_frames(frames, bitdepth: int, frame_data_type: str, out: Path) -> None:
    """Write display-ordered 444 frames as one planar file (420 content is
    subsampled back to what was decoded)."""
    from coolchic_tpu_torch.io.image import convert_444_to_420, write_yuv

    out.unlink(missing_ok=True)
    for frame in frames:
        if frame_data_type == "yuv420":
            write_yuv(convert_444_to_420(frame), bitdepth, "yuv420", str(out))
        else:
            write_yuv(frame, bitdepth, "yuv444", str(out))


def _decode_directory(args) -> int:
    from coolchic_tpu_torch.bitstream import decode_bitstreams
    from coolchic_tpu_torch.io.image import write_png, write_ppm

    paths = sorted(Path(args.input).glob("*.cool"))
    if not paths:
        print(f"no *.cool streams in {args.input}", file=sys.stderr)
        return 1
    outdir = Path(args.output)
    outdir.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    results = decode_bitstreams([p.read_bytes() for p in paths],
                                n_threads=args.threads or None)
    for p, (payload, info) in zip(paths, results):
        if info["kind"] == "image":
            out = outdir / (p.stem + ("." + args.ext))
            if args.ext == "png":
                write_png(payload, str(out))
            else:
                write_ppm(payload, info["bitdepth"], str(out))
        else:
            _write_yuv_frames(payload, info["bitdepth"], info["frame_data_type"],
                              outdir / (p.stem + ".yuv"))
    if args.verbosity:
        print(f"Decoded {len(paths)} streams in {(time.time()-t0)*1000:.1f} ms "
              f"-> {outdir}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="coolchic_tpu_torch decoder")
    p.add_argument("-i", "--input", type=Path, required=True)
    p.add_argument("-o", "--output", type=Path, required=True)
    p.add_argument("--verbosity", type=int, default=0)
    p.add_argument(
        "--int",
        action="store_true",
        help="fixed-point integer reconstruction (platform-deterministic)",
    )
    p.add_argument(
        "--threads", type=int, default=0,
        help="directory mode: decoder thread-pool size (0 = all cores)",
    )
    p.add_argument(
        "--ext", choices=("ppm", "png"), default="ppm",
        help="directory mode: image output format",
    )
    p.add_argument(
        "--device", type=str, default="cuda",
        help="where the float pipeline runs (ignored with --int, .yuv and directories)",
    )
    args = p.parse_args(argv)

    if Path(args.input).is_dir():
        return _decode_directory(args)

    from coolchic_tpu_torch.bitstream import decode_bitstream, decode_video_bitstream
    from coolchic_tpu_torch.io.image import write_png, write_ppm

    data = Path(args.input).read_bytes()
    out = str(args.output)
    t0 = time.time()
    if out.endswith(".yuv"):
        frames, vinfo = decode_video_bitstream(data)
        gop = vinfo["gop_header"]
        _write_yuv_frames(frames, gop.bitdepth, gop.frame_data_type, Path(out))
        elapsed = time.time() - t0
        if args.verbosity:
            h, w = gop.img_size
            print(f"Decoded {len(frames)} frames {w}x{h} {gop.frame_data_type} "
                  f"in {elapsed * 1000:.1f} ms -> {out}")
        return 0

    img, info = decode_bitstream(data, integer_pipeline=args.int, device=args.device)
    elapsed = time.time() - t0

    gop = info["gop_header"]
    if out.endswith(".png"):
        write_png(img, out)
    elif out.endswith(".ppm"):
        write_ppm(img, gop.bitdepth, out)
    else:
        raise ValueError(
            f"Unsupported output format: {out} (use .png, .ppm or .yuv)"
        )

    if args.verbosity:
        h, w = gop.img_size
        print(f"Decoded {w}x{h} {gop.frame_data_type} {gop.bitdepth}b "
              f"in {elapsed * 1000:.1f} ms -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
