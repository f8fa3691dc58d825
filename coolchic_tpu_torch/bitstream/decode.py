"""Bitstream decoder: bytes -> reconstructed image.

Counterpart of ``coolchic_tpu/bitstream/decode.py``. Pipeline (reference:
coolchic/cpp/cc-frame-decoder.cpp:1152-1168):
  1. parse GOP + frame headers,
  2. CABAC-decode and dequantize the three networks,
  3. sequentially decode every 2-D latent grid with the int32 ARM (C++
     backend, reference run_arm/arm_cpu),
  4. upsample + synthesize.

Stage 4 is either the fixed-point integer pipeline of the C++ backend
(``integer_pipeline=True``: host code, platform-deterministic, needs no
GPU, equal bit for bit to the JAX package's) or the float pipeline, which
runs the port's ``models/upsampling.py`` + ``models/synthesis.py`` in f32 on
``device`` (CUDA unless the caller asks for the CPU).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from coolchic_tpu_torch.bitstream.armint import integerize_arm_params
from coolchic_tpu_torch.bitstream.encode import _decode_network
from coolchic_tpu_torch.bitstream.entropy import (
    decode_arm_latent_layer,
    decode_image_cc,
    decode_many_cc,
    decode_video_cc,
    ups_syn_int,
)
from coolchic_tpu_torch.bitstream.header import (
    FrameHeader,
    GopHeader,
    read_frame_header,
    read_gop_header,
)
from coolchic_tpu_torch.bitstream.inter import HALF, PREC, process_inter_int
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.models.synthesis import synthesis_apply
from coolchic_tpu_torch.models.upsampling import upsampling_apply
from coolchic_tpu_torch.params import from_numpy_pytree, tree_map
from coolchic_tpu_torch.utils.types import resolve_device


def cfg_from_headers(gop: GopHeader, fh: FrameHeader) -> CoolChicConfig:
    return CoolChicConfig(
        img_size=gop.img_size,
        layers_synthesis=tuple(fh.layers_synthesis),
        n_ft_per_res=tuple(fh.n_ft_per_latent),
        dim_arm=fh.dim_arm,
        n_hidden_layers_arm=fh.n_hidden_layers_arm,
        ups_k_size=fh.ups_k_size,
        ups_preconcat_k_size=fh.ups_preconcat_k_size,
    )


def decode_bitstream(
    data: bytes,
    integer_pipeline: bool = False,
    full_info: bool = False,
    device: str | torch.device = "cuda",
) -> Tuple[np.ndarray, Dict]:
    """Decode a single-image bitstream.

    Args:
        integer_pipeline: True runs the fixed-point int32 pipeline
            (platform-deterministic like the reference decoder). The whole
            frame then decodes in ONE C call — header parse, NN decode, ARM,
            integer ups/syn (cpp/frame_decoder.cpp; reference:
            cc-frame-decoder.cpp:1152-1168) — unless ``full_info`` or an
            uncovered configuration forces the python-orchestrated path.
        full_info: return the parsed params and latents in the info dict
            (python-orchestrated decode; slower).
        device: where the float pipeline reconstructs the image. It is
            resolved only when ``integer_pipeline`` is false: the integer
            pipeline is host code and needs no GPU.

    Returns:
        (decoded image [C, H, W] float in [0, 1], info dict with the parsed
        headers; plus params and decoded latents on the python path).
    """
    if integer_pipeline and not full_info:
        fast = decode_image_cc(data)
        if fast is not None:
            img, cinfo = fast
            info = {"gop_header": read_gop_header(data), "timings": cinfo["timings"]}
            return img, info
    gop = read_gop_header(data)
    img, info, _ = _decode_frame(
        data, gop.n_bytes_header, gop, integer_pipeline=integer_pipeline, device=device
    )
    return img, info


def decode_bitstreams(
    datas: list, n_threads: int | None = None
) -> list:
    """Decode many independent bitstreams in parallel on a C thread pool
    (cpp/frame_decoder.cpp ccz_decode_many) — the production serving shape;
    the reference decoder handles one stream per process
    (reference: cpp/ccdecapi.cpp main). Outputs are bit-identical to
    serial ``decode_bitstream`` / ``decode_video_bitstream`` calls.

    Returns one (payload, info) per stream, matching the serial APIs:
    rgb single-frame streams yield ([C, H, W] float image in [0, 1], info);
    everything else yields ([display-ordered [3, H, W] float frames], info).
    ``info["kind"]`` is "image" or "video". Streams the C decoder rejects
    fall back to the python integer pipeline individually.

    Args:
        n_threads: pool size; default = min(n_streams, cpu count).
    """
    results = decode_many_cc(datas, n_threads=n_threads)
    if results is None:
        results = [None] * len(datas)
    out = []
    for data, res in zip(datas, results):
        if res is None:  # uncovered configuration: serial python fallback
            gop = read_gop_header(data)
            n_frames = gop.intra_period + 1 if gop.intra_period > 0 else 1
            # What the C route's info carries and a caller writes files by.
            stream = dict(img_size=gop.img_size, bitdepth=gop.bitdepth,
                          frame_data_type=gop.frame_data_type, n_frames=n_frames)
            if n_frames == 1 and gop.frame_data_type == "rgb":
                img, info = decode_bitstream(data, integer_pipeline=True)
                out.append((img, dict(info, kind="image", **stream)))
            else:
                frames, info = decode_video_bitstream(data)
                out.append((frames, dict(info, kind="video", **stream)))
            continue
        payload, info = res
        if info["kind"] == "video":
            max_dyn = np.float32((1 << info["bitdepth"]) - 1)
            payload = [f.astype(np.float32) / max_dyn for f in payload]
        out.append((payload, info))
    return out


def decode_video_bitstream(data: bytes, full_info: bool = False) -> Tuple[list, Dict]:
    """Decode a multi-frame bitstream with the reference decoder's exact
    integer pipeline (reference: cpp/ccdecapi.cpp:673-840):

      * frames arrive in coding order; the first is intra, later frames
        with 6/9 synthesis channels are motion-compensated (P: warp, B:
        warp x2 + bpred; bitstream/inter.py) against previously decoded
        frames found by display-index search. 3-channel later frames are
        treated as intra (this decoder's all-intra extension; the
        reference decoder has no such streams).
      * every output frame goes through the bitdepth quantization (and the
        420 chroma subsample for yuv420 content) BEFORE being stored as a
        reference, exactly like the reference
        (convert_444_420* / store_444*, ccdecapi.cpp:131-375).

    Returns ([display-ordered [3, H, W] float frames in [0, 1]], info).
    For yuv420 content the chroma planes of the returned 444 frames are
    the decoded subsamples expanded 2x2, so a nearest 444->420 conversion
    reproduces the decoded bytes exactly.

    ``full_info=False`` (default) runs the whole GOP in one C call
    (cpp/frame_decoder.cpp ccz_decode_video) with a python fallback;
    ``full_info=True`` forces the python-orchestrated pipeline (same
    integer math, exposes per-frame params/latents in the info dict).
    """
    gop = read_gop_header(data)
    if not full_info:
        fast = decode_video_cc(data)
        if fast is not None:
            samples, cinfo = fast
            max_dyn = np.float32((1 << gop.bitdepth) - 1)
            frames = [f.astype(np.float32) / max_dyn for f in samples]
            return frames, {"gop_header": gop, "timings": cinfo["timings"]}
    n_frames = gop.intra_period + 1 if gop.intra_period > 0 else 1
    ptr = gop.n_bytes_header
    max_dyn = (1 << gop.bitdepth) - 1

    stored: Dict[int, np.ndarray] = {}  # display idx -> [3, H, W] 12-frac ref
    out_by_display: Dict[int, np.ndarray] = {}
    info = None
    for coding_idx in range(n_frames):
        raw12, frame_info, ptr = _decode_frame_raw12(data, ptr, gop)
        info = frame_info
        fh = frame_info["frame_header"]
        c = raw12.shape[0]
        if coding_idx == 0 or c == 3:
            f444 = raw12[:3]
        else:
            ref_prev = next(
                (stored[i] for i in range(fh.display_index - 1, -1, -1)
                 if i in stored),
                None,
            )
            ref_next = None
            if c == 9:
                ref_next = next(
                    (stored[i] for i in
                     range(fh.display_index + 1, gop.intra_period + 1)
                     if i in stored),
                    None,
                )
            f444 = process_inter_int(raw12, ref_prev, ref_next, fh.flow_gain)

        # Output quantization, then re-expansion into the stored reference
        # (reference: get_raw_444_* / convert_444_420_* + store_444_* /
        # convert_420_444_*).
        vq = np.clip(
            (f444.astype(np.int64) * max_dyn + HALF) >> PREC, 0, max_dyn
        )
        if gop.frame_data_type == "yuv420":
            u = np.repeat(np.repeat(vq[1, ::2, ::2], 2, 0), 2, 1)
            v = np.repeat(np.repeat(vq[2, ::2, ::2], 2, 0), 2, 1)
            vq = np.stack([vq[0], u, v])
        stored[fh.display_index] = (vq.astype(np.int64) << PREC) // max_dyn
        out_by_display[fh.display_index] = (
            vq.astype(np.float32) / np.float32(max_dyn)
        )
    frames = [out_by_display[k] for k in sorted(out_by_display)]
    return frames, {"gop_header": gop, "last_frame_info": info}


def _decode_frame_raw12(
    data: bytes, ptr: int, gop: GopHeader
) -> Tuple[np.ndarray, Dict, int]:
    """Integer decode of one frame payload to the raw synthesis output at
    12 fractional bits ([c_out, H, W] int64; c_out = 3/6/9 for I/P/B)."""
    fh = read_frame_header(data[ptr:])
    ptr += fh.n_bytes_header
    cfg = cfg_from_headers(gop, fh)
    params, latents, ptr = _decode_frame_payload(data, ptr, fh, cfg)
    raw_int = _ups_syn_integer(params, latents, cfg)
    info = {
        "gop_header": gop,
        "frame_header": fh,
        "cfg": cfg,
        "params": params,
        "latents": latents,
    }
    return raw_int.astype(np.int64), info, ptr


def _decode_frame(
    data: bytes,
    ptr: int,
    gop: GopHeader,
    integer_pipeline: bool = False,
    device: str | torch.device = "cuda",
) -> Tuple[np.ndarray, Dict, int]:
    # A missing GPU should raise before the sequential latent decode.
    float_device = None if integer_pipeline else resolve_device(device)
    fh = read_frame_header(data[ptr:])
    ptr += fh.n_bytes_header
    cfg = cfg_from_headers(gop, fh)

    params, latents, ptr = _decode_frame_payload(data, ptr, fh, cfg)

    # ----- Upsample + synthesize.
    if integer_pipeline:
        raw = _ups_syn_integer(params, latents, cfg).astype(np.float64) / 4096.0
        max_dyn = 2.0**gop.bitdepth - 1.0
        img = np.clip(np.round(raw * max_dyn) / max_dyn, 0.0, 1.0)
    else:
        img = _ups_syn_float(params, latents, cfg, gop.bitdepth, float_device)

    info = {
        "gop_header": gop,
        "frame_header": fh,
        "cfg": cfg,
        "params": params,
        "latents": latents,
    }
    return img, info, ptr


def _ups_syn_float(
    params, latents, cfg: CoolChicConfig, bitdepth: int, device: torch.device
) -> np.ndarray:
    """Float reconstruction on ``device``: the decoded networks and latents
    cast to f32, the port's upsampling and synthesis, then the bitdepth
    rounding. TF32 is off for the convolutions, so a GPU computes what the
    CPU does up to the order of the sums. The integer levels leave the
    device and are divided by ``max_dyn`` on the host, as the integer
    pipeline's are: a CUDA division by a scalar multiplies by its reciprocal,
    which is an ulp off a true division on a sixth of the levels."""

    def on_device(tree):
        return from_numpy_pytree(tree_map(lambda a: np.asarray(a, np.float32), tree), device)

    max_dyn = 2.0**bitdepth - 1.0
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            dense = upsampling_apply(
                on_device(params["upsampling"]), on_device(list(latents)),
                cfg.ups_k_size, cfg.ups_preconcat_k_size,
            )
            raw = synthesis_apply(
                on_device(params["synthesis"]), dense, cfg.parsed_synthesis_layers()
            )
            levels = torch.clamp(torch.round(raw * max_dyn), 0.0, max_dyn)
    finally:
        torch.backends.cudnn.allow_tf32 = allow_tf32
    return levels.cpu().numpy() / np.float32(max_dyn)


def _decode_frame_payload(
    data: bytes, ptr: int, fh: FrameHeader, cfg: CoolChicConfig
) -> Tuple[Dict, List[np.ndarray], int]:
    """NN streams + sequential ARM latent decode of one frame payload."""
    streams = {m: {} for m in ("arm", "upsampling", "synthesis")}
    for m in ("arm", "upsampling", "synthesis"):
        for p in ("weight", "bias"):
            n = fh.n_bytes_nn[m][p]
            streams[m][p] = data[ptr : ptr + n]
            ptr += n
    params = _decode_network(cfg, streams, fh.q_step_index_nn, fh.scale_index_nn)
    arm_int = integerize_arm_params(params["arm"])

    latents: List[np.ndarray] = []
    grid_idx = 0
    for c_i, h_i, w_i in cfg.latent_shapes:
        planes = []
        for _ft in range(c_i):
            n = fh.n_bytes_per_latent[grid_idx]
            if n == 0:
                planes.append(np.zeros((h_i, w_i), np.int32))
            else:
                planes.append(
                    decode_arm_latent_layer(
                        data[ptr : ptr + n],
                        arm_int,
                        cfg.dim_arm,
                        cfg.n_hidden_layers_arm,
                        h_i,
                        w_i,
                        fh.hls_sig_blksize,
                    )
                )
            ptr += n
            grid_idx += 1
        latents.append(np.stack(planes, 0))
    return params, latents, ptr


def _ups_syn_integer(params, latents, cfg: CoolChicConfig) -> np.ndarray:
    """Fixed-point reconstruction via the C++ backend, returned as the raw
    [c_out, H, W] int32 synthesis output at 12 fractional bits. Integer
    weights are recovered exactly from the dequantized floats (power-of-two
    q-steps): 12-frac-bit kernels/weights, 24-frac-bit synthesis biases
    (reference: cpp/cc-frame-decoder.cpp decode_weights_qi)."""
    heights = [s[1] for s in cfg.latent_shapes]
    widths = [s[2] for s in cfg.latent_shapes]

    def full_kernel_int(half, k):
        half = np.asarray(half, np.float64)
        full = np.concatenate([half, half[::-1][k % 2 :]])
        return np.round(full * 4096.0).astype(np.int64)

    ups_k = np.concatenate(
        [full_kernel_int(h, cfg.ups_k_size) for h in params["upsampling"]["ups"]]
    )
    pre_k = np.concatenate(
        [
            full_kernel_int(h, cfg.ups_preconcat_k_size)
            for h in params["upsampling"]["preconcat"]
        ]
    )
    syn_w = np.concatenate(
        [
            np.round(np.asarray(l["weight"], np.float64).reshape(-1) * 4096.0)
            for l in params["synthesis"]["layers"]
        ]
    ).astype(np.int64)
    syn_b = np.concatenate(
        [
            np.round(np.asarray(l["bias"], np.float64) * float(2**24))
            for l in params["synthesis"]["layers"]
        ]
    ).astype(np.int64)
    desc = np.array(
        [
            [out_ft, k, int(res), int(relu)]
            for out_ft, k, res, relu in cfg.parsed_synthesis_layers()
        ]
    )
    out_int = ups_syn_int(
        [l.reshape(-1) for l in latents],
        heights,
        widths,
        cfg.ups_k_size,
        cfg.ups_preconcat_k_size,
        ups_k,
        pre_k,
        syn_w,
        syn_b,
        desc,
    )
    return out_int
