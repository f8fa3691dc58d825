"""Bitstream writer: quantized params + latents -> decodable bytes.

Counterpart of ``coolchic_tpu/bitstream/encode.py``, byte for byte: for the
same quantized parameters both writers return the same stream. The params
(tensors on any device) are copied to the host once; everything after is
numpy float64 / integer code and the C++ entropy coder.

Mirrors the reference encoder flow (reference: coolchic/enc/bitstream/
encode.py:166-623): entropy-code the networks, reload them from the freshly
written streams through the real decoder (encoder/decoder sync), swap the
ARM for its fixed-point twin, run the eval forward to obtain the quantized
latents and their integer (mu, log sigma), then entropy-code every 2-D
latent grid. Output is bytes (GOP header + frame header + NN streams +
latent streams).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from coolchic_tpu_torch.bitstream.armint import (
    FPFB,
    armint_forward,
    context_int,
    integerize_arm_params,
)
from coolchic_tpu_torch.bitstream.entropy import WbDecoder, code_latent_layer, code_wb
from coolchic_tpu_torch.bitstream.header import (
    FrameHeader,
    GopHeader,
    write_frame_header,
    write_gop_header,
)
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.params import to_numpy_pytree
from coolchic_tpu_torch.train.quantize_model import Q_STEPS
from coolchic_tpu_torch.utils.trace import span

Params = Dict[str, Any]
_NN_ORDER = ["arm", "upsampling", "synthesis"]
HAVE_BIAS = {"arm": True, "upsampling": False, "synthesis": True}


def _shift_to_zero(v: np.ndarray, delta: int) -> np.ndarray:
    """Arithmetic shift toward zero (reference: bitstream/encode.py:317-324)."""
    if delta <= 0:
        return v
    pos = v >> delta
    neg = -((-v) >> delta)
    return np.where(v < 0, neg, pos)


def _q_step_index(module: str, kind: str, q_step: float) -> int:
    table = Q_STEPS[module][kind]
    return int(np.argmin(np.abs(table - float(q_step))))


def module_symbols(
    params: Params, module: str, q_idx_w: int, q_idx_b: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Integer symbols sent for one module, in named_parameters order
    (reference: bitstream/encode.py:279-385). For the ARM the symbols come
    from the fixed-point representation via to-zero shifts; for
    synthesis/upsampling they are round(param / q_step)."""
    net = to_numpy_pytree(params[module])
    if module == "arm":
        int_layers = integerize_arm_params(net)
        # q-step tables are powers of two: index i <-> shift -(len-1)+i.
        w_shift = 8 - q_idx_w  # abs shift of 2^(-8+i)
        b_shift = 16 - q_idx_b
        weights = np.concatenate(
            [
                _shift_to_zero(l["weight"].reshape(-1), FPFB - w_shift)
                for l in int_layers
            ]
        )
        biases = np.concatenate(
            [
                _shift_to_zero(l["bias"].reshape(-1), 2 * FPFB - b_shift)
                for l in int_layers
            ]
        )
        return weights, biases
    qw = Q_STEPS[module]["weight"][q_idx_w]
    if module == "upsampling":
        halves = list(net["ups"]) + list(net["preconcat"])
        weights = np.concatenate(
            [np.round(np.asarray(h, np.float64) / qw).astype(np.int64) for h in halves]
        )
        return weights, np.zeros((0,), np.int64)
    qb = Q_STEPS[module]["bias"][q_idx_b]
    weights = np.concatenate(
        [
            np.round(np.asarray(l["weight"], np.float64).reshape(-1) / qw).astype(np.int64)
            for l in net["layers"]
        ]
    )
    biases = np.concatenate(
        [
            np.round(np.asarray(l["bias"], np.float64).reshape(-1) / qb).astype(np.int64)
            for l in net["layers"]
        ]
    )
    return weights, biases


def _decode_network(
    cfg: CoolChicConfig,
    streams: Dict[str, Dict[str, bytes]],
    q_step_index_nn,
    scale_index_nn,
) -> Params:
    """Rebuild float network params from the written streams — the
    decoder-matched reload (reference: bitstream/encode.py:431-487,
    dec/nn.py:16-70)."""
    out: Params = {}

    # ARM
    qw = Q_STEPS["arm"]["weight"][q_step_index_nn["arm"]["weight"]]
    qb = Q_STEPS["arm"]["bias"][q_step_index_nn["arm"]["bias"]]
    layers = []
    dims = [cfg.dim_arm] * cfg.n_hidden_layers_arm + [2]
    with WbDecoder(streams["arm"]["weight"]) as wdec, WbDecoder(streams["arm"]["bias"]) as bdec:
        for out_d in dims:
            w = wdec.decode_continue(out_d * cfg.dim_arm, scale_index_nn["arm"]["weight"])
            b = bdec.decode_continue(out_d, scale_index_nn["arm"]["bias"])
            layers.append(
                {
                    "weight": (w.astype(np.float64) * qw).reshape(out_d, cfg.dim_arm),
                    "bias": b.astype(np.float64) * qb,
                }
            )
    out["arm"] = {"layers": layers}

    # Upsampling (weights only; dead biases are zeros)
    qw = Q_STEPS["upsampling"]["weight"][q_step_index_nn["upsampling"]["weight"]]
    n = cfg.latent_n_grids - 1
    n_half_ups = (cfg.ups_k_size + 1) // 2
    n_half_pre = (cfg.ups_preconcat_k_size + 1) // 2
    count = scale_index_nn["upsampling"]["weight"]
    with WbDecoder(streams["upsampling"]["weight"]) as wdec:
        ups = [wdec.decode_continue(n_half_ups, count).astype(np.float64) * qw for _ in range(n)]
        pre = [wdec.decode_continue(n_half_pre, count).astype(np.float64) * qw for _ in range(n)]
    out["upsampling"] = {"ups": ups, "preconcat": pre}

    # Synthesis
    qw = Q_STEPS["synthesis"]["weight"][q_step_index_nn["synthesis"]["weight"]]
    qb = Q_STEPS["synthesis"]["bias"][q_step_index_nn["synthesis"]["bias"]]
    layers = []
    in_ft = cfg.total_latent_channels
    with WbDecoder(streams["synthesis"]["weight"]) as wdec, \
            WbDecoder(streams["synthesis"]["bias"]) as bdec:
        for out_ft, k, _res, _relu in cfg.parsed_synthesis_layers():
            w = wdec.decode_continue(
                out_ft * in_ft * k * k, scale_index_nn["synthesis"]["weight"]
            )
            b = bdec.decode_continue(out_ft, scale_index_nn["synthesis"]["bias"])
            layers.append(
                {
                    "weight": (w.astype(np.float64) * qw).reshape(out_ft, in_ft, k, k),
                    "bias": b.astype(np.float64) * qb,
                }
            )
            in_ft = out_ft
    out["synthesis"] = {"layers": layers}
    return out


def encode_frame_bitstream(
    params: Params,
    cfg: CoolChicConfig,
    nn_q_step: Dict[str, Dict[str, float]],
    nn_expgol_cnt: Dict[str, Dict[str, int]],
    display_index: int = 0,
    hls_sig_blksize: int = 16,
    flow_gain: int = 0,
    timings: Optional[Dict[str, float]] = None,
) -> Tuple[bytes, Params, List[np.ndarray]]:
    """Encode one frame. ``params`` must hold post-``quantize_model``
    networks (multiples of the chosen q-steps), as tensors on any device or
    as numpy arrays. ``flow_gain`` is written to the frame header (1 enables
    the decoder's motion compensation scale for P/B frames, reference:
    ccdecapi.cpp warp flo_gain). Spans (``utils/trace.py``): ``write.armint``
    around the integer ARM of each grid (``context_int`` +
    ``armint_forward``), ``write.entropy`` around the C++ entropy coder of
    each module and each grid (``code_wb``, ``code_latent_layer``). A
    ``timings`` dict, when given, receives their host seconds summed
    (``armint_s``, ``entropy_s``).

    Returns (frame bytes, decoder-matched float params, decoded latents).
    """
    params = to_numpy_pytree(params)
    armint_ns = entropy_ns = 0
    q_step_index_nn = {
        m: {
            "weight": _q_step_index(m, "weight", nn_q_step[m]["weight"]),
            "bias": _q_step_index(m, "bias", nn_q_step[m]["bias"])
            if HAVE_BIAS[m]
            else 0,
        }
        for m in _NN_ORDER
    }

    # ----- NN streams + AC_MAX_VAL (reference: encode.py:36-125).
    all_symbols = []
    streams: Dict[str, Dict[str, bytes]] = {m: {} for m in _NN_ORDER}
    scale_index_nn = {m: {} for m in _NN_ORDER}
    n_bytes_nn = {m: {} for m in _NN_ORDER}
    for m in _NN_ORDER:
        w_syms, b_syms = module_symbols(
            params, m, q_step_index_nn[m]["weight"], q_step_index_nn[m]["bias"]
        )
        all_symbols += [w_syms, b_syms]
        with span("write.entropy") as coded:
            cnt_w = nn_expgol_cnt[m].get("weight", -1)
            data_w, used_w = code_wb(w_syms, -1 if cnt_w is None else int(cnt_w))
            streams[m]["weight"] = data_w
            scale_index_nn[m]["weight"] = used_w
            n_bytes_nn[m]["weight"] = len(data_w)
            if HAVE_BIAS[m]:
                cnt_b = nn_expgol_cnt[m].get("bias", -1)
                data_b, used_b = code_wb(b_syms, -1 if cnt_b is None else int(cnt_b))
                streams[m]["bias"] = data_b
                scale_index_nn[m]["bias"] = used_b
                n_bytes_nn[m]["bias"] = len(data_b)
            else:
                streams[m]["bias"] = b""
                scale_index_nn[m]["bias"] = 0
                n_bytes_nn[m]["bias"] = 0
        entropy_ns += coded.ns

    ac_max_val_nn = int(
        np.ceil(np.abs(np.concatenate(all_symbols)).max() + 2)
    )

    # ----- Decoder-matched reload (reference: encode.py:431-487).
    dec_params = _decode_network(cfg, streams, q_step_index_nn, scale_index_nn)
    dec_params["latents"] = params["latents"]
    arm_int = integerize_arm_params(dec_params["arm"])

    # ----- Quantized latents + integer (mu, log sigma) per grid.
    gain = cfg.encoder_gain
    y_grids = [
        np.round(np.asarray(lat, np.float64) * gain).astype(np.int32)
        for lat in params["latents"]
    ]
    # Pinned-zero grids never received gradient, but their *raw* latents
    # still hold the warmup init (possibly small noise); the decoder must
    # see the exact zeros the training forward masked in.
    for g in cfg.frozen_zero_grids:
        y_grids[g][:] = 0
    ac_max_val_latent = int(
        np.ceil(max(np.abs(y).max() for y in y_grids) + 2)
    )
    y_grids = [
        np.clip(y, -ac_max_val_latent, ac_max_val_latent + 1) for y in y_grids
    ]

    latent_streams: List[bytes] = []
    n_bytes_per_latent: List[int] = []
    decoded_latents: List[np.ndarray] = []
    for y in y_grids:  # y: [C_i, H_i, W_i]
        c_i, h_i, w_i = y.shape
        with span("write.armint") as arm:
            ctx = context_int(y, cfg.dim_arm)
            mu_int, ls_int = armint_forward(arm_int, ctx)
        armint_ns += arm.ns
        with span("write.entropy") as coded:
            mu_int = mu_int.reshape(c_i, h_i, w_i)
            ls_int = ls_int.reshape(c_i, h_i, w_i)
            for ft in range(c_i):
                if np.abs(y[ft]).max() == 0:
                    latent_streams.append(b"")
                    n_bytes_per_latent.append(0)
                else:
                    data = code_latent_layer(
                        y[ft], mu_int[ft], ls_int[ft], h_i, w_i, hls_sig_blksize
                    )
                    latent_streams.append(data)
                    n_bytes_per_latent.append(len(data))
        entropy_ns += coded.ns
        decoded_latents.append(y)

    # ----- Frame header + concatenation (reference: encode.py:572-620).
    header = write_frame_header(
        FrameHeader(
            display_index=display_index,
            dim_arm=cfg.dim_arm,
            n_hidden_layers_arm=cfg.n_hidden_layers_arm,
            latent_n_grids=cfg.latent_n_grids,
            ups_k_size=cfg.ups_k_size,
            ups_preconcat_k_size=cfg.ups_preconcat_k_size,
            layers_synthesis=[
                f"{o}-{k}-{'residual' if r else 'linear'}-{'relu' if a else 'none'}"
                for (o, k, r, a) in cfg.parsed_synthesis_layers()
            ],
            flow_gain=flow_gain,
            ac_max_val_nn=ac_max_val_nn,
            ac_max_val_latent=ac_max_val_latent,
            hls_sig_blksize=hls_sig_blksize,
            q_step_index_nn=q_step_index_nn,
            scale_index_nn=scale_index_nn,
            n_bytes_nn=n_bytes_nn,
            n_ft_per_latent=list(cfg.n_ft_per_res),
            n_bytes_per_latent=n_bytes_per_latent,
        )
    )
    frame_bytes = header
    for m in _NN_ORDER:
        frame_bytes += streams[m]["weight"]
        frame_bytes += streams[m]["bias"]
    for s in latent_streams:
        frame_bytes += s
    if timings is not None:
        timings["armint_s"] = timings.get("armint_s", 0.0) + 1e-9 * armint_ns
        timings["entropy_s"] = timings.get("entropy_s", 0.0) + 1e-9 * entropy_ns
    return frame_bytes, dec_params, decoded_latents


def encode_image_bitstream(
    params: Params,
    cfg: CoolChicConfig,
    nn_q_step,
    nn_expgol_cnt,
    bitdepth: int = 8,
    frame_data_type: str = "rgb",
    hls_sig_blksize: int = 16,
    timings: Optional[Dict[str, float]] = None,
) -> bytes:
    """Full single-image bitstream: GOP header + one intra frame
    (reference: encode.py:166-218). ``timings`` as in
    ``encode_frame_bitstream``."""
    gop = write_gop_header(
        GopHeader(
            img_size=cfg.img_size,
            frame_data_type=frame_data_type,
            bitdepth=bitdepth,
            intra_period=0,
            p_period=0,
        )
    )
    frame, _, _ = encode_frame_bitstream(
        params, cfg, nn_q_step, nn_expgol_cnt, 0, hls_sig_blksize, timings=timings
    )
    return gop + frame
