"""ctypes bindings for the host C++ entropy / decoder backend of ``cpp/``.

Counterpart of ``coolchic_tpu/bitstream/entropy.py``. The library is built
from the sources in the repo's ``cpp/`` (``entropy_api.cpp``,
``arm_decode.cpp``, ``ups_syn_int.cpp``, ``frame_decoder.cpp``) with g++ at
first use, into ``coolchic_tpu_torch/_build/`` (``ops/build.py``): nothing
is written into ``cpp/``. All of it is host integer code; no function here
touches a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import numpy as np

from coolchic_tpu_torch.models.arm import context_offsets
from coolchic_tpu_torch.ops.build import build_cpp

_SOURCES = ("entropy_api.cpp", "arm_decode.cpp", "ups_syn_int.cpp", "frame_decoder.cpp")
_BIN_SOURCES = _SOURCES + ("ccdec_main.cpp",)

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p_t = ctypes.POINTER(ctypes.c_int32)
_f64p = ctypes.POINTER(ctypes.c_double)


def build_library() -> str:
    """Build the shared library (if it is not built yet); returns its path."""
    return str(build_cpp("libccz.so", _SOURCES))


def build_decoder_binary() -> str:
    """Build the standalone ``ccdec`` decoder executable
    (reference: coolchic/cpp/CMakeLists.txt ccdec target); returns its path."""
    return str(build_cpp("ccdec", _BIN_SOURCES, shared=False))


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library())
    c_int = ctypes.c_int
    signatures = {
        "ccz_buffer_free": (None, [_u8p]),
        "ccz_code_wb": (c_int, [_i32p_t, c_int, c_int, ctypes.POINTER(_u8p),
                                ctypes.POINTER(c_int)]),
        "ccz_code_latent_layer": (None, [_i32p_t, _i32p_t, _i32p_t, c_int, c_int, c_int,
                                         ctypes.POINTER(_u8p), ctypes.POINTER(c_int)]),
        "ccz_decode_latent_layer": (None, [_u8p, c_int, _i32p_t, _i32p_t, c_int, c_int, c_int,
                                           _i32p_t]),
        "ccz_wb_decoder_new": (ctypes.c_void_p, [_u8p, c_int]),
        "ccz_wb_decoder_continue": (None, [ctypes.c_void_p, c_int, c_int, _i32p_t]),
        "ccz_wb_decoder_free": (None, [ctypes.c_void_p]),
        "ccz_ups_syn_int": (None, [
            _i32p_t, _i32p_t, _i32p_t,  # latents, heights, widths
            c_int, c_int, c_int,  # n_res, ups_k, pre_k
            _i32p_t, _i32p_t,  # ups kernels, preconcat kernels
            _i32p_t, _i32p_t, _i32p_t,  # syn weights, biases, desc
            c_int,  # n_syn_layers
            _i32p_t,  # out
        ]),
        "ccz_decode_arm_latent_layer": (None, [
            _u8p, c_int,  # data
            _i32p_t, _i32p_t,  # weights, biases
            c_int, c_int,  # dim_arm, n_hidden
            _i32p_t, _i32p_t,  # ctx offsets dy, dx
            c_int, c_int, c_int,  # h, w, blk
            _i32p_t,  # out
        ]),
        "ccz_probe_bitstream": (c_int, [_u8p, c_int, _i32p_t]),
        "ccz_decode_image": (c_int, [_u8p, c_int, _i32p_t, _f64p]),
        "ccz_decode_video": (c_int, [_u8p, c_int, _i32p_t, _f64p]),
        "ccz_decode_many": (c_int, [ctypes.POINTER(_u8p), _i32p_t, c_int,
                                    ctypes.POINTER(_i32p_t), _i32p_t, _f64p, c_int, _i32p_t]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a).reshape(-1), np.int32)


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(_i32p_t)


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def code_wb(values, use_count: int = -1) -> Tuple[bytes, int]:
    """Entropy-code integer weights/biases. Returns (bytes, exp-Golomb order
    used); use_count=-1 searches orders 0..12 for the smallest stream
    (reference: ccencapi.cpp:97-177)."""
    lib = _load()
    v = _as_i32(values)
    out = _u8p()
    out_len = ctypes.c_int()
    count = lib.ccz_code_wb(
        _i32p(v), len(v), use_count, ctypes.byref(out), ctypes.byref(out_len)
    )
    data = ctypes.string_at(out, out_len.value)
    lib.ccz_buffer_free(out)
    return data, count


class WbDecoder:
    """Streaming decoder for concatenated weight/bias substreams
    (reference: ccencapi.cpp:412-454)."""

    def __init__(self, data: bytes):
        self._lib = _load()
        self._buf = np.frombuffer(data, np.uint8).copy()
        self._h = self._lib.ccz_wb_decoder_new(
            _u8(self._buf), len(self._buf)
        )

    def decode_continue(self, n: int, count: int) -> np.ndarray:
        out = np.empty(n, np.int32)
        self._lib.ccz_wb_decoder_continue(self._h, n, count, _i32p(out))
        return out

    def close(self):
        if self._h:
            self._lib.ccz_wb_decoder_free(self._h)
            self._h = None

    def __enter__(self) -> "WbDecoder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def code_latent_layer(xs, mus, log_scales, h: int, w: int, blk: int = 16) -> bytes:
    """Entropy-code one 2-D latent grid. xs are integer latents; mus /
    log_scales are fixed-point ints at 8 fractional bits (x256)
    (reference: ccencapi.cpp:179-365, called from enc/bitstream/encode.py
    with mu*256 / log_scale*256)."""
    lib = _load()
    xs, mus, ls = _as_i32(xs), _as_i32(mus), _as_i32(log_scales)
    if not len(xs) == h * w == len(mus) == len(ls):
        raise ValueError(f"latent layer {h}x{w}: {len(xs)} values, {len(mus)} mus, {len(ls)} scales")
    out = _u8p()
    out_len = ctypes.c_int()
    lib.ccz_code_latent_layer(
        _i32p(xs), _i32p(mus), _i32p(ls), h, w, blk,
        ctypes.byref(out), ctypes.byref(out_len),
    )
    data = ctypes.string_at(out, out_len.value)
    lib.ccz_buffer_free(out)
    return data


def decode_arm_latent_layer(
    data: bytes,
    int_layers,
    dim_arm: int,
    n_hidden: int,
    h: int,
    w: int,
    blk: int = 16,
) -> np.ndarray:
    """Sequential autoregressive decode of one latent grid: the C++ backend
    runs CABAC + the int32 ARM pixel by pixel (reference:
    cpp/cc-frame-decoder.cpp run_arm). ``int_layers`` is the output of
    armint.integerize_arm_params."""
    lib = _load()
    weights = _as_i32(np.concatenate([l["weight"].reshape(-1) for l in int_layers]))
    biases = _as_i32(np.concatenate([l["bias"].reshape(-1) for l in int_layers]))
    offs = context_offsets(dim_arm)
    dy = _as_i32([o[0] for o in offs])
    dx = _as_i32([o[1] for o in offs])
    buf = np.frombuffer(data, np.uint8).copy()
    out = np.empty(h * w, np.int32)
    lib.ccz_decode_arm_latent_layer(
        _u8(buf), len(buf),
        _i32p(weights), _i32p(biases), dim_arm, n_hidden,
        _i32p(dy), _i32p(dx), h, w, blk, _i32p(out),
    )
    return out.reshape(h, w)


def ups_syn_int(
    latents,  # list of [1, h_i, w_i] int arrays, full-res first
    heights,
    widths,
    ups_k_size: int,
    pre_k_size: int,
    ups_kernels_int: np.ndarray,  # [(n_res-1) * ups_k_size] 12-frac ints
    pre_kernels_int: np.ndarray,  # [(n_res-1) * pre_k_size]
    syn_w_int: np.ndarray,  # concatenated 12-frac ints (OIHW)
    syn_b_int: np.ndarray,  # concatenated 24-frac ints
    syn_desc: np.ndarray,  # [n_layers, 4] = out_ft, ks, residual, relu
) -> np.ndarray:
    """Fixed-point integer upsample + synthesize (cpp/ups_syn_int.cpp).
    Returns [out_ft, H, W] int32 at 12 fractional bits."""
    lib = _load()
    n_res = len(heights)
    lat = _as_i32(np.concatenate([np.asarray(l).reshape(-1) for l in latents]))
    hh, ww = _as_i32(heights), _as_i32(widths)
    uk, pk = _as_i32(ups_kernels_int), _as_i32(pre_kernels_int)
    sw, sb = _as_i32(syn_w_int), _as_i32(syn_b_int)
    desc = _as_i32(np.asarray(syn_desc).reshape(-1))
    n_layers = len(desc) // 4
    out_ft = int(desc[-4])
    out = np.empty(out_ft * heights[0] * widths[0], np.int32)
    lib.ccz_ups_syn_int(
        _i32p(lat), _i32p(hh), _i32p(ww), n_res, ups_k_size, pre_k_size,
        _i32p(uk), _i32p(pk), _i32p(sw), _i32p(sb), _i32p(desc), n_layers,
        _i32p(out),
    )
    return out.reshape(out_ft, heights[0], widths[0])


def probe_bitstream(data: bytes) -> Optional[dict]:
    """Parse headers without decoding: dict with img_size / c_out / bitdepth /
    frame_data_type / n_frames, or None if the C parser rejects the stream."""
    lib = _load()
    buf = np.frombuffer(data, np.uint8).copy()
    info = np.zeros(6, np.int32)
    rc = lib.ccz_probe_bitstream(
        _u8(buf), len(buf), _i32p(info)
    )
    if rc != 0:
        return None
    return {
        "img_size": (int(info[0]), int(info[1])),
        "c_out": int(info[2]),
        "bitdepth": int(info[3]),
        "frame_data_type": ["rgb", "yuv420", "yuv444"][int(info[4])],
        "n_frames": int(info[5]),
    }


def decode_image_cc(data: bytes) -> Optional[Tuple[np.ndarray, dict]]:
    """Whole-frame decode in one C call (header parse -> NN decode -> ARM ->
    integer ups/syn -> bitdepth rounding), the no-Python-overhead fast path
    (reference: cpp/cc-frame-decoder.cpp:1152-1168 decode_frame).

    Returns ([c, H, W] float image in [0, 1], info with headers/timings), or
    None when the stream uses a configuration the C path doesn't cover
    (n_ft_per_res != 1, unknown dim_arm) — callers fall back to
    decode_bitstream.
    """
    info = probe_bitstream(data)
    if info is None or info["frame_data_type"] != "rgb" or info["n_frames"] != 1:
        return None
    lib = _load()
    buf = np.frombuffer(data, np.uint8).copy()
    h, w = info["img_size"]
    out = np.empty(info["c_out"] * h * w, np.int32)
    times = (ctypes.c_double * 4)()
    rc = lib.ccz_decode_image(
        _u8(buf), len(buf),
        _i32p(out), times,
    )
    if rc < 0:
        return None
    max_dyn = 2.0 ** info["bitdepth"] - 1.0
    img = out.reshape(info["c_out"], h, w).astype(np.float32) / max_dyn
    info["timings"] = {
        "nn_sec": times[0], "arm_sec": times[1], "ups_syn_sec": times[2],
        "total_sec": times[3],
    }
    return img, info


def decode_video_cc(data: bytes) -> Optional[Tuple[np.ndarray, dict]]:
    """Whole-GOP decode in one C call: per-frame decode + fixed-point inter
    prediction (warp/bpred) + reference-storage round-trips
    (cpp/frame_decoder.cpp ccz_decode_video; reference: ccdecapi.cpp
    cc_decode_* frame loop). Returns ([n_frames, 3, H, W] int32 samples in
    display order, info), or None for configurations the C path doesn't
    cover (callers fall back to the python pipeline)."""
    info = probe_bitstream(data)
    if info is None:
        return None
    lib = _load()
    buf = np.frombuffer(data, np.uint8).copy()
    h, w = info["img_size"]
    out = np.empty(info["n_frames"] * 3 * h * w, np.int32)
    times = (ctypes.c_double * 4)()
    rc = lib.ccz_decode_video(
        _u8(buf), len(buf),
        _i32p(out), times,
    )
    if rc < 0:
        return None
    info["timings"] = {
        "nn_sec": times[0], "arm_sec": times[1], "ups_syn_sec": times[2],
        "total_sec": times[3],
    }
    return out.reshape(info["n_frames"], 3, h, w), info


def decode_many_cc(
    datas: list, n_threads: Optional[int] = None
) -> Optional[list]:
    """Decode independent bitstreams concurrently on a C thread pool
    (cpp/frame_decoder.cpp ccz_decode_many): plain data parallelism over
    streams, each decoded by the same single-stream entry points, so outputs
    are bit-identical to serial decodes. The reference decoder is strictly
    one stream per process (reference: cpp/ccdecapi.cpp main).

    Per stream the result mirrors the serial fast paths: rgb single-frame
    streams return ([c, H, W] float image in [0, 1], info) exactly like
    ``decode_image_cc``; everything else returns ([n_frames, 3, H, W] int32
    display-ordered samples, info) exactly like ``decode_video_cc``
    (``info["kind"]`` says which). Returns None if any header fails to
    parse; a stream the C decoder rejects gets ``None`` in its slot (caller
    falls back to the python pipeline for that stream only).
    """
    if not datas:
        return []
    lib = _load()
    infos = [probe_bitstream(d) for d in datas]
    if any(i is None for i in infos):
        return None
    n = len(datas)
    bufs = [np.frombuffer(d, np.uint8).copy() for d in datas]
    kinds, outs = [], []
    for info in infos:
        h, w = info["img_size"]
        if info["n_frames"] == 1 and info["frame_data_type"] == "rgb":
            kinds.append(0)
            outs.append(np.empty(info["c_out"] * h * w, np.int32))
        else:
            kinds.append(1)
            outs.append(np.empty(info["n_frames"] * 3 * h * w, np.int32))
    data_arr = (_u8p * n)(*[_u8(b) for b in bufs])
    out_arr = (_i32p_t * n)(*[_i32p(o) for o in outs])
    len_arr = np.array([len(b) for b in bufs], np.int32)
    kind_arr = np.array(kinds, np.int32)
    times = np.zeros((n, 4), np.float64)
    rcs = np.zeros(n, np.int32)
    if n_threads is None:
        n_threads = min(n, os.cpu_count() or 1)
    lib.ccz_decode_many(
        data_arr, _i32p(len_arr), n, out_arr, _i32p(kind_arr),
        times.ctypes.data_as(_f64p),
        int(n_threads), _i32p(rcs),
    )
    results: list = []
    for i, (info, kind, out) in enumerate(zip(infos, kinds, outs)):
        if rcs[i] < 0:
            results.append(None)
            continue
        h, w = info["img_size"]
        info = dict(info, kind="image" if kind == 0 else "video")
        info["timings"] = {
            "nn_sec": times[i, 0], "arm_sec": times[i, 1],
            "ups_syn_sec": times[i, 2], "total_sec": times[i, 3],
        }
        if kind == 0:
            max_dyn = 2.0 ** info["bitdepth"] - 1.0
            results.append(
                (out.reshape(info["c_out"], h, w).astype(np.float32) / max_dyn,
                 info)
            )
        else:
            results.append((out.reshape(info["n_frames"], 3, h, w), info))
    return results


def decode_latent_layer(data: bytes, mus, log_scales, h: int, w: int, blk: int = 16) -> np.ndarray:
    """Teacher-forced latent-layer decode (round-trip testing; the real
    decoder derives mu/sigma sequentially with the integer ARM)."""
    lib = _load()
    mus, ls = _as_i32(mus), _as_i32(log_scales)
    buf = np.frombuffer(data, np.uint8).copy()
    out = np.empty(h * w, np.int32)
    lib.ccz_decode_latent_layer(
        _u8(buf), len(buf),
        _i32p(mus), _i32p(ls), h, w, blk, _i32p(out),
    )
    return out.reshape(h, w)
