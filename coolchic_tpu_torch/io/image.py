"""Image I/O for the port: PNG and PPM (8-16 bit) into [3, H, W] float, and
planar YUV (420 / 444) files.

Counterpart of ``coolchic_tpu/io/image.py``. The encoder reads a PNG or PPM
image or one frame of a ``.yuv`` video (``load_frame_data_from_file``); the
decoder writes PNG, PPM and the frames of a decoded video stream.
"""

from __future__ import annotations

import math
import os
import re
from dataclasses import dataclass
from typing import Dict, Tuple, Union

import numpy as np


# A 420 frame is {"y": [1,H,W], "u": [1,H/2,W/2], "v": ...}; else [3, H, W].
FrameArray = Union[np.ndarray, Dict[str, np.ndarray]]


@dataclass
class FrameData:
    bitdepth: int
    frame_data_type: str  # "rgb" | "yuv444" | "yuv420"
    data: FrameArray  # [3, H, W] float32 in [0, 1]; a dict of planes for 4:2:0

    @property
    def img_size(self) -> Tuple[int, int]:
        if self.frame_data_type == "yuv420":
            return tuple(self.data["y"].shape[-2:])
        return tuple(self.data.shape[-2:])


def read_png(file_path: str) -> Tuple[np.ndarray, int]:
    """[3, H, W] float32 in [0, 1], bitdepth 8."""
    from PIL import Image

    img = np.asarray(Image.open(file_path).convert("RGB"), np.float32) / 255.0
    return img.transpose(2, 0, 1), 8


def write_png(data: np.ndarray, file_path: str) -> None:
    """Write [3, H, W] data in [0, 1] to an 8-bit PNG."""
    from PIL import Image

    arr = np.round(np.clip(data, 0, 1) * 255.0).astype(np.uint8).transpose(1, 2, 0)
    Image.fromarray(arr).save(file_path)


def read_ppm(file_path: str) -> Tuple[np.ndarray, int]:
    """[3, H, W] float32 in [0, 1] of a P6 PPM, plus its bitdepth."""
    with open(file_path, "rb") as f:
        raw = f.read()
    m = re.match(rb"P6\s+(\d+)\s+(\d+)\s+(\d+)\s", raw)
    if not m:
        raise ValueError(f"{file_path} is not a P6 PPM")
    width, height, max_val = (int(m.group(i)) for i in (1, 2, 3))
    bitdepth = int(math.log2(max_val + 1))
    dtype = np.uint8 if max_val <= 255 else np.dtype(">u2")  # PPM is big-endian
    data = np.frombuffer(raw, dtype=dtype, count=3 * width * height, offset=m.end())
    img = data.reshape(height, width, 3).transpose(2, 0, 1).astype(np.float32)
    return img / max_val, bitdepth


def write_ppm(data: np.ndarray, bitdepth: int, file_path: str) -> None:
    """Write [3, H, W] data in [0, 1] to a P6 PPM."""
    c, h, w = data.shape
    max_val = 2**bitdepth - 1
    dtype = np.uint8 if max_val <= 255 else np.dtype(">u2")
    interleaved = np.round(np.clip(data, 0, 1) * max_val).transpose(1, 2, 0).astype(dtype)
    with open(file_path, "wb") as f:
        f.write(f"P6\n{w} {h}\n{max_val}\n".encode())
        f.write(interleaved.tobytes())


def parse_yuv_size(file_path: str) -> Tuple[int, int]:
    """Width, height from names like seq_1920x1080_25fps_..._8b.yuv
    (reference: format/yuv.py:74-79)."""
    w, h = os.path.basename(file_path).split(".")[0].split("_")[1].split("x")
    return int(w), int(h)


def read_yuv(file_path: str, frame_idx: int, frame_data_type: str, bit_depth: int) -> FrameArray:
    """Read frame ``frame_idx`` of a planar YUV file (8 bit, or 16-bit
    little-endian samples above; reference: format/yuv.py:42-125)."""
    w, h = parse_yuv_size(file_path)
    if frame_data_type == "yuv420":
        w_uv, h_uv = w // 2, h // 2
    else:
        w_uv, h_uv = w, h
    byte_per_value = 1 if bit_depth == 8 else 2
    n_val_y, n_val_uv = h * w, h_uv * w_uv
    n_val = n_val_y + 2 * n_val_uv
    raw = np.memmap(
        file_path,
        mode="r",
        shape=n_val,
        offset=n_val * byte_per_value * frame_idx,
        dtype=np.uint16 if bit_depth > 8 else np.uint8,
    ).astype(np.float32)
    norm = 2.0**bit_depth - 1.0
    y = raw[:n_val_y].reshape(1, h, w) / norm
    u = raw[n_val_y : n_val_y + n_val_uv].reshape(1, h_uv, w_uv) / norm
    v = raw[n_val_y + n_val_uv :].reshape(1, h_uv, w_uv) / norm
    if frame_data_type == "yuv420":
        return {"y": y, "u": u, "v": v}
    return np.concatenate([y, u, v], axis=0)


def write_yuv(
    data: FrameArray, bitdepth: int, frame_data_type: str, file_path: str, norm: bool = True
) -> None:
    """Append one frame to a planar YUV file (reference: format/yuv.py:129-174)."""
    if frame_data_type == "yuv420":
        raw = np.concatenate([data[k].reshape(-1) for k in ("y", "u", "v")])
    else:
        raw = np.asarray(data).reshape(-1)
    if norm:
        raw = raw * (2.0**bitdepth - 1.0)
    dtype = np.uint16 if bitdepth > 8 else np.uint8
    with open(file_path, "ab") as f:
        f.write(np.round(raw).astype(dtype).tobytes())


def convert_444_to_420(yuv444: np.ndarray) -> Dict[str, np.ndarray]:
    """Nearest-neighbor chroma downsampling: the top-left sample of each 2x2
    block (reference: format/yuv.py:277-300)."""
    if yuv444.shape[0] != 3:
        raise ValueError(f"expected [3, H, W], found {yuv444.shape}")
    return {"y": yuv444[0:1], "u": yuv444[1:2, ::2, ::2], "v": yuv444[2:3, ::2, ::2]}


def convert_420_to_444(yuv420: Dict[str, np.ndarray]) -> np.ndarray:
    """Nearest-neighbor chroma upsampling (reference: format/yuv.py:303-317)."""
    u = np.repeat(np.repeat(yuv420["u"], 2, axis=-2), 2, axis=-1)
    v = np.repeat(np.repeat(yuv420["v"], 2, axis=-2), 2, axis=-1)
    return np.concatenate([yuv420["y"], u, v], axis=0)


def rgb2yuv(rgb: np.ndarray) -> np.ndarray:
    """RGB -> YUV 4:4:4, values in [0, 255] (reference: format/yuv.py:177-202)."""
    r, g, b = rgb[0:1], rgb[1:2], rgb[2:3]
    y = np.round(0.299 * r + 0.587 * g + 0.114 * b)
    u = np.round(-0.1687 * r - 0.3313 * g + 0.5 * b + 128)
    v = np.round(0.5 * r - 0.4187 * g - 0.0813 * b + 128)
    return np.concatenate([y, u, v], axis=0)


def yuv2rgb(yuv: np.ndarray) -> np.ndarray:
    """YUV 4:4:4 -> RGB, values in [0, 255] (reference: format/yuv.py:205-236)."""
    y, u, v = yuv[0:1], yuv[1:2], yuv[2:3]
    r = y - 0.000007154783816076815 * u + 1.4019975662231445 * v - 179.45477266423404
    g = y - 0.3441331386566162 * u - 0.7141380310058594 * v + 135.45870971679688
    b = y + 1.7720025777816772 * u + 0.00001542569043522235 * v - 226.8183044444304
    return np.concatenate([r, g, b], axis=0)


def load_frame_data_from_file(file_path: str, idx_display_order: int = 0) -> FrameData:
    """Load a frame from .png / .ppm, or frame ``idx_display_order`` of a .yuv
    file: 8 bit with an "_8b" tag in the name, else 10; 4:2:0 with a "420"
    tag, else 4:4:4."""
    if file_path.endswith(".yuv"):
        bitdepth = 8 if "_8b" in file_path else 10
        frame_data_type = "yuv420" if "420" in file_path else "yuv444"
        data = read_yuv(file_path, idx_display_order, frame_data_type, bitdepth)
    elif file_path.endswith(".png"):
        frame_data_type = "rgb"
        data, bitdepth = read_png(file_path)
    elif file_path.endswith(".ppm"):
        frame_data_type = "rgb"
        data, bitdepth = read_ppm(file_path)
    else:
        raise ValueError(f"Expected .png/.ppm/.yuv, found {file_path}")
    return FrameData(bitdepth, frame_data_type, data)
