"""Image I/O for the port: PNG and PPM (8-16 bit) into [3, H, W] float.

Counterpart of the RGB part of ``coolchic_tpu/io/image.py``; YUV waits for
the video slice.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class FrameData:
    bitdepth: int
    frame_data_type: str  # "rgb"
    data: np.ndarray  # [3, H, W] float32 in [0, 1]

    @property
    def img_size(self) -> Tuple[int, int]:
        return tuple(self.data.shape[-2:])


def read_png(file_path: str) -> Tuple[np.ndarray, int]:
    """[3, H, W] float32 in [0, 1], bitdepth 8."""
    from PIL import Image

    img = np.asarray(Image.open(file_path).convert("RGB"), np.float32) / 255.0
    return img.transpose(2, 0, 1), 8


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


def load_frame_data_from_file(file_path: str) -> FrameData:
    """Load an RGB frame from .png or .ppm."""
    if file_path.endswith(".png"):
        data, bitdepth = read_png(file_path)
    elif file_path.endswith(".ppm"):
        data, bitdepth = read_ppm(file_path)
    else:
        raise ValueError(f"Expected .png or .ppm (YUV waits for the video slice), found {file_path}")
    return FrameData(bitdepth, "rgb", data)
