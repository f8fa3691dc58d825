"""Eval-mode ARM rate: wrapper of the CUDA kernel ``csrc/arm_rate.cu``.

Replaces ``coolchic_tpu/ops/pallas_arm.py::_kernel`` (launched there by
``arm_rate_pallas`` once per plane, through the ``arm_rate`` dispatcher).
Here one launch covers every plane of the latent pyramid.

On a CPU tensor the wrapper runs the plain version
(``models/arm.py::arm_rate_plain``). On a CUDA tensor it launches the kernel
and raises if the build or the launch fails: there is no fallback.

Bound on an H100 SXM (67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s):
at 512x768 with 7 grids (524,256 latents), dim_arm = 24, n_hidden = 2, the
kernel does ~1,200 FMA per latent, ~1.3 GFLOP in all, against ~4.2 MB of
plane-in / rate-out traffic: ~19 us of f32 FMA against ~1.3 us of memory,
so it is bound by operations. ``chip_smoke.py`` recomputes the bound for
the shapes it runs.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from coolchic_tpu_torch.models.arm import arm_rate_plain

# Kernel launches by this wrapper in this process (comparison runs included);
# callers that count a run set it to 0 first.
launch_count = 0

MAX_PLANES = 64  # kMaxPlanes of csrc/arm_rate.cu
_LIB = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from coolchic_tpu_torch.ops.build import load_library

        lib, _ = load_library("arm_rate")
        lib.arm_rate_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.arm_rate_launch.restype = ctypes.c_int
        lib.arm_rate_max_planes.restype = ctypes.c_int
        if lib.arm_rate_max_planes() != MAX_PLANES:
            raise RuntimeError("csrc/arm_rate.cu and ops/arm_rate.py disagree on kMaxPlanes")
        _LIB = lib
    return _LIB


def pack_arm_weights(arm_params: Dict, dim_arm: int, n_hidden: int) -> torch.Tensor:
    """Flat f32 weights in the kernel's layout: per hidden layer W[C][C]
    (out-major) then b[C]; the head W[2][C], b[2]; zeros to a multiple of 4."""
    layers = arm_params["layers"]
    if len(layers) != n_hidden + 1:
        raise ValueError(f"expected {n_hidden + 1} ARM layers, found {len(layers)}")
    parts = []
    for i, layer in enumerate(layers):
        out_ft = 2 if i == n_hidden else dim_arm
        w, b = layer["weight"], layer["bias"]
        if tuple(w.shape) != (out_ft, dim_arm) or tuple(b.shape) != (out_ft,):
            raise ValueError(f"ARM layer {i}: weight {tuple(w.shape)}, bias {tuple(b.shape)}")
        if w.dtype != torch.float32 or b.dtype != torch.float32:
            raise TypeError("ARM weights must be float32")
        parts += [w.reshape(-1), b]
    flat = torch.cat(parts)
    pad = (-flat.numel()) % 4
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.contiguous()


def plane_table(latents: Sequence[torch.Tensor]) -> List[Tuple[int, int, int]]:
    """(H, W, offset into the flat vector) of every plane, in forward order."""
    planes, offset = [], 0
    for y in latents:
        c, h, w = y.shape
        for _ in range(c):
            planes.append((h, w, offset))
            offset += h * w
    return planes


def launch_arm_rate(
    flat: torch.Tensor,
    rate: torch.Tensor,
    weights: torch.Tensor,
    planes: Sequence[Tuple[int, int, int]],
    dim_arm: int,
    n_hidden: int,
) -> None:
    """Launch the kernel on prepared CUDA buffers: ``flat`` latents and
    ``rate`` output (f32, contiguous, one length), ``weights`` from
    ``pack_arm_weights``, ``planes`` from ``plane_table``. One launch per
    64 planes; raises on a launch error."""
    global launch_count
    lib = _library()
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    with torch.cuda.device(flat.device):
        for start in range(0, len(planes), MAX_PLANES):
            chunk = planes[start : start + MAX_PLANES]
            n = len(chunk)
            hs = (ctypes.c_int * n)(*[p[0] for p in chunk])
            ws = (ctypes.c_int * n)(*[p[1] for p in chunk])
            offs = (ctypes.c_longlong * n)(*[p[2] for p in chunk])
            err = lib.arm_rate_launch(
                flat.data_ptr(), rate.data_ptr(), weights.data_ptr(), weights.numel(),
                dim_arm, n_hidden, n, hs, ws, offs, stream,
            )
            if err != 0:
                raise RuntimeError(f"arm_rate kernel launch failed with CUDA error {err}")
            launch_count += 1


def arm_rate_pyramid(
    latents: Sequence[torch.Tensor], arm_params: Dict, dim_arm: int, n_hidden: int
) -> torch.Tensor:
    """Flat rate in bits over a pyramid of quantized [C, H, W] latent grids,
    in forward order (grid-major, then channel, then raster)."""
    if dim_arm not in (8, 16, 24, 32):
        raise ValueError(f"dim_arm must be 8, 16, 24 or 32, found {dim_arm}")
    device = latents[0].device
    for y in latents:
        if y.dim() != 3:
            raise ValueError(f"latent grids are [C, H, W], found {tuple(y.shape)}")
        if y.dtype != torch.float32:
            raise TypeError(f"latents must be float32, found {y.dtype}")
        if y.device != device:
            raise ValueError("all latent grids must be on one device")
    if device.type == "cpu":
        return arm_rate_plain(latents, arm_params, dim_arm)[0]
    if device.type != "cuda":
        raise ValueError(f"arm_rate runs on cpu or cuda tensors, found {device}")

    weights = pack_arm_weights(arm_params, dim_arm, n_hidden)
    if weights.device != device:
        raise ValueError("ARM weights and latents must be on one device")
    flat = torch.cat([y.reshape(-1) for y in latents])
    rate = torch.empty_like(flat)
    launch_arm_rate(flat, rate, weights, plane_table(latents), dim_arm, n_hidden)
    return rate


def arm_rate(
    latent_plane: torch.Tensor, arm_params: Dict, dim_arm: int, n_hidden: int
) -> torch.Tensor:
    """Rate map [H, W] in bits of one quantized latent plane."""
    if latent_plane.dim() != 2:
        raise ValueError(f"expected an [H, W] plane, found {tuple(latent_plane.shape)}")
    rate = arm_rate_pyramid([latent_plane[None]], arm_params, dim_arm, n_hidden)
    return rate.reshape(latent_plane.shape)
