"""Eval-mode ARM rate: wrapper of the CUDA kernel ``csrc/arm_rate.cu``.

Replaces ``coolchic_tpu/ops/pallas_arm.py::_kernel`` (launched there by
``arm_rate_pallas`` once per plane, through the ``arm_rate`` dispatcher).
Here one launch covers up to 64 planes of the latent pyramid, read where
they lie, with the weights read from the per-layer tensors: nothing is
concatenated or packed on the host or the device. ``arm_rate_pyramid_batch``
covers a batch of B images, each with its own ARM, in that same one launch:
the kernel finds image b's planes, weights and rates at b times a stride.

On a CPU tensor the wrapper runs the plain version
(``models/arm.py::arm_rate_plain``). On a CUDA tensor it launches the kernel
and raises if the build or the launch fails: there is no fallback.

Bound on an H100 SXM at 512x768 with 7 grids (524,256 latents),
dim_arm = 24, n_hidden = 2: 1,200 multiply-adds per latent, 1.26 GFLOP,
against ~4.2 MB of plane-in / rate-out traffic (~1.3 us at 3.35 TB/s): bound
by operations. The kernel does them in f64 on the tensor cores (67 TFLOP/s
dense), ~18.8 us; 3xTF32 at the TF32 peak (495 TFLOP/s) would take ~7.6 us
but misses f32 accuracy (see the kernel's note). ``chip_smoke.py``
recomputes the bounds for the shapes it runs.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from coolchic_tpu_torch.models.arm import arm_rate_plain

# Kernel launches by this wrapper in this process (comparison runs included);
# callers that count a run set it to 0 first.
launch_count = 0

MAX_PLANES = 64  # kMaxPlanes of csrc/arm_rate.cu: planes per launch
MAX_HIDDEN = 1023  # kMaxHidden of csrc/arm_rate.cu
MAX_IMAGES = 65535  # images per launch: the batch is the grid's second dimension
_LIB = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from coolchic_tpu_torch.ops.build import load_library

        lib, _ = load_library("arm_rate")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.arm_rate_launch.argtypes = [p, p, p, p, p, p, i, p, i, i, i, ctypes.c_longlong, p]
        lib.arm_rate_launch.restype = ctypes.c_int
        limits = (ctypes.c_int(), ctypes.c_int())
        lib.arm_rate_limits(ctypes.byref(limits[0]), ctypes.byref(limits[1]))
        if (limits[0].value, limits[1].value) != (MAX_PLANES, MAX_HIDDEN):
            raise RuntimeError("csrc/arm_rate.cu and ops/arm_rate.py disagree on their limits")
        _LIB = lib
    return _LIB


class PlaneTable(NamedTuple):
    """Geometry of a pyramid of [C, H, W] grids, one entry per plane in
    forward order (grid-major, then channel): its grid, channel, H, W and
    offset into the flat rate; the chunks of at most ``MAX_PLANES`` planes,
    one launch each, with their ctypes arrays of H, W, offset and stride
    (the floats from a plane to the same plane of the batch's next image:
    its grid's C * H * W)."""

    planes: Tuple[Tuple[int, int, int, int, int], ...]
    n_latents: int
    chunks: Tuple[Tuple[int, int, ctypes.Array, ctypes.Array, ctypes.Array, ctypes.Array], ...]

    @property
    def n_launches(self) -> int:
        return len(self.chunks)


@lru_cache(maxsize=64)
def plane_table(shapes: Tuple[Tuple[int, int, int], ...]) -> PlaneTable:
    """The plane table of grids of these [C, H, W] shapes (cached)."""
    planes, strides, offset = [], [], 0
    for grid, (c, h, w) in enumerate(shapes):
        for ch in range(c):
            planes.append((grid, ch, h, w, offset))
            strides.append(c * h * w)
            offset += h * w
    chunks = []
    for start in range(0, len(planes), MAX_PLANES):
        part = planes[start : start + MAX_PLANES]
        n = len(part)
        chunks.append((
            start, n,
            (ctypes.c_int * n)(*[p[2] for p in part]),
            (ctypes.c_int * n)(*[p[3] for p in part]),
            (ctypes.c_longlong * n)(*[p[4] for p in part]),
            (ctypes.c_longlong * n)(*strides[start : start + n]),
        ))
    return PlaneTable(tuple(planes), offset, tuple(chunks))


def layer_table(
    arm_params: Dict, dim_arm: int, n_hidden: int, device, n_images: Optional[int] = None
) -> List[torch.Tensor]:
    """The tensors the kernel reads, in its order: weight, bias of each hidden
    layer, then of the head; with ``n_images``, each with that leading axis.
    Raises on what the kernel does not take: another layer count or shape,
    another dtype than f32, a non-contiguous tensor, or another device than
    the latents'."""
    layers = arm_params["layers"]
    if len(layers) != n_hidden + 1:
        raise ValueError(f"expected {n_hidden + 1} ARM layers, found {len(layers)}")
    if n_hidden > MAX_HIDDEN:
        raise ValueError(f"the ARM kernel takes at most {MAX_HIDDEN} hidden layers")
    out = []
    lead = () if n_images is None else (n_images,)
    for i, layer in enumerate(layers):
        out_ft = 2 if i == n_hidden else dim_arm
        w, b = layer["weight"], layer["bias"]
        if tuple(w.shape) != lead + (out_ft, dim_arm) or tuple(b.shape) != lead + (out_ft,):
            raise ValueError(f"ARM layer {i}: weight {tuple(w.shape)}, bias {tuple(b.shape)}")
        if w.dtype != torch.float32 or b.dtype != torch.float32:
            raise TypeError("ARM weights must be float32")
        if not (w.is_contiguous() and b.is_contiguous()):
            raise ValueError(f"ARM layer {i}: weight and bias must be contiguous")
        if w.device != device or b.device != device:
            raise ValueError("ARM weights and latents must be on one device")
        out += [w, b]
    return out


def launch_arm_rate(
    latents: Sequence[torch.Tensor],
    rate: torch.Tensor,
    layers: Sequence[torch.Tensor],
    table: PlaneTable,
    dim_arm: int,
    n_hidden: int,
    n_images: int = 1,
) -> None:
    """Launch the kernel on CUDA buffers: contiguous f32 ``latents`` grids
    ([C, H, W], or [n_images, C, H, W]) described by ``table``, the f32
    ``rate`` output ([n_latents], or [n_images, n_latents]), ``layers`` from
    ``layer_table``. One launch per chunk of the table, each over all the
    images; raises on a launch error."""
    global launch_count
    lib = _library()
    device = rate.device
    stream = torch.cuda.current_stream(device).cuda_stream
    bases = [y.data_ptr() for y in latents]
    plane_ptrs = [bases[g] + 4 * ch * h * w for g, ch, h, w, _ in table.planes]
    layer_ptrs = (ctypes.c_void_p * len(layers))(*[t.data_ptr() for t in layers])
    with torch.cuda.device(device):
        for start, n, hs, ws, offs, strides in table.chunks:
            ptrs = (ctypes.c_void_p * n)(*plane_ptrs[start : start + n])
            err = lib.arm_rate_launch(
                rate.data_ptr(), ptrs, hs, ws, offs, strides, n, layer_ptrs, n_hidden, dim_arm,
                n_images, table.n_latents, stream,
            )
            if err != 0:
                raise RuntimeError(f"arm_rate kernel launch failed with CUDA error {err}")
            launch_count += 1


def _checked_device(latents: Sequence[torch.Tensor], dim_arm: int, n_dims: int) -> torch.device:
    if dim_arm not in (8, 16, 24, 32):
        raise ValueError(f"dim_arm must be 8, 16, 24 or 32, found {dim_arm}")
    device = latents[0].device
    for y in latents:
        if y.dim() != n_dims:
            raise ValueError(f"latent grids have {n_dims} axes here, found {tuple(y.shape)}")
        if y.dtype != torch.float32:
            raise TypeError(f"latents must be float32, found {y.dtype}")
        if y.device != device:
            raise ValueError("all latent grids must be on one device")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"arm_rate runs on cpu or cuda tensors, found {device}")
    return device


def arm_rate_pyramid(
    latents: Sequence[torch.Tensor], arm_params: Dict, dim_arm: int, n_hidden: int
) -> torch.Tensor:
    """Flat rate in bits over a pyramid of quantized [C, H, W] latent grids,
    in forward order (grid-major, then channel, then raster)."""
    device = _checked_device(latents, dim_arm, 3)
    if device.type == "cpu":
        return arm_rate_plain(latents, arm_params, dim_arm)[0]
    layers = layer_table(arm_params, dim_arm, n_hidden, device)
    latents = [y.contiguous() for y in latents]
    table = plane_table(tuple(tuple(y.shape) for y in latents))
    rate = torch.empty(table.n_latents, device=device)
    launch_arm_rate(latents, rate, layers, table, dim_arm, n_hidden)
    return rate


def arm_rate_pyramid_batch(
    latents: Sequence[torch.Tensor], arm_params: Dict, dim_arm: int, n_hidden: int
) -> torch.Tensor:
    """Rates [B, n_latents] of B images, each with its own ARM, in one kernel
    launch: ``latents[i]`` is [B, C_i, H_i, W_i] and every ARM weight and
    bias has the leading [B] axis. Row b equals ``arm_rate_pyramid`` on image
    b's grids and weights."""
    device = _checked_device(latents, dim_arm, 4)
    n_images = latents[0].shape[0]
    if any(y.shape[0] != n_images for y in latents):
        raise ValueError("all latent grids must hold the same number of images")
    if not 1 <= n_images <= MAX_IMAGES:
        raise ValueError(f"a batch holds 1 to {MAX_IMAGES} images, found {n_images}")
    if device.type == "cpu":
        return arm_rate_plain(latents, arm_params, dim_arm)[0]
    layers = layer_table(arm_params, dim_arm, n_hidden, device, n_images)
    latents = [y.contiguous() for y in latents]
    table = plane_table(tuple(tuple(y.shape[1:]) for y in latents))
    rate = torch.empty(n_images, table.n_latents, device=device)
    launch_arm_rate(latents, rate, layers, table, dim_arm, n_hidden, n_images)
    return rate


def arm_rate(
    latent_plane: torch.Tensor, arm_params: Dict, dim_arm: int, n_hidden: int
) -> torch.Tensor:
    """Rate map [H, W] in bits of one quantized latent plane."""
    if latent_plane.dim() != 2:
        raise ValueError(f"expected an [H, W] plane, found {tuple(latent_plane.shape)}")
    rate = arm_rate_pyramid([latent_plane[None]], arm_params, dim_arm, n_hidden)
    return rate.reshape(latent_plane.shape)
