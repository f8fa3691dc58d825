"""The upsampling's per-image 1-D filters, with a hand-written weight gradient.

``models/upsampling.py`` filters [C, B, H, W] tensors (latent channels on
the batch axis, images as groups) with one k-tap filter per image, in four
calls: a stride-2 transposed convolution along H and along W (each x2 step),
a zero-padded convolution along H and along W (each pre-concat filter).
``filter_1d`` is one such call. Its forward is the library's call as it
was, and so is the input gradient (``aten.convolution_backward`` with the
output mask ``(True, False, False)``); only the weight gradient is new.

On a CPU tensor the weight gradient is the plain version,
``weight_grad_plain``. On a CUDA tensor it is the kernel
``csrc/ups_wgrad.cu`` (one entry call, two launches: per-block partial sums,
then their sum per image in a fixed order), launched or raising: there is
no fallback to the library. The kernel replaces no TPU kernel; it was
added because the library's weight gradients (cuDNN's grouped direct and
``wgrad_alg0`` engines, ATen's ``conv_depthwise2d_grad_weight``) ran about
175x off the bytes' bound at 512x768, B = 8 on an H100 (15.3 ms of a 54.3 ms
step, against ~87 us for the ~290 MB the 24 weight gradients of a step read
at 3.35 TB/s); the kernel takes ~0.27 ms there. The split of each image's
C*H*W domain over thread blocks follows the shapes and the card's SM count
(``rows_plan``, ``cols_plan``); the kernel's note says the rest.

A gradient is computed only where ``ctx.needs_input_grad`` asks for it,
and without autograd (no grad mode, or neither input requiring a
gradient) ``filter_1d`` is the library's call alone.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import torch
import torch.nn.functional as F

# Entry calls of the kernel in this process (one per weight gradient on a
# CUDA tensor); callers that count a run set it to 0 first.
launch_count = 0

THREADS = 256  # kThreads of csrc/ups_wgrad.cu
CHUNK = 128  # kChunk of csrc/ups_wgrad.cu: A columns of a warp's item along columns
# Compile-time tap slots of the kernel. 16 covers every decoder a stream can
# carry: its header holds each kernel size in 4 bits (bitstream/header.py).
KMAX_CHOICES = (8, 16)
MAX_K = KMAX_CHOICES[-1]
MAX_IMAGES = 65535  # images per launch: the grid's second dimension
# The split aims at this many threads per SM: the row kernel keeps its
# window in 44-114 registers (500-1,400 resident threads an SM); the column
# kernel's 40-52 leave room for a full SM.
ROWS_THREADS_PER_SM = 1024
COLS_THREADS_PER_SM = 2048
_LIB = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from coolchic_tpu_torch.ops.build import load_library

        lib, _ = load_library("ups_wgrad")
        p = ctypes.c_void_p
        lib.ups_wgrad_launch.argtypes = [p, p, p, p, p, p]
        lib.ups_wgrad_launch.restype = ctypes.c_int
        for fn in (lib.ups_wgrad_threads, lib.ups_wgrad_chunk):
            fn.argtypes, fn.restype = [], ctypes.c_int
        if (lib.ups_wgrad_threads(), lib.ups_wgrad_chunk()) != (THREADS, CHUNK):
            raise RuntimeError("csrc/ups_wgrad.cu and ops/ups_filter.py disagree on their sizes")
        _LIB = lib
    return _LIB


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def conv_args(transposed: bool, axis: int, k: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """(stride, padding) of the library call: stride 2 along ``axis``
    (transposed), or zero padding k // 2 along it."""
    if axis not in (2, 3):
        raise ValueError(f"axis must be 2 (H) or 3 (W), found {axis}")
    if transposed:
        return ((2, 1) if axis == 2 else (1, 2)), (0, 0)
    return (1, 1), ((k // 2, 0) if axis == 2 else (0, k // 2))


def kmax_for(k: int) -> int:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the upsampling weight-gradient kernel takes 1 to {MAX_K} taps, found {k}")
    return next(m for m in KMAX_CHOICES if k <= m)


def rows_plan(n_c: int, n_b: int, a_h: int, width: int, k: int, vec: int, n_sm: int):
    """Split along rows: (KMAX, VEC, strip rows, strips, column groups,
    blocks per image). A thread owns VEC columns of one channel and walks a
    strip of A's rows; strips are cut so that the card holds about
    ``ROWS_THREADS_PER_SM`` threads an SM. A strip's steps wait on each
    other's loads, so a small grid gets short strips (down to one row) and
    the finest levels long ones, which load their first KMAX window rows
    less often."""
    kmax = kmax_for(k)
    n_cg = _cdiv(width, vec)
    want = _cdiv(n_sm * ROWS_THREADS_PER_SM, n_b * n_c * n_cg)
    strip = _cdiv(a_h, min(a_h, want))
    n_strips = _cdiv(a_h, strip)
    return kmax, vec, strip, n_strips, n_cg, _cdiv(n_c * n_strips * n_cg, THREADS)


def cols_plan(n_c: int, n_b: int, height: int, a_w: int, k: int, n_sm: int):
    """Split along columns: (KMAX, chunks per row, 0, 0, 0, blocks per
    image). A warp takes ``CHUNK`` columns of one row at a time; each image
    gets enough blocks for about ``COLS_THREADS_PER_SM`` threads an SM, and
    no more than its items keep busy."""
    n_chunks = _cdiv(a_w, CHUNK)
    want = _cdiv(n_sm * COLS_THREADS_PER_SM, n_b * THREADS)
    n_blk = max(1, min(want, _cdiv(n_c * height * n_chunks, THREADS // 32)))
    return kmax_for(k), n_chunks, 0, 0, 0, n_blk


@lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def weight_grad_plain(x: torch.Tensor, gy: torch.Tensor, k: int, transposed: bool,
                      axis: int) -> torch.Tensor:
    """dW [B, k] of ``filter_1d(x, w, transposed, axis)`` given its output
    gradient ``gy``: for each tap, the sum over c and the plane of ``gy``
    times ``x`` shifted by the tap (x zero-padded by k // 2 for the padded
    filter; for the transposed one, tap t of output row 2 i + t is x's row
    i)."""
    if axis == 3:
        x, gy = x.transpose(2, 3), gy.transpose(2, 3)
    if transposed:
        n = x.shape[2]
        taps = [(x * gy[:, :, t : t + 2 * n - 1 : 2]).sum((0, 2, 3)) for t in range(k)]
    else:
        n = gy.shape[2]
        xp = F.pad(x, (0, 0, k // 2, k // 2))
        taps = [(gy * xp[:, :, t : t + n]).sum((0, 2, 3)) for t in range(k)]
    return torch.stack(taps, dim=1)


def _unit_w_stride(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(3) == 1 or t.shape[3] == 1 else t.contiguous()


def weight_grad_cuda(x: torch.Tensor, gy: torch.Tensor, k: int, transposed: bool,
                     axis: int) -> torch.Tensor:
    """The kernel's dW [B, k] (f32) on CUDA tensors; raises on what it does
    not take (another dtype, devices that differ, more than ``MAX_K`` taps or
    ``MAX_IMAGES`` images) and on a refused launch. Its checks, the plan and
    the launch's arguments are worked out once per shape, strides, 16-byte
    alignment, dtypes and devices (``_launch_args``); a call then costs the
    host a dictionary lookup, one allocation and the launch."""
    global launch_count
    x, gy = _unit_w_stride(x), _unit_w_stride(gy)
    # A is read at every position; the window tensor at shifted positions.
    a, win = (x, gy) if transposed else (gy, x)
    index = x.get_device()
    geom, plan, out_shape = _launch_args(
        transposed, axis, k, a.shape, a.stride(), win.shape, win.stride(),
        (a.data_ptr() | win.data_ptr()) % 16 == 0, x.dtype, gy.dtype, index, gy.get_device())
    out = x.new_empty(out_shape)  # dW [B, k], then the partial sums
    # The raw handle of the current stream: torch.cuda.current_stream builds
    # a Python stream object on every call.
    args = (a.data_ptr(), win.data_ptr(), geom, plan, out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(index))
    if index == torch.cuda.current_device():
        err = _library().ups_wgrad_launch(*args)
    else:
        with torch.cuda.device(index):
            err = _library().ups_wgrad_launch(*args)
    if err != 0:
        raise RuntimeError(f"ups_wgrad kernel launch failed with CUDA error {err}")
    launch_count += 1
    return out[0]


def _strides(shape, stride) -> Tuple[int, ...]:
    """Strides with those of size-1 dimensions, which address nothing, as 0."""
    return tuple(s if n > 1 else 0 for n, s in zip(shape, stride))


@lru_cache(maxsize=512)
def _launch_args(transposed, axis, k, a_shape, a_stride, w_shape, w_stride, ptrs_aligned,
                 x_dtype, gy_dtype, x_index, gy_index):
    """For tensors of these shapes, strides and dtypes on these devices
    (indices, -1 on the host), with both pointers 16-byte aligned or not:
    the launch's ctypes arrays (the geometry of A and of the window tensor,
    and the plan: ``csrc/ups_wgrad.cu::ups_wgrad_launch``) and the shape of
    its output. Raises on what the kernel does not take."""
    if x_dtype != torch.float32 or gy_dtype != torch.float32:
        raise TypeError(f"the upsampling weight-gradient kernel takes float32, found "
                        f"{x_dtype} and {gy_dtype}")
    if x_index < 0 or gy_index != x_index:
        raise ValueError(f"x and its output gradient must be on one CUDA device, found "
                         f"device indices {x_index} and {gy_index}")
    if len(a_shape) != 4 or len(w_shape) != 4 or a_shape[:2] != w_shape[:2]:
        raise ValueError(f"expected [C, B, H, W] tensors, found {tuple(a_shape)} and "
                         f"{tuple(w_shape)}")
    n_c, n_b, h, w = a_shape
    if not 1 <= n_b <= MAX_IMAGES:
        raise ValueError(f"the kernel takes 1 to {MAX_IMAGES} images, found {n_b}")
    a_stride, w_stride = _strides(a_shape, a_stride), _strides(w_shape, w_stride)
    aligned = axis == 2 and w % 4 == 0 and ptrs_aligned and all(
        s % 4 == 0 for s in a_stride[:3] + w_stride[:3])
    if axis == 2:
        split = rows_plan(n_c, n_b, h, w, k, 4 if aligned else 1, _sm_count(x_index))
    else:
        split = cols_plan(n_c, n_b, h, w, k, _sm_count(x_index))
    plan = (axis, 2 if transposed else 1, k, 0 if transposed else -(k // 2), n_c, n_b, *split)
    geom = (*a_stride[:3], *a_shape[2:], *w_stride[:3], *w_shape[2:])
    return (ctypes.c_longlong * 10)(*geom), (ctypes.c_int * 12)(*plan), (1 + split[5], n_b, k)


def weight_grad(x: torch.Tensor, gy: torch.Tensor, k: int, transposed: bool,
                axis: int) -> torch.Tensor:
    """dW [B, k]: the plain version on the CPU, the kernel on CUDA."""
    if x.device.type == "cpu":
        return weight_grad_plain(x, gy, k, transposed, axis)
    if x.device.type == "cuda":
        return weight_grad_cuda(x, gy, k, transposed, axis)
    raise ValueError(f"the upsampling filters run on cpu or cuda tensors, found {x.device}")


def _library_call(x, w, transposed, stride, padding):
    if transposed:
        return F.conv_transpose2d(x, w, stride=stride, groups=x.shape[1])
    return F.conv2d(x, w, padding=padding, groups=x.shape[1])


class _Filter1d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, transposed, axis):
        stride, padding = conv_args(transposed, axis, w.shape[axis])
        ctx.save_for_backward(x, w)
        ctx.conv = (transposed, axis, stride, padding)
        return _library_call(x, w, transposed, stride, padding)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        transposed, axis, stride, padding = ctx.conv
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.ops.aten.convolution_backward.default(
                gy, x, w, None, stride, padding, (1, 1), transposed, (0, 0), x.shape[1],
                (True, False, False),
            )[0]
        if ctx.needs_input_grad[1]:
            gw = weight_grad(x, gy, w.shape[axis], transposed, axis).reshape(w.shape)
        return gx, gw, None, None


def filter_1d(x: torch.Tensor, w: torch.Tensor, transposed: bool, axis: int) -> torch.Tensor:
    """One per-image 1-D filter of [C, B, H, W] ``x`` with ``w`` ([B, 1, k, 1]
    along H, axis 2, or [B, 1, 1, k] along W, axis 3): the stride-2
    transposed convolution, or the convolution zero-padded by k // 2, with
    the images as groups."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Filter1d.apply(x, w, transposed, axis)
    stride, padding = conv_args(transposed, axis, w.shape[axis])
    return _library_call(x, w, transposed, stride, padding)
