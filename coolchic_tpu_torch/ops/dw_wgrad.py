"""The latent encoder's depthwise 7x7 convolution, with a hand-written weight
and bias gradient.

``hypernet/blocks.py::ConvNeXtBlock.Conv_0`` is a depthwise 7x7
convolution, stride 1, zero-padded by 3 on each side (flax's "SAME"), with
a bias; it is the only one the port runs, and the only size taken here. ``depthwise_conv`` is that call. Its forward is the library's
call as it was, and so is the input gradient (``aten.convolution_backward``
with the output mask ``(True, False, False)``); only the weight and bias
gradients are new.

On a CPU tensor they are the plain version, ``weight_grad_plain``. On a CUDA
tensor they are the kernel ``csrc/dw_wgrad.cu`` (one entry call, two
launches: per-block partial sums of the 49 taps and the bias, then their sum
per channel in a fixed order), launched or raising: there is no fallback to
the library. The kernel reads x and the output gradient channels-last,
which is how autograd hands both over in the latent encoder (through the
layer norm's permute); the Function copies a tensor that comes otherwise. The kernel replaces no TPU kernel; it was added because cuDNN's
grouped direct weight gradient took 84 ms of a 165 ms hypernet training step
on an H100 for the 21 layers of the latent encoder (7 levels x 3 blocks, 64
channels, 256x256 down to 4x4 at B = 8), against ~0.32 ms for the ~1.07 GB
that they read at 3.35 TB/s. The split of each channel's B x H x W over
thread blocks follows the shape and the card's SM count (``plan``); the
kernel's note says the rest.

A gradient is computed only where ``ctx.needs_input_grad`` asks for it, and
without autograd (no grad mode, or no input requiring a gradient)
``depthwise_conv`` is the library's call alone.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import torch
import torch.nn.functional as F

from coolchic_tpu_torch.ops.build import cdiv, launch_on, load_library, sm_count

# Entry calls of the kernel in this process (one per weight gradient on a
# CUDA tensor); callers that count a run set it to 0 first.
launch_count = 0

THREADS = 256  # kThreads of csrc/dw_wgrad.cu
CHANNELS = 8  # kChannels of csrc/dw_wgrad.cu: channels of a block
VEC = 4  # kVec of csrc/dw_wgrad.cu: columns of a thread
TAPS = 7  # kK of csrc/dw_wgrad.cu: the only kernel size
SUMS = TAPS * TAPS + 1  # sums of a channel: the taps, then the bias
# The split aims at this many threads per SM: one wave of the kernel's two
# resident blocks of 256 threads (128 registers a thread). On an H100, two
# or four waves cut the middle levels' strips shorter and cost 2-25 % more
# a step.
THREADS_PER_SM = 512
_LIB = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib, _ = load_library("dw_wgrad")
        p = ctypes.c_void_p
        lib.dw_wgrad_launch.argtypes = [p, p, p, p, p]
        lib.dw_wgrad_launch.restype = ctypes.c_int
        sizes = (lib.dw_wgrad_threads, lib.dw_wgrad_channels, lib.dw_wgrad_vec, lib.dw_wgrad_taps)
        for fn in sizes:
            fn.argtypes, fn.restype = [], ctypes.c_int
        if tuple(fn() for fn in sizes) != (THREADS, CHANNELS, VEC, TAPS):
            raise RuntimeError("csrc/dw_wgrad.cu and ops/dw_wgrad.py disagree on their sizes")
        _LIB = lib
    return _LIB


def plan(n_b: int, n_c: int, h: int, w: int, n_sm: int) -> Tuple[int, int, int, int]:
    """(strip rows, strips, column groups, blocks per group of ``CHANNELS``
    channels). A thread owns ``VEC`` columns of one plane and walks a strip
    of its rows; strips are cut so that the card holds about
    ``THREADS_PER_SM`` threads an SM. A strip also reads 3 rows of x above
    and below it, so the finest levels get long strips, and the smallest,
    where a block per channel group is already more than their items fill,
    one row each."""
    n_seg = cdiv(w, VEC)
    n_threads = n_b * cdiv(n_c, CHANNELS) * CHANNELS * n_seg  # at one strip
    strip = cdiv(h, min(h, cdiv(n_sm * THREADS_PER_SM, n_threads)))
    n_strips = cdiv(h, strip)
    return strip, n_strips, n_seg, cdiv(n_b * n_strips * n_seg, THREADS // CHANNELS)


def weight_grad_plain(x: torch.Tensor, gy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dW [C, 1, 7, 7], db [C]) of ``depthwise_conv(x, w, b)`` given its
    output gradient ``gy``: for each tap, the sum over b and the plane of
    ``gy`` times ``x`` zero-padded by 3 and shifted by the tap; the bias
    gradient is the sum of ``gy``."""
    n_c, (h, w) = x.shape[1], x.shape[2:]
    r = TAPS // 2
    xp = F.pad(x, (r, r, r, r))
    taps = [(gy * xp[:, :, ky : ky + h, kx : kx + w]).sum((0, 2, 3))
            for ky in range(TAPS) for kx in range(TAPS)]
    return torch.stack(taps, dim=1).reshape(n_c, 1, TAPS, TAPS), gy.sum((0, 2, 3))


def weight_grad_cuda(x: torch.Tensor, gy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's (dW [C, 1, 7, 7], db [C]) (f32) on channels-last CUDA
    tensors; raises on what it does not take (another dtype or layout,
    devices or shapes that differ) and on a refused launch. The
    checks, the plan and the launch's arguments are worked out once per
    shape, dtypes and devices (``_launch_args``)."""
    global launch_count
    if not all(t.is_contiguous(memory_format=torch.channels_last) for t in (x, gy)):
        raise ValueError("the depthwise weight-gradient kernel takes channels-last tensors")
    index = x.get_device()
    plan_args, n_c = _launch_args(tuple(x.shape), tuple(gy.shape), x.dtype, gy.dtype, index,
                                  gy.get_device())
    out = x.new_empty(n_c * SUMS * (1 + plan_args[7]))  # dW, db, then the partial sums
    launch_on(index, _library().dw_wgrad_launch, x.data_ptr(), gy.data_ptr(), plan_args,
              out.data_ptr())
    launch_count += 1
    n_taps = n_c * TAPS * TAPS
    return out[:n_taps].view(n_c, 1, TAPS, TAPS), out[n_taps : n_taps + n_c]


@lru_cache(maxsize=128)
def _launch_args(x_shape, gy_shape, x_dtype, gy_dtype, x_index, gy_index):
    """For channels-last tensors of these shapes and dtypes on these devices
    (indices, -1 on the host): the launch's plan as a ctypes array
    (``csrc/dw_wgrad.cu::dw_wgrad_launch``) and the channel count. Raises on
    what the kernel does not take."""
    if x_dtype != torch.float32 or gy_dtype != torch.float32:
        raise TypeError(f"the depthwise weight-gradient kernel takes float32, found {x_dtype} "
                        f"and {gy_dtype}")
    if x_index < 0 or gy_index != x_index:
        raise ValueError(f"x and its output gradient must be on one CUDA device, found device "
                         f"indices {x_index} and {gy_index}")
    if len(x_shape) != 4 or x_shape != gy_shape or 0 in x_shape:
        raise ValueError(f"expected two [B, C, H, W] tensors of one shape, found {x_shape} and "
                         f"{gy_shape}")
    n_b, n_c, h, w = x_shape
    if cdiv(n_c, CHANNELS) > 65535 or w * n_c >= 2**31:
        raise ValueError(f"the kernel takes at most {65535 * CHANNELS} channels and rows of "
                         f"under 2^31 values, found {n_c} channels of width {w}")
    return (ctypes.c_int * 8)(n_b, n_c, h, w, *plan(n_b, n_c, h, w, sm_count(x_index))), n_c


def weight_grad(x: torch.Tensor, gy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dW [C, 1, 7, 7], db [C]): the plain version on the CPU, the kernel on
    CUDA."""
    if x.device.type == "cpu":
        return weight_grad_plain(x, gy)
    if x.device.type == "cuda":
        return weight_grad_cuda(x, gy)
    raise ValueError(f"the depthwise convolution runs on cpu or cuda tensors, found {x.device}")


class _DepthwiseConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return F.conv2d(x, w, b, padding=TAPS // 2, groups=x.shape[1])

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            r = TAPS // 2
            gx = torch.ops.aten.convolution_backward.default(
                gy, x, w, None, (1, 1), (r, r), (1, 1), False, (0, 0), x.shape[1],
                (True, False, False),
            )[0]
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            # No copy where the tensors come channels-last, as in the latent encoder.
            gw, gb = weight_grad(x.contiguous(memory_format=torch.channels_last),
                                 gy.contiguous(memory_format=torch.channels_last))
        return gx, gw, gb


def depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The depthwise convolution of [B, C, H, W] ``x`` with ``w`` [C, 1, 7, 7],
    stride 1, zero-padded by 3, plus ``b`` [C]. Raises on another weight
    shape."""
    n_c = x.shape[1]
    if tuple(w.shape) != (n_c, 1, TAPS, TAPS):
        raise ValueError(f"expected a depthwise [{n_c}, 1, {TAPS}, {TAPS}] weight, found "
                         f"{tuple(w.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or b.requires_grad):
        return _DepthwiseConv.apply(x, w, b)
    return F.conv2d(x, w, b, padding=TAPS // 2, groups=n_c)
