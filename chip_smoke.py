#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one GPU: build, kernel checks,
one full-width image encode through the port's entry point to a ``.cool``
bitstream, that stream decoded back, a batch of eight full-width images of
mixed sizes encoded at once, a 1080p video GOP (I, P, B) encoded to one
stream, the hypernet's one-shot encode of eight images, the hypernet's
training through its CLI, and the multi-GPU modules at world size 1 with
the encode tools.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. build: compile every kernel of ``coolchic_tpu_torch/csrc`` with nvcc
     and the C++ entropy / decoder library of ``cpp/`` with g++ (one process
     per library, all started together).
  2. arm_rate kernel vs its plain PyTorch version (``models/arm.py``) for
     (dim_arm, n_hidden) in {(8,1), (16,2), (24,2), (32,2), (24,0), (24,3)}
     on planes 1x1, 5x3, 17x33 (ragged against the kernel's 16-latent
     m-tiles and 64-latent items), 16x24, 37x130 and 512x768; on planes of
     latents up to 3,000 in magnitude (past TF32's exact integers) for the
     ARMs of ``tests/torch_kernel_checks.py::LARGE_ARMS`` (n_hidden 0..3), each on
     every seed of ``LARGE_SEEDS``; then on the 7-grid pyramid of a 512x768
     image (the main path's shapes). Each case is held to two references with
     ``models.arm.rate_tolerance`` (rtol = atol = 1e-4, with one more term
     only for steep latents, Laplace scale under 1/8, and tail latents, over
     12 bits, where f32 cannot resolve 1e-4), and reports the latents beyond
     1e-4 by kind, ``neither`` being 0:
       * the plain version in float64 (latents and weights cast);
       * the plain version in f32 as the port runs it (cuBLAS matmuls),
         except on the large-latent inputs where that version itself misses
         float64: the line of each large-latent ARM lists the seeds held to
         both references and those held to float64 alone.
     The f32 plain version's own error against float64 is printed beside
     the kernel's. The pyramid line times the kernel on prepared buffers
     (``ms``: launches captured in a CUDA graph and replayed, device time
     only), through the wrapper (``wrapper_ms``: CUDA events around
     back-to-back calls; ``wrapper_host_ms``: the host's time per call) and
     the plain version, beside three bounds: 3xTF32 at the TF32 peak
     (``bound_ms``, a floor: 3xTF32 itself misses f32 accuracy on large
     latents), f64 on the tensor cores (``bound_f64_ms``, the route taken)
     and f32 FMA on the CUDA cores (``bound_simt_ms``, the SIMT design's).
     Then the kernel on a batch (``arm_rate_batch`` lines): B in {1, 2, 5, 8,
     16, 40} images, every batch size the two paths below launch (their
     warm-ups train 5, then 2 candidates per image), each image with its own
     ARM weights and latents (seeded), at the main path's pyramid and at the
     ragged pyramid of a 37x130 image; and B in {1, 2, 5} at the ragged
     pyramid of a 1920x1080 frame (1080x1920 down to 17x30; 2,764,710
     latents), every batch size the video path launches; and B in {1, 8} at
     the 256x256 pyramid, every batch size the hypernet training path
     launches. Each row is held
     to the float64 and f32 plain versions as above, row by row, and the
     batch's one launch must equal, bit for bit, B single-image launches on
     the same rows. Timed by CUDA-graph replay, beside B times the f64
     bound. Every path then fails if it launched the kernel on a batch size
     not checked here at its shapes (the smoke's wrapper of
     ``ops.arm_rate.launch_arm_rate`` tallies the launches by batch size).
     Then the upsampling filters' weight-gradient kernel
     (``ops/ups_filter.py``): the 24 weight gradients of one backward of the
     default decoder's upsampling cascade, each as the kernel receives it,
     at every (image size, batch) a path below trains the upsampling at
     (512x768 at each of BATCH_SIZES, 256x256 at 1, 2 and 8, 1080x1920 at
     each of VIDEO_BATCH_SIZES): within 1e-5 of the plain version in
     float64 (relative to each tap's sum of |terms|) and equal bit for bit on
     a second run. Four of them (``ups_wgrad`` lines: 512x768 at B = 8, the
     batched encode, and B = 1, the main path; 256x256 at B = 8, the
     hypernet trainer; 1080x1920 at B = 1, a video frame) are timed by
     CUDA-graph replay beside the byte bound (x and the output gradient read
     once at 3.35 TB/s), with the host's time of a call, the plain version
     in f32 and, as a yardstick only, the library call it replaces
     (``aten.convolution_backward`` with the output mask (False, True,
     False)); per level (4 calls) and per step (24). Every path then fails
     unless it launched the kernel 4 times per x2 level for each training
     step that trains the upsampling and at no other time (eval forwards,
     latent-only phases), and only at launch geometries checked here (the
     smoke's wrapper of ``ops.ups_filter.weight_grad_cuda`` tallies the
     launches by the geometry and plan arrays they were given).
  3. main path: encode a synthetic 512x768 RGB image (numpy seed 0) with the
     default DecoderConfig (arm 24,2; 40-wide synthesis; 7 grids) and the
     c3x recipe of preset_cfg/c3x.yaml, iteration counts cut (printed),
     through ``coolchic_tpu_torch.encode.encode_one_run``: warm-up 5 -> 2
     candidates, three phases, the full NN-quantization search, then the
     bitstream written to ``smoke_out/synthetic_512x768.cool`` and decoded
     by the integer pipeline for the row's ``psnr_db``. Checks that
     every eval forward launched the kernel, that loss / PSNR / rate are
     finite, that the PSNR estimate beats the flat-mean image, and that the
     final params give the same eval loss on the card (kernel) as on the CPU
     (plain ARM). The warm-up trains its candidates as one batch (5, then
     2), so an eval forward of the warm-up is one launch for all of them.
  4. bitstream: on that stream. The writer run again gives the same bytes
     (timed: ``write_s``, of which ``armint_s`` in the host integer ARM and
     ``entropy_s`` in the C++ coder). The integer decode through the one-call
     C route and through the python-orchestrated route give the same image;
     the decoded latents equal ``round(latent * encoder_gain)`` of the final
     params exactly and the decoded networks equal the quantized params
     (atol 1e-12). |decoded PSNR - estimated PSNR| < 0.1 dB and the real
     latent bpp within 20 % of the rate the ARM kernel estimated (the limits
     of ``utils/sanity_check.py``). The float decode on the card against the
     float decode on the CPU: max abs difference <= 1/255 and fewer than
     0.1 % of the samples differing; float against integer: PSNR within
     0.1 dB and max abs difference < 8/255. Times are host seconds, each
     stopped after a synchronise.
  5. batch path: ``train.encode.encode_frame_batch`` on 8 synthetic images
     (numpy seeds 0-7) in one 512x768 buffer, default DecoderConfig, the c3x
     recipe cut further (printed), lambda 1e-3 for the first four and 4e-3
     for the last four, image 3 of true size 480x720 and image 7 of 512x704
     through ``valid_hws``. Checks: one kernel launch per batched eval
     forward; loss / PSNR / rate finite; every PSNR estimate above its
     image's flat-mean PSNR; each row's final eval metrics on the card equal
     to the CPU's (plain ARM) at the main path's tolerance; each full-size
     row's stream (the writer, on that row's params and quantization infos)
     decodes through the integer pipeline within 0.1 dB of the estimate and
     20 % of the estimated latent rate; each smaller row's masked rate and
     loss equal (1e-5 relative) those of the same parameters cropped to the
     true size and run through the unbatched forward. Prints image-steps/s,
     the stage seconds and the peak memory.
  6. video path: a synthetic 3-frame 1920x1080 4:2:0 8-bit sequence (a
     smooth texture moving 3 px right and 2 px down per frame, plus noise;
     numpy seed 0) written to ``smoke_out/synthetic_1920x1080_420_8b.yuv``
     and encoded through ``encode_one_run`` with the default DecoderConfig,
     intra_period = p_period = 2 (I at display 0, P at 2, B at 1) and the
     c3x recipe cut further than the batch path's (printed), to one stream
     (``smoke_out/synthetic_1920x1080_420_8b.cool``). Checks: one kernel
     launch per batched eval forward, at batch sizes checked at 1080p; each
     frame's loss / PSNR / rate finite and its PSNR estimate above the
     flat-mean frame's; the stream's integer decode (one-call C route)
     equal, frame by frame and exactly, to the reconstructions the encoder
     used as references (drift-free); each frame's decoded PSNR within 0.1
     dB of its estimate and its real latent rate within 20 % of the
     kernel's estimate; each frame's final eval metrics on the card equal
     to the CPU's at the main path's tolerance, and for P / B the integer
     warp of one synthesis output giving equal levels on both. Prints per
     frame the stage seconds, train steps/s, ``write_s`` and bytes; the
     decode seconds and the peak memory.
  7. hypernet path: ``hypernet.DeltaWholeNet`` with a resnet18 backbone
     at the widths of the JAX package's ``HyperNetConfig`` (64 hidden
     channels, synthesis and ARM heads 1024 x 3, upsampling head 256 x 3,
     tanh), the default DecoderConfig at 512x768, the port's seeded init
     with the heads' output layers drawn from a seeded normal (std printed;
     untrained, so the checks are agreement checks) and the main path's
     trained decoder as the shared base decoder, on 8 synthetic images
     (numpy seeds 0-7). The one-shot eval forward of the 8 predicted
     decoders must launch the kernel once, at B = 8; rows 0-1 against the
     CPU (predictions relative 1e-3; the decoders on the card's predictions:
     rate by ``rate_tolerance``, decoded 1e-4). ``eval_dataset`` plain and
     with the delta-subset search (finite rows); ``hypernet_to_bitstream``
     on images 0 and 1 (delta search, model quantization, the stream written
     to ``smoke_out/hypernet_<i>.cool`` and decoded by the integer pipeline:
     PSNR within 0.1 dB of the eval forward on the stream's own params, the
     real latent rate within 20 % where the estimate is over 0.05 bpp);
     ``eval_image_delta_subsets_rated`` on image 0 (every option's rated
     loss printed); ``finetune_coolchic`` on image 0 with cut phases (the
     finetuned loss at most the one-shot loss). Every launch at a batch size
     the ``arm_rate_batch`` checks held at 512x768. Prints the prediction's
     device ms at B = 1 and 8, the one-shot forward's wall ms, the seconds of
     each stage and the peak memory.
  8. hypernet training path: the trainer's CLI (``hypernet_train.main``,
     ``--synthetic --device cuda``) at the JAX CLI's no-config default, full
     width: resnet18 ``DeltaWholeNet`` (21.8 M parameters), the default
     DecoderConfig at 256x256, batch 8, lambda 1e-3, lr 1e-4 with the cosine,
     softround + gaussian 0.3 / 0.25; the samples cut (``HT_SAMPLES``, from
     10,000): ``--mode no`` for 100 steps with two checkpoints, ``--mode
     delta --init_from`` it for 50 steps, ``--resume`` that run to 70 steps,
     ``--mode small`` for 5 steps, then ``iterations_to_match`` of the resumed
     delta net on one 256x256 image (200 iterations, a check every 50). First,
     one train step of the delta net at batch 2 (deterministic quantizer) on
     the card against the CPU (``hypernet_step_card_vs_cpu`` states the
     tolerance). Checks: the NO run's best state beats its init on the eval
     batch; the resumed run starts from the checkpoint it loads, with its
     ``samples_seen``, and validates on the global sample clock; every
     validation (one ``evaluate_wholenet``, one launch at B = 8) and every
     eval of ``iterations_to_match`` (B = 1) launched the kernel; metrics
     finite. Prints per run steps/s and samples/s (wall, synchronised), the
     eval metrics before and after, every checkpoint write's seconds,
     ``evaluate_wholenet`` ms at B = 8 and the peak memory.
  9. multi-GPU and tools path (``parallel/`` at world size 1, the tools):
     ``parallel.launch(encode_batch_sharded, 1, "cuda", ...)`` on 4 of the
     batch path's images (the default DecoderConfig, full width; the c3x
     recipe cut to warm-up 10 per phase, phases 20 / 10 / 10;
     ``with_quant_info``), one rank on NCCL, held to ``encode_frame_batch``
     on the same images and seeds in this process, both with cuDNN's
     deterministic algorithms: per image PSNR within 0.1 dB, latent rate
     within 5 % and loss within 2 %. The same work on the same card, but the
     synthesis' replicate padding sums its backward with atomics, and the
     encode's Adam steps carry that far: up to 0.022 dB, 0.52 % and 0.44 %
     apart in two runs with phases 40 / 10 / 10 on an H100 80GB HBM3
     (700 W). A precision mismatch reads beyond the tolerance: a rank on
     cuDNN's TF32 default against this process's f32 read 0.15 dB, 7.1 % and
     4.9 % (ranks now take the caller's switches). The launcher's startup
     (spawn, imports, the group's init) and the first NCCL barrier's are
     printed on their own lines. ``hypernet_train --mode no --data_parallel
     1`` against ``--data_parallel 0`` (the no-config default widths,
     256x256, batch 8, 8 steps): the final checkpoints' eval losses within
     1e-4 relative (the one-device semantics: the loss summed in shares, the
     gradients through an all-reduce), samples/s of both.
     ``encode_simpler.encode`` with ``--budget debug`` on the main path's
     512x768 image (a ``.ppm``: the machine has no PIL): decoded PSNR within
     0.1 dB of the estimate, real latent rate within 20 % where the estimate
     is over 0.05 bpp. ``retrain_latents`` with ``--init zeros`` for 50
     iterations on frame 0 of a copy of the video path's
     ``video_encoder.pkl`` (1080p 4:2:0): the loss falls.
     ``detailed_eval_metrics`` of the main path's trained decoder: its loss
     and total rate equal ``eval_metrics``' (relative 1e-6), the per-grid
     rates sum to the latent rate. Each rank runs under the smoke's launch
     tallies and returns them with its result (``tallied_launch``), so that
     the ranks' launches count in this process; every launch at a batch size
     held by the ``arm_rate_batch`` checks at its pyramid.
Then a ``kernels`` JSON line, the card's name and power limit, and the
final ``{"ok": true, "device": ...}`` line. Any failure raises (exit != 0).

TF32 is off for the whole run (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), so plain and kernel paths are f32.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "smoke_out"  # encode outputs of the main-path run (gitignored)

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit).
PEAK_TF32_FLOPS = 495e12  # tensor cores
PEAK_F64_TENSOR_FLOPS = 67e12  # tensor cores, f64 mma
PEAK_F32_FLOPS = 67e12  # CUDA cores, no tensor cores
PEAK_BYTES_PER_S = 3.35e12

ARM_CASES = [(8, 1), (16, 2), (24, 2), (32, 2), (24, 0), (24, 3)]
PLANES = [(1, 1), (5, 3), (17, 33), (16, 24), (37, 130), (512, 768)]
IMG_H, IMG_W = 512, 768

# Iteration cuts of the c3x recipe for the main-path run.
WARMUP_MAX_ITR = 60  # c3x: 400 per warm-up phase
PHASE_MAX_ITR = (600, 120, 60)  # c3x: 10600 (--n_itr), 1500, 1000

# The batch path: 8 images in one 512x768 buffer, two of them smaller.
# Batch sizes of the arm_rate_batch kernel checks: those of the main path (one
# image; 5, then 2 warm-up candidates) and of the batch path (8 images; 40,
# then 16 candidates). Each gives an image another share of the grid.
BATCH_SIZES = (1, 2, 3, 4, 5, 8, 16, 20, 40)  # 3, 4, 20: multi_gpu_and_tools_path
BATCH_LMBDAS = (1e-3,) * 4 + (4e-3,) * 4
BATCH_VALID_HW = {3: (480, 720), 7: (512, 704)}  # image index -> true (H, W)
BATCH_WARMUP_MAX_ITR = 30
BATCH_PHASE_MAX_ITR = (200, 40, 30)

# The video path: a 3-frame 1920x1080 4:2:0 GOP (I, P at display 2, B at
# display 1), one frame after another; each frame's warm-up trains 5, then 2
# candidates.
VIDEO_H, VIDEO_W = 1080, 1920
VIDEO_FRAMES = 3
VIDEO_INTRA_PERIOD = VIDEO_P_PERIOD = 2
VIDEO_BATCH_SIZES = (1, 2, 5)
VIDEO_LMBDA = 1e-3
VIDEO_WARMUP_MAX_ITR = 20
VIDEO_PHASE_MAX_ITR = (120, 24, 16)
VIDEO_SHIFT = (3, 2)  # pixels the texture moves per frame (x, y)

# The hypernet path: DeltaWholeNet (resnet18, the HyperNetConfig widths) on
# 8 images of the batch path's size, seeds 0-7; streams for images 0 and 1.
HN_IMAGES = 8
HN_LMBDA = 1e-3
HN_HEAD_STD = 1e-3  # std of the seeded draw of the three heads' output layers
HN_STREAM_IMAGES = (0, 1)
HN_CPU_IMAGES = 2  # rows of the one-shot forward held to the CPU
HN_FINETUNE_ITR = 200  # default_finetune_phases(200): 200 + 20 iterations (1000 + 100)

# The hypernet training path: the JAX CLI's no-config default (resnet18 at
# the HyperNetConfig widths, DecoderConfig() at 256x256, batch 8, lambda 1e-3,
# lr 1e-4 with the cosine, softround + gaussian 0.3 / 0.25); only the number
# of samples is cut (10,000 -> the ones below).
HT_PATCH = 256
HT_BATCH = 8
HT_BATCH_SIZES = (1, 8)  # iterations_to_match's phases, the validations
HT_SAMPLES = {"no": 800, "delta": 400, "resume": 560, "small": 40}
HT_CKPT_FREQ = {"no": 320, "delta": 160, "resume": 80}  # samples between checkpoints
HT_CPU_BATCH = 2  # the one-step check of the card against the CPU
HT_CPU_LR = 1e-4
HT_MATCH = (200, 50)  # iterations_to_match's max_itr, check_every

# The multi-GPU and tools path: the sharded encode of 4 batch-path images
# (512x768, seeds 0-3, the default DecoderConfig) at world size 1 on NCCL;
# hypernet_train --data_parallel 1 against 0 (NO, 256x256, batch 8);
# encode_simpler --budget debug; retrain_latents on the video path's frame 0.
MG_LMBDAS = (1e-3, 1e-3, 4e-3, 4e-3)
MG_WARMUP_MAX_ITR = 10
MG_PHASE_MAX_ITR = (20, 10, 10)
MG_HT_SAMPLES = 64  # 8 steps of 8
MG_RETRAIN_ITR = 50


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, n_warmup: int = 3, n_iter: int = 20, per_sample: int = 10) -> float:
    """Device time of one call (CUDA events): the median over ``n_iter``
    samples of ``per_sample`` back-to-back calls, divided by ``per_sample``,
    so that the host's launch overhead overlaps the device work."""
    import torch

    for _ in range(n_warmup):
        fn()
    times = []
    for _ in range(n_iter):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_sample):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_sample)
    return statistics.median(times)


def kernel_ms(latents, params, dim_arm, n_hidden, n_images=None, per_graph: int = 20) -> float:
    """Device time of the kernel alone: ``per_graph`` launches on buffers and
    tables prepared once, captured in a CUDA graph and replayed, so that the
    host's time per launch (which exceeds a small kernel's) is not timed.
    With ``n_images``, latents and params have that leading axis and a
    launch covers the batch."""
    import torch

    from coolchic_tpu_torch.ops import arm_rate as ar

    layers = ar.layer_table(params, dim_arm, n_hidden, latents[0].device, n_images)
    table = ar.plane_table(tuple(tuple(y.shape[-3:]) for y in latents))
    rate = torch.empty(((n_images,) if n_images else ()) + (table.n_latents,),
                       device=latents[0].device)
    args = (latents, rate, layers, table, dim_arm, n_hidden, n_images or 1)
    ar.launch_arm_rate(*args)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            ar.launch_arm_rate(*args)
    return time_ms(graph.replay, per_sample=1) / per_graph


def host_ms(fn, n: int = 200) -> float:
    """Host time of one call (enqueue only, no synchronisation), the median
    of ``n`` calls after a synchronised warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e3 * statistics.median(times)


# The smoke's own tallies of the two kernels' launches, kept by the wrappers
# that install_launch_tallies() puts around the port's launch functions, in
# this process and in each rank the smoke starts (tallied_launch): the ARM
# kernel's launches by batch size, and the upsampling weight-gradient
# kernel's launches by the arguments it received (keyed_weight_grad). Each
# count is the wrapped module's launch_count, read before and after the call.
TALLY = {"arm_by_batch": Counter(), "ups_by_geometry": Counter()}


def keyed_weight_grad(weight_grad_cuda, x, gy, k, transposed, axis):
    """``weight_grad_cuda(x, gy, k, transposed, axis)`` and its launch key:
    the geometry and plan arrays that ``ops.ups_filter._launch_args`` gave
    that launch (read by wrapping that name for the call), which is what the
    kernel receives besides its pointers. The key by which a path's launch
    is matched to a checked one."""
    from coolchic_tpu_torch.ops import ups_filter

    launch_args, keys = ups_filter._launch_args, []

    def recorded(*args):
        geom, plan, out_shape = launch_args(*args)
        keys.append((tuple(geom), tuple(plan)))
        return geom, plan, out_shape

    ups_filter._launch_args = recorded
    try:
        out = weight_grad_cuda(x, gy, k, transposed, axis)
    finally:
        ups_filter._launch_args = launch_args
    return out, keys[-1]


def install_launch_tallies() -> None:
    """Wrap ``ops.arm_rate.launch_arm_rate`` and
    ``ops.ups_filter.weight_grad_cuda`` so that the launches each call makes
    (its module's ``launch_count`` after, less before) add to ``TALLY``. Both
    are looked up in their modules at each call."""
    from coolchic_tpu_torch.ops import arm_rate as ar
    from coolchic_tpu_torch.ops import ups_filter

    launch_arm_rate, weight_grad_cuda = ar.launch_arm_rate, ups_filter.weight_grad_cuda

    def tallied_arm_rate(latents, rate, layers, table, dim_arm, n_hidden, n_images=1):
        before = ar.launch_count
        launch_arm_rate(latents, rate, layers, table, dim_arm, n_hidden, n_images)
        TALLY["arm_by_batch"][n_images] += ar.launch_count - before

    def tallied_weight_grad(x, gy, k, transposed, axis):
        before = ups_filter.launch_count
        out, key = keyed_weight_grad(weight_grad_cuda, x, gy, k, transposed, axis)
        TALLY["ups_by_geometry"][key] += ups_filter.launch_count - before
        return out

    ar.launch_arm_rate, ups_filter.weight_grad_cuda = tallied_arm_rate, tallied_weight_grad


def tallied_rank(fn, *args, mesh, **kwargs):
    """What a rank that ``tallied_launch`` starts runs: ``fn`` under the
    launch tallies; returns its result and every rank's tallies."""
    import torch.distributed as dist

    install_launch_tallies()
    out = fn(*args, mesh=mesh, **kwargs)
    tallies = [None] * mesh.world_size
    dist.all_gather_object(tallies, {k: dict(v) for k, v in TALLY.items()}, group=mesh.group)
    return out, tallies


def tallied_launch(fn, world_size, device, *args, **kwargs):
    """``parallel.launch(fn, ...)`` with each rank under the launch tallies
    (``tallied_rank``): adds the ranks' tallies to this process's and
    returns rank 0's result. A rank on this process's card gets the memory
    that this process's caching allocator holds unused (without, the
    trainer's rank ran out of the card's memory after the earlier paths)."""
    import gc

    import torch

    from coolchic_tpu_torch.parallel import mesh as parallel_mesh

    if torch.device(device).type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
    out, tallies = parallel_mesh.launch(tallied_rank, world_size, device, fn, *args, **kwargs)
    for tally in tallies:
        for key, counts in tally.items():
            TALLY[key].update(counts)
    return out


def arm_reset() -> None:
    TALLY["arm_by_batch"].clear()


def arm_launches() -> int:
    """The ARM kernel's launches since ``arm_reset()``."""
    return sum(TALLY["arm_by_batch"].values())


def check_batch_sizes_seen(path: str, checked=BATCH_SIZES) -> dict:
    """The kernel's launches of the path just driven, by batch size; raises
    if one of the sizes was not held to the plain version at that path's
    shapes by the ``arm_rate_batch`` checks (``checked``)."""
    seen = dict(sorted(TALLY["arm_by_batch"].items()))
    if not set(seen) <= set(checked):
        raise AssertionError(f"{path} launched the kernel on batches of {sorted(seen)} images; "
                             f"checked against the plain version: {checked}")
    return {str(b): n for b, n in seen.items()}


# Launch keys of the upsampling's weight-gradient kernel (keyed_weight_grad)
# that phase_ups_wgrad held to the plain version, and the launches that the
# training steps counted since the last ups_reset() make.
UPS_CHECKED = set()
UPS_WANT = {"launches": 0}
UPS_BY_PATH = {}  # what check_ups_launches found, by path


def count_ups_training_steps() -> None:
    """Wrap ``train/step.py::train_step`` (each step of ``run_phase_batch``)
    so that a step adds to ``UPS_WANT`` the kernel launches it makes: 4 per
    x2 level (the x2 passes along H and W, the pre-concat filter's two) when
    it trains the upsampling, else none."""
    from coolchic_tpu_torch.train import step

    real = step.train_step

    def counted(params, tensors, opt, targets, lmbdas, cfg, phase, *args):
        if {"all", "upsampling"} & set(phase.optimized_module):
            UPS_WANT["launches"] += 4 * (cfg.latent_n_grids - 1)
        return real(params, tensors, opt, targets, lmbdas, cfg, phase, *args)

    step.train_step = counted


def ups_reset() -> None:
    TALLY["ups_by_geometry"].clear()
    UPS_WANT["launches"] = 0


def check_ups_launches(path: str, more: int = 0, replayed: int = 0) -> dict:
    """The upsampling kernel's launches since ``ups_reset()``: those the
    tally counted on the host, plus ``replayed``, the launches that CUDA
    graphs' replays made beyond them (a graphed step reaches the wrapper once,
    at its capture, whose launches ran in the replay that followed). Raises
    unless they are those of the training steps counted since then, plus
    ``more`` (steps that ``count_ups_training_steps`` does not see: the
    hypernet trainer's, another process's), and unless ``phase_ups_wgrad``
    held each of their launch geometries to the plain version. Returns the
    launches and their count by batch size (of the wrapper's calls)."""
    by_geometry = TALLY["ups_by_geometry"]
    counted = sum(by_geometry.values())
    want = UPS_WANT["launches"] + more
    if counted + replayed != want:
        raise AssertionError(f"{path} launched ups_wgrad {counted} + {replayed} (replayed) "
                             f"times; its training steps make {want} launches")
    unchecked = set(by_geometry) - UPS_CHECKED
    if unchecked:
        raise AssertionError(f"{path} launched ups_wgrad at {len(unchecked)} geometries that no "
                             f"check held to the plain version, e.g. {sorted(map(str, unchecked))[0]}")
    by_batch = {}
    for (_, plan), n in by_geometry.items():
        b = plan[5]  # ups_filter._launch_args' plan: (axis, stride, k, pad, C, B, ...)
        by_batch[b] = by_batch.get(b, 0) + n
    UPS_BY_PATH[path] = {"launches": want,
                         "by_batch": {str(b): n for b, n in sorted(by_batch.items())}}
    return UPS_BY_PATH[path]


def phase_build() -> None:
    from coolchic_tpu_torch.bitstream.entropy import build_library
    from coolchic_tpu_torch.ops.build import CSRC_DIR, load_library
    from concurrent.futures import ThreadPoolExecutor

    def timed(fn, *args):
        t = time.perf_counter()
        return fn(*args), time.perf_counter() - t

    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + 1) as pool:
        cpp = pool.submit(timed, build_library)
        results = dict(zip(names, pool.map(lambda n: timed(load_library, n), names)))
        cpp_path, cpp_seconds = cpp.result()
    regs = {
        name: [line.strip() for line in log.splitlines() if "registers" in line]
        for name, ((_, log), _) in results.items()
    }
    emit({"phase": "build", "kernels": names, "seconds": time.perf_counter() - t0,
          "kernel_seconds": {name: sec for name, (_, sec) in results.items()},
          "cpp_library": str(Path(cpp_path).relative_to(REPO)), "cpp_library_seconds": cpp_seconds,
          "ptxas": regs})


def arm_case_params(dim_arm, n_hidden, gen):
    """Init rules, then a first weight of 0.2 N(0, 1) and further hidden
    weights of 0.05 N(0, 1), so that mu, the scale and every layer vary."""
    import torch

    from coolchic_tpu_torch.models.arm import init_arm_params

    params = init_arm_params(gen, dim_arm, n_hidden, "cuda")
    for i, layer in enumerate(params["layers"][:-1]):
        layer["weight"] = torch.randn(layer["weight"].shape, generator=gen,
                                      device="cuda") * (0.2 if i == 0 else 0.05)
    return params


def summary(res) -> dict:
    """The numbers of a ``torch_kernel_checks.check_rate`` result that a line reports."""
    return {
        "max_abs_err": res["vs_f32"]["max_abs_err"],
        "max_abs_err_f64": res["vs_f64"]["max_abs_err"],
        "plain_f32_max_abs_err_f64": res["plain_f32_max_abs_err_f64"],
        "n_beyond_1e-4_f64": res["vs_f64"]["n_beyond_1e-4"],
        "n_beyond_1e-4": res["vs_f32"]["n_beyond_1e-4"],
    }


def compare(got, latents, params, dim_arm) -> dict:
    """The kernel's rate against the float64 and the cuBLAS f32 plain rates;
    raises unless both are within rate_tolerance with no latent beyond 1e-4
    that is neither steep nor tail."""
    from torch_kernel_checks import check_rate, holds

    res = check_rate(got, latents, params, dim_arm)
    out = summary(res)
    if not (holds(res["vs_f64"]) and holds(res["vs_f32"])):
        raise AssertionError(f"arm_rate kernel disagrees with its plain version: {out}")
    return out


def large_latent_checks(dim_arm, n_hidden) -> dict:
    """The kernel on every seed of LARGE_SEEDS: held to float64 on each, and
    to cuBLAS f32 on each where cuBLAS is itself within tolerance of
    float64. Raises on a miss; returns the seeds by reference, the largest
    errors (against cuBLAS: over the seeds held to it) and the latents
    beyond 1e-4 of float64 over all seeds."""
    from coolchic_tpu_torch.ops import arm_rate as ar
    from coolchic_tpu_torch.params import from_numpy_pytree
    from torch_kernel_checks import (
        LARGE_PLANES, LARGE_SEEDS, check_rate, holds, large_latent_case,
    )

    both, f64_only, max_latent = [], [], 0.0
    err_f64 = err_cublas = plain_err = 0.0
    beyond_f64 = dict.fromkeys(("steep", "tail", "steep_and_tail", "neither"), 0)
    for seed in LARGE_SEEDS:
        params, latents = large_latent_case(dim_arm, n_hidden, seed)
        params, latents = from_numpy_pytree(params, "cuda"), from_numpy_pytree(latents, "cuda")
        max_latent = max([max_latent] + [y.abs().max().item() for y in latents])
        res = check_rate(ar.arm_rate_pyramid(latents, params, dim_arm, n_hidden), latents,
                         params, dim_arm)
        if not holds(res["vs_f64"]) or (res["f32_holds"] and not holds(res["vs_f32"])):
            raise AssertionError(f"arm_rate kernel disagrees on large latents, seed {seed}: "
                                 f"{summary(res)}")
        (both if res["f32_holds"] else f64_only).append(seed)
        err_f64 = max(err_f64, res["vs_f64"]["max_abs_err"])
        plain_err = max(plain_err, res["plain_f32_max_abs_err_f64"])
        if res["f32_holds"]:
            err_cublas = max(err_cublas, res["vs_f32"]["max_abs_err"])
        for kind, n in res["vs_f64"]["n_beyond_1e-4"].items():
            beyond_f64[kind] += n
    return {"hw": [list(hw) for hw in LARGE_PLANES], "max_abs_latent": max_latent,
            "seeds_vs_f64_and_cublas": both, "seeds_vs_f64_only": f64_only,
            "max_abs_err_f64": err_f64, "max_abs_err_cublas": err_cublas,
            "plain_f32_max_abs_err_f64": plain_err, "n_beyond_1e-4_f64": beyond_f64}


def arm_bounds_ms(n_latents: int, dim_arm: int, n_hidden: int) -> dict:
    """The least times the card could take for the ARM rate of ``n_latents``
    latents: the ARM's multiply-adds (the function's, not the padded head's)
    at f32 accuracy; the plane read once, the rate written once."""
    macs = n_latents * (n_hidden * dim_arm * dim_arm + 2 * dim_arm)
    n_weights = n_hidden * (dim_arm * dim_arm + dim_arm) + 2 * dim_arm + 2
    n_bytes = 4 * (2 * n_latents + n_weights)
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = 3 * 2 * macs / PEAK_TF32_FLOPS  # 3xTF32: three products per multiply-add
    t_f64 = 2 * macs / PEAK_F64_TENSOR_FLOPS  # the route taken: f64 mma
    # The SIMT design's figure: f32 FMA, adds and ReLUs on the CUDA cores.
    t_simt = n_latents * (2 * (n_hidden * dim_arm * dim_arm + 2 * dim_arm)
                          + 2 * n_hidden * dim_arm + 2) / PEAK_F32_FLOPS
    return {
        "macs": macs, "bytes": n_bytes,
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_f64_ms": 1e3 * max(t_f64, t_bytes),
        "bound_simt_ms": 1e3 * max(t_simt, t_bytes),
    }


def batch_kernel_checks(cfg, label: str, sizes=BATCH_SIZES) -> dict:
    """The kernel on batches of B in ``sizes`` images of ``cfg``'s pyramid,
    each image with its own ARM and latents: every row against its plain
    versions, the one launch against B single launches (bit for bit), and
    its time. Returns {B: ms}."""
    import torch

    from coolchic_tpu_torch.ops import arm_rate as ar
    from coolchic_tpu_torch.params import stack_params

    dim_arm, n_hidden = cfg.dim_arm, cfg.n_hidden_layers_arm
    one = arm_bounds_ms(cfg.n_latents, dim_arm, n_hidden)
    out = {}
    for n_images in sizes:
        gen = torch.Generator("cuda").manual_seed(4321 + n_images)
        rows = [arm_case_params(dim_arm, n_hidden, gen) for _ in range(n_images)]
        params = stack_params(rows)
        latents = [torch.round(torch.randn((n_images,) + s, generator=gen, device="cuda") * 3.0)
                   for s in cfg.latent_shapes]
        count = ar.launch_count
        got = ar.arm_rate_pyramid_batch(latents, params, dim_arm, n_hidden)
        if ar.launch_count != count + 1:
            raise AssertionError(f"a batch of {n_images} took {ar.launch_count - count} launches")
        singles = torch.stack([ar.arm_rate_pyramid([y[b] for y in latents], rows[b], dim_arm,
                                                   n_hidden) for b in range(n_images)])
        torch.cuda.synchronize()
        if not torch.equal(got, singles):
            raise AssertionError(f"the batched launch (B = {n_images}, {label}) differs from "
                                 f"{n_images} single launches")
        res = [compare(got[b], [y[b] for y in latents], rows[b], dim_arm)
               for b in range(n_images)]
        ms = kernel_ms(latents, params, dim_arm, n_hidden, n_images)
        out[n_images] = ms
        emit({"phase": "arm_rate_batch", "pyramid": label, "batch": n_images,
              "n_latents_per_image": cfg.n_latents, "dim_arm": dim_arm, "n_hidden": n_hidden,
              "equals_single_launches": True,
              "max_abs_err": max(r["max_abs_err"] for r in res),
              "max_abs_err_f64": max(r["max_abs_err_f64"] for r in res),
              "n_beyond_1e-4_neither": sum(r["n_beyond_1e-4"]["neither"]
                                           + r["n_beyond_1e-4_f64"]["neither"] for r in res),
              "ms": ms, "ms_per_image": ms / n_images,
              "bound_ms": n_images * one["bound_ms"], "bound_by": one["bound_by"],
              "bound_f64_ms": n_images * one["bound_f64_ms"],
              "share_of_bound_f64_ms": n_images * one["bound_f64_ms"] / ms})
    return out


def phase_kernel_checks() -> dict:
    """Kernel vs plain on single planes and on the main path's pyramid.
    Returns the pyramid numbers for the ``kernels`` line."""
    import torch

    from coolchic_tpu_torch.models.arm import arm_rate_plain
    from coolchic_tpu_torch.models.config import CoolChicConfig
    from coolchic_tpu_torch.ops import arm_rate as ar
    from torch_kernel_checks import LARGE_ARMS

    for dim_arm, n_hidden in ARM_CASES:
        gen = torch.Generator("cuda").manual_seed(10 * dim_arm + n_hidden)
        params = arm_case_params(dim_arm, n_hidden, gen)
        for hw in PLANES:
            lat = torch.round(torch.randn(hw, generator=gen, device="cuda") * 3.0)
            got = ar.arm_rate(lat, params, dim_arm, n_hidden).reshape(-1)
            line = {"phase": "arm_rate_plane", "dim_arm": dim_arm, "n_hidden": n_hidden,
                    "hw": list(hw), **compare(got, [lat[None]], params, dim_arm)}
            if hw == PLANES[-1]:
                line["ms"] = kernel_ms([lat[None]], params, dim_arm, n_hidden)
                line["plain_ms"] = time_ms(lambda: arm_rate_plain([lat[None]], params, dim_arm))
            emit(line)
    for dim_arm, n_hidden in LARGE_ARMS:
        emit({"phase": "arm_rate_large_latents", "dim_arm": dim_arm, "n_hidden": n_hidden,
              **large_latent_checks(dim_arm, n_hidden)})

    # The main path's shapes: 7 grids of a 512x768 image, flagship ARM.
    cfg = CoolChicConfig(img_size=(IMG_H, IMG_W))
    dim_arm, n_hidden = cfg.dim_arm, cfg.n_hidden_layers_arm
    gen = torch.Generator("cuda").manual_seed(1234)
    params = arm_case_params(dim_arm, n_hidden, gen)
    latents = [torch.round(torch.randn(s, generator=gen, device="cuda") * 3.0)
               for s in cfg.latent_shapes]
    got = ar.arm_rate_pyramid(latents, params, dim_arm, n_hidden)
    per_plane = torch.cat([ar.arm_rate(y[0], params, dim_arm, n_hidden).reshape(-1)
                           for y in latents])
    torch.cuda.synchronize()
    if not torch.equal(got, per_plane):
        raise AssertionError("pyramid launch and per-plane launches disagree on the order")
    res = compare(got, latents, params, dim_arm)
    ms = kernel_ms(latents, params, dim_arm, n_hidden)
    wrapper_ms = time_ms(lambda: ar.arm_rate_pyramid(latents, params, dim_arm, n_hidden))
    wrapper_host_ms = host_ms(lambda: ar.arm_rate_pyramid(latents, params, dim_arm, n_hidden))
    plain_ms = time_ms(lambda: arm_rate_plain(latents, params, dim_arm))

    bounds = arm_bounds_ms(cfg.n_latents, dim_arm, n_hidden)
    macs, n_bytes = bounds.pop("macs"), bounds.pop("bytes")
    out = {
        "max_abs_err": res["max_abs_err"], "ms": ms, "wrapper_ms": wrapper_ms,
        "wrapper_host_ms": wrapper_host_ms, "plain_ms": plain_ms, **bounds,
    }
    for k in ("bound_ms", "bound_f64_ms", "bound_simt_ms"):
        out["share_of_" + k] = out[k] / ms
    emit({"phase": "arm_rate_pyramid", "latent_shapes": [list(s) for s in cfg.latent_shapes],
          "n_latents": cfg.n_latents, "dim_arm": dim_arm, "n_hidden": n_hidden, "macs": macs,
          "bytes": n_bytes, **res, **out})

    batch_ms = batch_kernel_checks(cfg, f"{IMG_H}x{IMG_W}")
    batch_kernel_checks(CoolChicConfig(img_size=(37, 130)), "37x130")
    out["ms_batch8"] = batch_ms[8]
    out["bound_batch8_ms"] = 8 * out["bound_f64_ms"]
    out["ms_by_batch"] = {str(b): ms for b, ms in batch_ms.items()}

    # The hypernet training path's shapes: 256x256 patches.
    ht_ms = batch_kernel_checks(CoolChicConfig(img_size=(HT_PATCH, HT_PATCH)),
                                f"{HT_PATCH}x{HT_PATCH}", HT_BATCH_SIZES)
    out["ms_256x256_by_batch"] = {str(b): ms for b, ms in ht_ms.items()}

    # The video path's shapes: the ragged 7-grid pyramid of a 1080p frame.
    video_cfg = CoolChicConfig(img_size=(VIDEO_H, VIDEO_W))
    video_ms = batch_kernel_checks(video_cfg, f"{VIDEO_H}x{VIDEO_W}", VIDEO_BATCH_SIZES)
    one = arm_bounds_ms(video_cfg.n_latents, dim_arm, n_hidden)
    out["ms_1080p_by_batch"] = {str(b): ms for b, ms in video_ms.items()}
    out["n_latents_1080p"] = video_cfg.n_latents
    out["bound_1080p_ms"] = one["bound_ms"]
    out["bound_f64_1080p_ms"] = one["bound_f64_ms"]
    return out


def graph_ms(fn, per_graph: int = 20) -> float:
    """Device time of one call of ``fn``: ``per_graph`` calls captured in a
    CUDA graph and replayed, so that the host's time per call is not
    timed."""
    import torch

    fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return time_ms(graph.replay, per_sample=1) / per_graph


def phase_ups_wgrad() -> dict:
    """The upsampling filters' weight-gradient kernel at every (image size,
    batch) that a path below trains the upsampling at (see the module
    docstring); fills ``UPS_CHECKED``. Returns the per-step numbers of the
    timed shapes for the ``kernels`` line."""
    import torch

    from coolchic_tpu_torch.ops import ups_filter
    from torch_kernel_checks import cascade_weight_grads, weight_grad_error

    timed = {((IMG_H, IMG_W), 8), ((IMG_H, IMG_W), 1), ((HT_PATCH, HT_PATCH), HT_BATCH),
             ((VIDEO_H, VIDEO_W), 1)}
    checked = ([((IMG_H, IMG_W), b) for b in BATCH_SIZES]
               + [((HT_PATCH, HT_PATCH), b) for b in sorted({1, HT_CPU_BATCH, *HT_BATCH_SIZES})]
               + [((VIDEO_H, VIDEO_W), b) for b in VIDEO_BATCH_SIZES])
    out, max_err = {}, 0.0
    for img_size, n_images in checked:
        calls = cascade_weight_grads(img_size, n_images, "cuda")
        if len(calls) != 24:
            raise AssertionError(f"{len(calls)} weight gradients in one backward, not 24")
        for x, gy, k, transposed, axis in calls:
            got, key = keyed_weight_grad(ups_filter.weight_grad_cuda, x, gy, k, transposed, axis)
            err = weight_grad_error(got, x, gy, k, transposed, axis)
            if err > 1e-5 or not torch.equal(ups_filter.weight_grad_cuda(x, gy, k, transposed,
                                                                          axis), got):
                raise AssertionError(f"ups_wgrad kernel off its plain version ({err}) or not "
                                     f"repeatable at {tuple(x.shape)}, {tuple(gy.shape)}, k {k}")
            UPS_CHECKED.add(key)
            max_err = max(max_err, err)
        if (img_size, n_images) in timed:
            out[f"{img_size[0]}x{img_size[1]}_b{n_images}"] = ups_wgrad_times(
                img_size, n_images, calls)
        del calls
    emit({"phase": "ups_wgrad_checks", "shapes": [[list(s), b] for s, b in checked],
          "geometries": len(UPS_CHECKED), "max_err": max_err})
    return out


def ups_wgrad_times(img_size, n_images: int, calls) -> dict:
    """The ``ups_wgrad`` line of one cascade: per level (4 calls) and per step
    (24), the kernel's device ms (CUDA-graph replay) and host µs a call
    (enqueue only), its byte bound, the plain version's ms and the library
    call's it replaces."""
    import torch

    from coolchic_tpu_torch.ops import ups_filter
    from torch_kernel_checks import weight_grad_error

    # Level i (0: the coarsest x2 step) holds the i-th smallest call of each kind.
    kind_of = {id(c): ("x2_" if c[3] else "preconcat_") + "HW"[c[4] - 2] for c in calls}
    rank = {}
    for kind in set(kind_of.values()):
        same = sorted((c for c in calls if kind_of[id(c)] == kind), key=lambda c: c[0].numel())
        rank.update({id(c): i for i, c in enumerate(same)})
    levels = [{"level": i, "calls": []} for i in range(6)]
    for call in calls:
        x, gy, k, transposed, axis = call
        got = ups_filter.weight_grad_cuda(x, gy, k, transposed, axis)
        stride, padding = ups_filter.conv_args(transposed, axis, k)
        w = torch.zeros((n_images, 1, k, 1) if axis == 2 else (n_images, 1, 1, k), device="cuda")
        n_bytes = 4 * (x.numel() + gy.numel())
        line = {
            "kind": kind_of[id(call)], "x": list(x.shape), "gy": list(gy.shape), "k": k,
            "max_err": weight_grad_error(got, x, gy, k, transposed, axis), "bytes": n_bytes,
            "bound_ms": 1e3 * n_bytes / PEAK_BYTES_PER_S,
            "ms": graph_ms(lambda: ups_filter.weight_grad_cuda(x, gy, k, transposed, axis)),
            "host_us": 1e3 * host_ms(lambda: ups_filter.weight_grad_cuda(x, gy, k, transposed,
                                                                         axis)),
            "plain_ms": time_ms(lambda: ups_filter.weight_grad_plain(x, gy, k, transposed, axis)),
            "library_ms": graph_ms(lambda: torch.ops.aten.convolution_backward(
                gy, x, w, None, stride, padding, (1, 1), transposed, (0, 0), n_images,
                (False, True, False))),
        }
        levels[rank[id(call)]]["calls"].append(line)
    keys = ("ms", "bound_ms", "plain_ms", "library_ms", "host_us")
    for level in levels:
        level.update({key: sum(c[key] for c in level["calls"]) for key in keys})
    step = {key + "_per_step": sum(level[key] for level in levels) for key in keys}
    step["max_err"] = max(c["max_err"] for level in levels for c in level["calls"])
    step["share_of_bound"] = step["bound_ms_per_step"] / step["ms_per_step"]
    emit({"phase": "ups_wgrad", "img_size": list(img_size), "n_images": n_images, **step,
          "levels": levels})
    return step


def synthetic_image(h: int, w: int, seed: int = 0):
    """Smooth gradients plus texture, [3, H, W] in [0, 1], from a numpy seed
    (the noise, and for seeds past 0 a shift of the two textures)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((3, h, w)).astype(np.float32)
    shift = rng.uniform(0.0, 2.0 * np.pi, 2).astype(np.float32) if seed else np.zeros(2, np.float32)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([
        0.2 + 0.6 * x / w,
        0.3 + 0.4 * np.sin(2 * np.pi * y / h + shift[0]) * np.cos(2 * np.pi * x / (0.7 * w)),
        0.5 + 0.3 * np.sin(x / 9.0 + shift[1]) * np.sin(y / 13.0),
    ])
    return np.clip(img + 0.04 * noise, 0.0, 1.0).astype(np.float32)


def cut_recipe(warmup_max_itr: int, phase_max_itr):
    """The c3x recipe with its iteration counts cut, as an EncoderConfig,
    and what was cut."""
    from dataclasses import replace

    from coolchic_tpu_torch.train.presets import Warmup, load_preset
    from coolchic_tpu_torch.utils.types import EncoderConfig

    full = load_preset("c3x")
    enc = EncoderConfig(std_recipe_name="c3x", n_itr=phase_max_itr[0])  # --n_itr
    cut = enc.recipe
    enc.recipe = replace(
        cut,
        warmup=Warmup(tuple(
            replace(wp, training_phase=replace(wp.training_phase, max_itr=warmup_max_itr))
            for wp in cut.warmup.phases)),
        all_phases=cut.all_phases[:1] + tuple(
            replace(p, max_itr=n) for p, n in zip(cut.all_phases[1:], phase_max_itr[1:])),
    )
    reductions = {
        "warmup_max_itr": [wp.training_phase.max_itr for wp in full.warmup.phases],
        "warmup_max_itr_run": [wp.training_phase.max_itr for wp in enc.recipe.warmup.phases],
        "phase_max_itr": [p.max_itr for p in full.all_phases],
        "phase_max_itr_run": [p.max_itr for p in enc.recipe.all_phases],
    }
    return enc, reductions


def phase_main_path():
    """Encode through the entry point to a bitstream; returns the kernel
    launches it made, the run, its config, the image and the stream's path."""
    import numpy as np
    import torch

    from coolchic_tpu_torch.encode import encode_one_run
    from coolchic_tpu_torch.io.image import write_ppm
    from coolchic_tpu_torch.ops import arm_rate as ar
    from coolchic_tpu_torch.params import from_numpy_pytree, to_numpy_pytree
    from coolchic_tpu_torch.train.step import eval_metrics
    from coolchic_tpu_torch.utils.types import DecoderConfig, RunConfig

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    img = synthetic_image(IMG_H, IMG_W)
    path = OUT_DIR / "synthetic_512x768.ppm"
    write_ppm(img, 8, str(path))
    img = np.round(img * 255.0) / 255.0  # what the encoder reads back

    enc, reductions = cut_recipe(WARMUP_MAX_ITR, PHASE_MAX_ITR)
    dec = DecoderConfig()
    emit({"phase": "main_path_config", "img_size": [IMG_H, IMG_W], "dec_cfg": vars(dec),
          "candidates": [wp.candidates for wp in enc.recipe.warmup.phases], "reduced": reductions})

    cool = OUT_DIR / "synthetic_512x768.cool"
    cool.unlink(missing_ok=True)
    run_cfg = RunConfig(input=path, lmbda=1e-3, workdir=OUT_DIR, output=cool, enc_cfg=enc,
                        dec_cfg=dec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    arm_reset()
    ups_reset()
    run = encode_one_run(run_cfg, seed=0, device="cuda")
    launches = arm_launches()
    launches_by_batch = check_batch_sizes_seen("the main path")
    ups = check_ups_launches("the main path")
    stats = run.result.stats

    cfg = dec.to_coolchic_config((IMG_H, IMG_W))
    launches_per_forward = ar.plane_table(tuple(cfg.latent_shapes)).n_launches
    if launches != stats.n_batched_eval_forwards * launches_per_forward:
        raise AssertionError(f"{launches} kernel launches for {stats.n_batched_eval_forwards} "
                             "batched eval forwards")
    row = run.row
    for k in ("loss", "psnr_db_estimate", "rate_latent_bpp", "rate_nn_bpp", "rate_bpp", "psnr_db"):
        if not math.isfinite(row[k]):
            raise AssertionError(f"{k} is not finite: {row[k]}")
    flat_psnr = -10.0 * math.log10(float(np.mean((img - img.mean(axis=(1, 2), keepdims=True)) ** 2)))
    if not row["psnr_db_estimate"] > flat_psnr:
        raise AssertionError(f"PSNR {row['psnr_db_estimate']} <= flat-mean PSNR {flat_psnr}")
    params = run.result.params
    for latent, shape in zip(params["latents"], cfg.latent_shapes):
        if tuple(latent.shape) != shape or not torch.isfinite(latent).all():
            raise AssertionError(f"latent {tuple(latent.shape)} vs {shape} or not finite")

    # The final params on the card (ARM kernel) and on the CPU (plain ARM).
    target = torch.tensor(img, device="cuda")
    m_gpu = eval_metrics(params, cfg, target, 1e-3)
    m_cpu = eval_metrics(from_numpy_pytree(to_numpy_pytree(params), "cpu"), cfg, target.cpu(), 1e-3)
    cross = {k: (getattr(m_gpu, k).item(), getattr(m_cpu, k).item())
             for k in ("loss", "psnr_db", "rate_latent_bpp")}
    if abs(cross["rate_latent_bpp"][0] - cross["rate_latent_bpp"][1]) > 1e-4 * cross["rate_latent_bpp"][1]:
        raise AssertionError(f"card and CPU rates differ: {cross}")
    if abs(cross["psnr_db"][0] - cross["psnr_db"][1]) > 0.01:
        raise AssertionError(f"card and CPU PSNR differ: {cross}")

    train_s = sum(v for k, v in stats.stage_seconds.items() if not k.startswith("quantize"))
    emit({
        "phase": "main_path",
        "row": row,
        "flat_mean_psnr_db": flat_psnr,
        "stage_seconds": stats.stage_seconds,
        "n_train_steps": stats.n_train_steps,
        "train_steps_per_s": stats.n_train_steps / train_s,
        "n_eval_forwards": stats.n_eval_forwards,
        "n_batched_eval_forwards": stats.n_batched_eval_forwards,
        "n_batched_steps": stats.n_batched_steps,
        "arm_rate_launches": launches,
        "arm_rate_launches_by_batch": launches_by_batch,
        "launches_per_eval_forward": launches_per_forward,
        "ups_wgrad": ups,
        "nn_quant": {m: i._asdict() for m, i in run.infos.items()},
        "card_vs_cpu_eval": cross,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    })
    return launches, run, cfg, img, cool, stats.n_train_steps / train_s


def psnr_db(a, b) -> float:
    import numpy as np

    return float(-10.0 * np.log10(float(np.mean((a - b) ** 2)) + 1e-12))


def phase_bitstream(run, cfg, img, cool: Path) -> None:
    """The stream the main path wrote: written again (timed), decoded by the
    integer pipeline on both routes and by the float pipeline on the card and
    on the CPU. Raises on any miss."""
    import numpy as np
    import torch

    from coolchic_tpu_torch.bitstream import decode_bitstream, encode_image_bitstream
    from coolchic_tpu_torch.bitstream.decode import _ups_syn_float
    from coolchic_tpu_torch.params import to_numpy_pytree

    def clock() -> float:
        torch.cuda.synchronize()
        return time.perf_counter()

    data = cool.read_bytes()
    if data != run.bitstream:
        raise AssertionError("the file written by --output is not the run's bitstream")
    row, infos = run.row, run.infos
    if row["rate_bpp"] != 8 * len(data) / cfg.n_pixels:
        raise AssertionError(f"rate_bpp {row['rate_bpp']} is not the file's {len(data)} bytes")

    # The writer again, timed.
    q_step = {m: {"weight": float(i.q_step_w), "bias": float(i.q_step_b)} for m, i in infos.items()}
    expgol = {m: {"weight": int(i.expgol_w), "bias": int(i.expgol_b)} for m, i in infos.items()}
    parts = {}
    t0 = clock()
    again = encode_image_bitstream(run.result.params, cfg, q_step, expgol, timings=parts)
    write_s = clock() - t0
    if again != data:
        raise AssertionError("writing the same params twice gave different bytes")

    # Integer pipeline: the one-call C route, then the python-orchestrated one.
    t0 = clock()
    img_c, info_c = decode_bitstream(data, integer_pipeline=True)
    decode_int_s = clock() - t0
    if "timings" not in info_c:
        raise AssertionError("the integer decode did not take the one-call C route")
    t0 = clock()
    img_py, info = decode_bitstream(data, integer_pipeline=True, full_info=True)
    decode_int_python_s = clock() - t0
    if not np.array_equal(img_py.astype(np.float32), img_c):
        raise AssertionError("the C route and the python route decode different images")
    params = to_numpy_pytree(run.result.params)
    for got, lat in zip(info["latents"], params["latents"]):
        if not np.array_equal(got, np.round(lat.astype(np.float64) * cfg.encoder_gain)):
            raise AssertionError("decoded latents are not round(latent * encoder_gain)")
    net_err = 0.0
    for module in ("arm", "synthesis"):
        for got, want in zip(info["params"][module]["layers"], params[module]["layers"]):
            for k in ("weight", "bias"):
                net_err = max(net_err, float(np.abs(got[k] - want[k]).max()))
    for key in ("ups", "preconcat"):
        for got, want in zip(info["params"]["upsampling"][key], params["upsampling"][key]):
            net_err = max(net_err, float(np.abs(got - want).max()))
    if net_err > 1e-12:
        raise AssertionError(f"decoded networks differ from the quantized params by {net_err}")

    # Estimate against the real stream (the limits of utils/sanity_check.py).
    psnr_int = psnr_db(img_c, img)
    if abs(psnr_int - row["psnr_db"]) > 1e-9:
        raise AssertionError(f"row psnr_db {row['psnr_db']} vs decoded {psnr_int}")
    if abs(row["psnr_db"] - row["psnr_db_estimate"]) >= 0.1:
        raise AssertionError(f"decoded PSNR {row['psnr_db']} vs estimate {row['psnr_db_estimate']}")
    fh, gop = info["frame_header"], info["gop_header"]
    n_bytes = {
        "headers": gop.n_bytes_header + fh.n_bytes_header,
        "nn": sum(n for m in fh.n_bytes_nn.values() for n in m.values()),
        "latents": sum(fh.n_bytes_per_latent),
    }
    if sum(n_bytes.values()) != len(data):
        raise AssertionError(f"{n_bytes} does not add up to {len(data)} bytes")
    real_latent_bpp = 8 * n_bytes["latents"] / cfg.n_pixels
    est = row["rate_latent_bpp"]
    if est > 0.05 and abs(real_latent_bpp - est) / est >= 0.2:
        raise AssertionError(f"real latent rate {real_latent_bpp} bpp vs estimate {est}")

    # Float pipeline: on the card (once to warm up, then timed) and on the CPU.
    decode_bitstream(data, device="cuda")
    t0 = clock()
    img_card, _ = decode_bitstream(data, device="cuda")
    decode_float_card_s = clock() - t0
    t0 = clock()
    _ups_syn_float(info["params"], info["latents"], cfg, gop.bitdepth, torch.device("cuda"))
    ups_syn_float_card_s = clock() - t0
    t0 = clock()
    img_cpu, _ = decode_bitstream(data, device="cpu")
    decode_float_cpu_s = clock() - t0
    diff = np.abs(img_card.astype(np.float64) - img_cpu)
    card_vs_cpu = {"max_abs_diff_255": 255.0 * float(diff.max()),
                   "share_differing": float((diff > 0).mean())}
    if diff.max() > 1.0 / 255.0 + 1e-7 or card_vs_cpu["share_differing"] >= 1e-3:
        raise AssertionError(f"float decode on the card vs on the CPU: {card_vs_cpu}")
    psnr_float = psnr_db(img_card, img)
    float_vs_int_255 = 255.0 * float(np.abs(img_card - img_c).max())
    if abs(psnr_float - psnr_int) >= 0.1 or float_vs_int_255 >= 8.0:
        raise AssertionError(f"float decode {psnr_float} dB vs integer {psnr_int} dB, "
                             f"max diff {float_vs_int_255}/255")

    emit({
        "phase": "bitstream",
        "n_bytes": len(data), "n_bytes_split": n_bytes,
        "rate_bpp": row["rate_bpp"], "real_latent_bpp": real_latent_bpp,
        "rate_latent_bpp_estimate": est,
        "psnr_db": psnr_int, "psnr_db_estimate": row["psnr_db_estimate"],
        "psnr_db_float_card": psnr_float, "float_vs_int_max_abs_diff_255": float_vs_int_255,
        "float_card_vs_cpu": card_vs_cpu, "decoded_networks_max_abs_err": net_err,
        "write_s": write_s, "armint_s": parts["armint_s"], "entropy_s": parts["entropy_s"],
        "decode_int_s": decode_int_s, "decode_int_c_timings": info_c["timings"],
        "decode_int_python_s": decode_int_python_s,
        "decode_float_card_s": decode_float_card_s, "ups_syn_float_card_s": ups_syn_float_card_s,
        "decode_float_cpu_s": decode_float_cpu_s,
    })


def phase_batch_path(single_steps_per_s: float) -> int:
    """Encode 8 images of mixed sizes at once; returns the kernel launches
    the batched encode made. Raises on any miss."""
    import numpy as np
    import torch

    from coolchic_tpu_torch.bitstream import decode_bitstream, encode_image_bitstream
    from coolchic_tpu_torch.models.coolchic import frame_forward
    from coolchic_tpu_torch.ops import arm_rate as ar
    from coolchic_tpu_torch.params import from_numpy_pytree, to_numpy_pytree, unstack_params
    from coolchic_tpu_torch.train.encode import encode_frame_batch
    from coolchic_tpu_torch.train.loss import loss_function
    from coolchic_tpu_torch.train.step import eval_metrics
    from coolchic_tpu_torch.utils.types import DecoderConfig

    n_images = len(BATCH_LMBDAS)
    dec = DecoderConfig()
    cfg = dec.to_coolchic_config((IMG_H, IMG_W))
    enc, reductions = cut_recipe(BATCH_WARMUP_MAX_ITR, BATCH_PHASE_MAX_ITR)
    sizes = [BATCH_VALID_HW.get(b, (IMG_H, IMG_W)) for b in range(n_images)]
    images = [np.round(synthetic_image(h, w, seed=b) * 255.0) / 255.0
              for b, (h, w) in enumerate(sizes)]
    targets = np.zeros((n_images, 3, IMG_H, IMG_W), np.float32)
    for b, img in enumerate(images):
        targets[b, :, : img.shape[1], : img.shape[2]] = img
    emit({"phase": "batch_path_config", "batch": n_images, "buffer": [IMG_H, IMG_W],
          "valid_hw": [list(hw) for hw in sizes], "lmbdas": list(BATCH_LMBDAS),
          "dec_cfg": vars(dec), "candidates": [wp.candidates for wp in enc.recipe.warmup.phases],
          "reduced": reductions})

    targets = torch.tensor(targets, device="cuda")
    valid_hws = torch.tensor(sizes, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    arm_reset()
    ups_reset()
    result, infos = encode_frame_batch(
        targets, BATCH_LMBDAS, cfg, enc.recipe, seeds=list(range(n_images)),
        valid_hws=valid_hws, with_quant_info=True)
    launches = arm_launches()
    launches_by_batch = check_batch_sizes_seen("the batch path")
    check_ups_launches("the batch path")
    peak_bytes = torch.cuda.max_memory_allocated()
    stats = result.stats

    launches_per_forward = ar.plane_table(tuple(cfg.latent_shapes)).n_launches
    if launches != stats.n_batched_eval_forwards * launches_per_forward:
        raise AssertionError(f"{launches} kernel launches for {stats.n_batched_eval_forwards} "
                             "batched eval forwards")
    for name in ("loss", "psnr_db", "rate_latent_bpp"):
        values = getattr(result, name)
        if tuple(values.shape) != (n_images,) or not torch.isfinite(values).all():
            raise AssertionError(f"{name} is not {n_images} finite values: {values}")
    flat_psnr = [psnr_db(img, img.mean(axis=(1, 2), keepdims=True)) for img in images]
    for b in range(n_images):
        if not result.psnr_db[b].item() > flat_psnr[b]:
            raise AssertionError(f"image {b}: PSNR {result.psnr_db[b]} <= flat-mean {flat_psnr[b]}")

    rows = unstack_params(result.params)
    per_image = []
    for b, params in enumerate(rows):
        lmbda, full_size = BATCH_LMBDAS[b], b not in BATCH_VALID_HW
        nn_bits = sum(i.rate_bits for i in infos[b].values())
        line = {"image": b, "valid_hw": list(sizes[b]), "lmbda": lmbda,
                "loss": result.loss[b].item(), "psnr_db_estimate": result.psnr_db[b].item(),
                "rate_latent_bpp": result.rate_latent_bpp[b].item(),
                "flat_mean_psnr_db": flat_psnr[b]}

        # The row's final params on the card (ARM kernel) and on the CPU (plain ARM).
        m_gpu = eval_metrics(params, cfg, targets[b], lmbda, valid_hw=valid_hws[b])
        m_cpu = eval_metrics(from_numpy_pytree(to_numpy_pytree(params), "cpu"), cfg,
                             targets[b].cpu(), lmbda, valid_hw=valid_hws[b].cpu())
        cross = {k: (getattr(m_gpu, k).item(), getattr(m_cpu, k).item())
                 for k in ("loss", "psnr_db", "rate_latent_bpp")}
        bpp = cross["rate_latent_bpp"]
        if abs(bpp[0] - bpp[1]) > 1e-4 * bpp[1] or abs(cross["psnr_db"][0] - cross["psnr_db"][1]) > 0.01:
            raise AssertionError(f"image {b}: card and CPU differ: {cross}")
        line["card_vs_cpu_eval"] = cross

        if full_size:
            # The writer on this row, with this row's quantization choices.
            q_step = {m: {"weight": i.q_step_w, "bias": i.q_step_b} for m, i in infos[b].items()}
            expgol = {m: {"weight": i.expgol_w, "bias": i.expgol_b} for m, i in infos[b].items()}
            data = encode_image_bitstream(params, cfg, q_step, expgol)
            decoded, info = decode_bitstream(data, integer_pipeline=True, full_info=True)
            psnr_int = psnr_db(decoded.astype(np.float32), images[b])
            real_latent_bpp = 8 * sum(info["frame_header"].n_bytes_per_latent) / cfg.n_pixels
            est = line["rate_latent_bpp"]
            if abs(psnr_int - line["psnr_db_estimate"]) >= 0.1:
                raise AssertionError(f"image {b}: decoded PSNR {psnr_int} vs estimate {line}")
            if est > 0.05 and abs(real_latent_bpp - est) / est >= 0.2:
                raise AssertionError(f"image {b}: real latent rate {real_latent_bpp} vs {line}")
            line.update({"n_bytes": len(data), "psnr_db": psnr_int, "rate_nn_bits": nn_bits,
                         "real_latent_bpp": real_latent_bpp})
        else:
            # The same parameters cropped to the true size, unbatched and unmasked.
            h, w = sizes[b]
            small = dec.to_coolchic_config((h, w))
            cropped = dict(params)
            cropped["latents"] = [y[:, :sh, :sw].contiguous() for y, (_, sh, sw)
                                  in zip(params["latents"], small.latent_shapes)]
            with torch.no_grad():
                dec_s, rate_s, _ = frame_forward(cropped, small, training=False)
                dec_b, rate_b, _ = frame_forward(params, cfg, training=False, valid_hw=valid_hws[b])
                l_s = loss_function(dec_s, rate_s, targets[b, :, :h, :w], lmbda)
                l_b = loss_function(dec_b, rate_b, targets[b], lmbda, valid_hw=valid_hws[b])
            diff = (dec_b[:, :h, :w] - dec_s).abs()
            masked = {"rate_bits": (rate_b.sum().item(), rate_s.sum().item()),
                      "loss": (l_b.loss.item(), l_s.loss.item()),
                      "decoded_max_abs_diff_255": 255.0 * diff.max().item(),
                      "decoded_share_differing": (diff > 0).float().mean().item()}
            for k in ("rate_bits", "loss"):
                if abs(masked[k][0] - masked[k][1]) > 1e-5 * abs(masked[k][1]):
                    raise AssertionError(f"image {b}: masked vs cropped {k}: {masked}")
            if masked["decoded_max_abs_diff_255"] > 1.0 + 1e-4 or masked["decoded_share_differing"] >= 1e-3:
                raise AssertionError(f"image {b}: masked vs cropped image: {masked}")
            line["masked_vs_cropped"] = masked
        per_image.append(line)

    train_s = sum(v for k, v in stats.stage_seconds.items() if not k.startswith("quantize"))
    emit({
        "phase": "batch_path",
        "batch": n_images,
        "images": per_image,
        "stage_seconds": stats.stage_seconds,
        "encode_seconds": sum(stats.stage_seconds.values()),
        "n_train_steps": stats.n_train_steps,
        "n_batched_steps": stats.n_batched_steps,
        "image_steps_per_s": stats.n_train_steps / train_s,
        "single_image_train_steps_per_s": single_steps_per_s,
        "n_eval_forwards": stats.n_eval_forwards,
        "n_batched_eval_forwards": stats.n_batched_eval_forwards,
        "arm_rate_launches": launches,
        "arm_rate_launches_by_batch": launches_by_batch,
        "launches_per_batched_eval_forward": launches_per_forward,
        "max_memory_allocated_bytes": peak_bytes,
    })
    return launches


def synthetic_video(h: int, w: int, n_frames: int, seed: int = 0):
    """``n_frames`` frames [3, H, W] in [0, 1] (Y, U, V) from a numpy seed: a
    smooth texture moving ``VIDEO_SHIFT`` pixels per frame, plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for t in range(n_frames):
        xs, ys = x - VIDEO_SHIFT[0] * t, y - VIDEO_SHIFT[1] * t
        img = np.stack([
            0.5 + 0.25 * np.sin(xs / 23.0) * np.cos(ys / 17.0) + 0.1 * np.sin((xs + ys) / 7.0),
            0.5 + 0.15 * np.sin(xs / 41.0 + ys / 29.0),
            0.5 + 0.15 * np.cos(xs / 37.0 - ys / 31.0),
        ])
        frames.append(np.clip(img + 0.02 * rng.standard_normal(img.shape), 0.0, 1.0)
                      .astype(np.float32))
    return frames


def psnr_420(a, b) -> float:
    """PSNR of the 4:1:1-weighted MSE of two 4:4:4 frames whose chroma is
    4:2:0 repeated 2x2 (the loss's ``yuv420_mse``)."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    mse = (4.0 * np.mean((a[0] - b[0]) ** 2) + np.mean((a[1, ::2, ::2] - b[1, ::2, ::2]) ** 2)
           + np.mean((a[2, ::2, ::2] - b[2, ::2, ::2]) ** 2)) / 6.0
    return float(-10.0 * np.log10(mse + 1e-10))


def phase_video_path() -> int:
    """Encode a 1080p 4:2:0 GOP (I, P, B) through the entry point to one
    stream; returns the kernel launches the encode made. Raises on any miss."""
    import numpy as np
    import torch

    from coolchic_tpu_torch.bitstream import decode_video_bitstream, read_frame_header
    from coolchic_tpu_torch.encode import encode_one_run
    from coolchic_tpu_torch.io.image import convert_420_to_444, load_frame_data_from_file, write_yuv
    from coolchic_tpu_torch.models.coolchic import coolchic_forward
    from coolchic_tpu_torch.ops import arm_rate as ar
    from coolchic_tpu_torch.params import from_numpy_pytree
    from coolchic_tpu_torch.train.step import eval_metrics
    from coolchic_tpu_torch.utils.types import DecoderConfig, RunConfig
    from coolchic_tpu_torch.video.intercoding import inter_levels

    phase_start = time.perf_counter()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = OUT_DIR / f"synthetic_{VIDEO_W}x{VIDEO_H}_420_8b.yuv"
    path.unlink(missing_ok=True)  # write_yuv appends
    for img in synthetic_video(VIDEO_H, VIDEO_W, VIDEO_FRAMES):
        write_yuv({"y": img[:1], "u": img[1:2, ::2, ::2], "v": img[2:3, ::2, ::2]}, 8, "yuv420",
                  str(path))
    targets = [convert_420_to_444(load_frame_data_from_file(str(path), t).data)
               for t in range(VIDEO_FRAMES)]  # what the encoder reads

    enc, reductions = cut_recipe(VIDEO_WARMUP_MAX_ITR, VIDEO_PHASE_MAX_ITR)
    enc.intra_period, enc.p_period = VIDEO_INTRA_PERIOD, VIDEO_P_PERIOD
    dec = DecoderConfig()
    emit({"phase": "video_path_config", "input": path.name, "frames": VIDEO_FRAMES,
          "img_size": [VIDEO_H, VIDEO_W], "intra_period": VIDEO_INTRA_PERIOD,
          "p_period": VIDEO_P_PERIOD, "shift_px_per_frame": list(VIDEO_SHIFT),
          "lmbda": VIDEO_LMBDA, "dec_cfg": vars(dec),
          "candidates": [wp.candidates for wp in enc.recipe.warmup.phases], "reduced": reductions})

    cool = OUT_DIR / f"synthetic_{VIDEO_W}x{VIDEO_H}_420_8b.cool"
    cool.unlink(missing_ok=True)
    run_cfg = RunConfig(input=path, lmbda=VIDEO_LMBDA, workdir=OUT_DIR / "video", output=cool,
                        enc_cfg=enc, dec_cfg=dec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    arm_reset()
    ups_reset()
    t0 = time.perf_counter()
    run = encode_one_run(run_cfg, seed=0, device="cuda")
    encode_s = time.perf_counter() - t0
    launches = arm_launches()
    launches_by_batch = check_batch_sizes_seen("the video path", VIDEO_BATCH_SIZES)
    check_ups_launches("the video path")
    peak_bytes = torch.cuda.max_memory_allocated()
    venc = run.result
    cfg = dec.to_coolchic_config((VIDEO_H, VIDEO_W))
    launches_per_forward = ar.plane_table(tuple(cfg.latent_shapes)).n_launches
    coded = [(venc.coding_structure.get_frame_from_coding_order(int(k)), e)
             for k, e in sorted(venc.all_frame_encoders.items(), key=lambda kv: int(kv[0]))]
    n_batched_evals = sum(e.stats.n_batched_eval_forwards for _, e in coded)
    if launches != n_batched_evals * launches_per_forward:
        raise AssertionError(f"{launches} kernel launches for {n_batched_evals} batched eval "
                             "forwards")
    if [f.frame_type for f, _ in coded] != ["I", "P", "B"]:
        raise AssertionError(f"coding order {[(f.display_order, f.frame_type) for f, _ in coded]}")

    # The stream, and its integer decode against the encoder's references.
    data = cool.read_bytes()
    if data != run.bitstream or run.row["rate_bpp"] != 8 * len(data) / (cfg.n_pixels * VIDEO_FRAMES):
        raise AssertionError("the file written by --output is not the run's stream")
    if data != venc.to_bitstream():
        raise AssertionError("writing the GOP again gave different bytes")
    t0 = time.perf_counter()
    decoded, info = decode_video_bitstream(data)
    decode_s = time.perf_counter() - t0
    if "timings" not in info or len(decoded) != VIDEO_FRAMES:
        raise AssertionError("the integer decode did not take the one-call C route")

    per_frame = []
    for frame, e in coded:
        disp, cfg_f = frame.display_order, venc.frame_cfg(frame.frame_type)
        target = targets[disp]
        line = {"display": disp, "coding": frame.coding_order, "type": frame.frame_type,
                "depth": frame.depth, "lmbda": e.manager.lmbda, "loss": e.manager.best_loss,
                "psnr_db_estimate": e.psnr_db, "rate_latent_bpp": e.rate_latent_bpp,
                "flat_mean_psnr_db": psnr_420(target, target.mean(axis=(1, 2), keepdims=True))}
        for k in ("loss", "psnr_db_estimate", "rate_latent_bpp"):
            if not math.isfinite(line[k]):
                raise AssertionError(f"frame {disp}: {k} is not finite: {line}")
        if not line["psnr_db_estimate"] > line["flat_mean_psnr_db"]:
            raise AssertionError(f"frame {disp}: PSNR estimate below the flat-mean frame: {line}")

        # Drift-free: the decoder's frame is the reference the encoder used.
        if not np.array_equal(decoded[disp], e.decoded):
            n = int(np.count_nonzero(decoded[disp] != e.decoded))
            raise AssertionError(f"frame {disp}: {n} decoded samples differ from the encoder's")
        line["psnr_db"] = psnr_420(decoded[disp], target)
        if abs(line["psnr_db"] - e.psnr_db) >= 0.1:
            raise AssertionError(f"frame {disp}: decoded PSNR vs estimate: {line}")
        fh = read_frame_header(e.frame_bytes)
        line["n_bytes"] = len(e.frame_bytes)
        line["real_latent_bpp"] = 8 * sum(fh.n_bytes_per_latent) / cfg.n_pixels
        if e.rate_latent_bpp > 0.05 and abs(
                line["real_latent_bpp"] - e.rate_latent_bpp) / e.rate_latent_bpp >= 0.2:
            raise AssertionError(f"frame {disp}: real latent rate vs estimate: {line}")

        # The final params on the card (ARM kernel) and on the CPU (plain ARM),
        # against the references the encoder trained on.
        target_ex = np.concatenate([target, *venc._refs_for(frame)])
        on = {d: (from_numpy_pytree(e.params, d), torch.tensor(target_ex, device=d))
              for d in ("cuda", "cpu")}
        m = {d: eval_metrics(p, cfg_f, t, e.manager.lmbda) for d, (p, t) in on.items()}
        cross = {k: (getattr(m["cuda"], k).item(), getattr(m["cpu"], k).item())
                 for k in ("loss", "psnr_db", "rate_latent_bpp")}
        bpp = cross["rate_latent_bpp"]
        if abs(bpp[0] - bpp[1]) > 1e-4 * bpp[1] or abs(cross["psnr_db"][0] - cross["psnr_db"][1]) > 0.01:
            raise AssertionError(f"frame {disp}: card and CPU differ: {cross}")
        line["card_vs_cpu_eval"] = cross
        if frame.frame_type != "I":  # one synthesis output, the integer warp on both
            with torch.no_grad():
                raw = coolchic_forward(on["cuda"][0], cfg_f, training=False)[0][None]
            refs = [torch.tensor(r[None], device="cuda") for r in venc._refs_for(frame)] + [None]
            lv = {d: inter_levels(raw.to(d), refs[0].to(d),
                                  None if refs[1] is None else refs[1].to(d), cfg_f.flow_gain)
                  for d in ("cuda", "cpu")}
            if not torch.equal(lv["cuda"].cpu(), lv["cpu"]):
                raise AssertionError(f"frame {disp}: integer warp levels differ card vs CPU")
            line["inter_levels_card_equal_cpu"] = True

        stages = e.stats.stage_seconds
        train_s = sum(v for k, v in stages.items() if k == "warmup" or k.startswith("phase_"))
        line.update({"stage_seconds": stages, "n_train_steps": e.stats.n_train_steps,
                     "train_steps_per_s": e.stats.n_train_steps / train_s,
                     "n_eval_forwards": e.stats.n_eval_forwards,
                     "n_batched_eval_forwards": e.stats.n_batched_eval_forwards,
                     "write_s": stages["write"], "frame_seconds": e.manager.total_training_time_sec})
        per_frame.append(line)

    emit({"phase": "video_path", "row": run.row, "frames": per_frame, "encode_seconds": encode_s,
          "checks_seconds": time.perf_counter() - phase_start - encode_s,
          "n_bytes": len(data), "decode_s": decode_s, "decode_c_timings": info["timings"],
          "drift_free": True, "arm_rate_launches": launches,
          "arm_rate_launches_by_batch": launches_by_batch,
          "launches_per_eval_forward": launches_per_forward,
          "max_memory_allocated_bytes": peak_bytes})
    return launches


def phase_hypernet_path(trained_params) -> int:
    """The amortized encoder at full width: one batched eval forward of 8
    predicted decoders, the dataset sweep (plain and with the delta-subset
    search), the one-shot encode to a stream for two images, the rated
    subset search and a finetune. The shared base decoder is the main path's
    trained decoder (``trained_params`` without its latents): at its init
    the ARM's Laplace model sits at its 2^-16 probability floor on most
    latents, where the stream's adaptive coder pays about half the bits the
    estimate counts, and the real rate cannot be held to the estimate.
    Returns the kernel launches of the path. Raises on any miss."""
    import numpy as np
    import torch

    from coolchic_tpu_torch.bitstream import decode_bitstream
    from coolchic_tpu_torch.hypernet import DeltaWholeNet, WholeNetState
    from coolchic_tpu_torch.hypernet.finetune import default_finetune_phases, finetune_coolchic
    from coolchic_tpu_torch.hypernet.inference import (
        eval_dataset, eval_image_delta_subsets_rated, hypernet_to_bitstream,
    )
    from coolchic_tpu_torch.models.arm import arm_rate_plain, rate_tolerance
    from coolchic_tpu_torch.models.coolchic import coolchic_forward_latents
    from coolchic_tpu_torch.params import from_numpy_pytree, tree_leaves, tree_map
    from coolchic_tpu_torch.train.step import eval_metrics
    from coolchic_tpu_torch.utils.types import DecoderConfig

    def clock() -> float:
        torch.cuda.synchronize()
        return time.perf_counter()

    dec = DecoderConfig()
    cfg = dec.to_coolchic_config((IMG_H, IMG_W))
    net = DeltaWholeNet(cfg, backbone_arch="resnet18")
    state = net.init(0, device="cuda")
    state = WholeNetState(state.hypernet,
                          {k: v for k, v in trained_params.items() if k != "latents"})
    # Untrained: the delta heads start at zero output. Draw their output
    # layers from a seeded normal so that the deltas (and the search) are not.
    gen = torch.Generator("cuda").manual_seed(0)
    for head in ("MLP_0", "MLP_1", "MLP_2"):
        mlp = getattr(net.module, head)
        key = f"{head}.Dense_{mlp.n_layers - 1}.weight"
        state.hypernet[key] = HN_HEAD_STD * torch.randn(
            state.hypernet[key].shape, generator=gen, device="cuda")
    n_params = sum(t.numel() for t in state.hypernet.values())
    images = [np.round(synthetic_image(IMG_H, IMG_W, seed=b) * 255.0) / 255.0
              for b in range(HN_IMAGES)]
    imgs = torch.tensor(np.stack(images), device="cuda")
    emit({"phase": "hypernet_path_config", "backbone": "resnet18", "n_hidden_channels": 64,
          "heads": {"synthesis": [1024, 3], "arm": [1024, 3], "upsampling": [256, 3]},
          "output_activation": "tanh", "hypernet_params": n_params, "images": HN_IMAGES,
          "img_size": [IMG_H, IMG_W], "dec_cfg": vars(dec), "lmbda": HN_LMBDA,
          "head_output_std": HN_HEAD_STD,
          "weights": "hypernet: seeded init (seed 0), untrained; base decoder: the main path's",
          "finetune_phases_max_itr": [p.max_itr for p in default_finetune_phases(HN_FINETUNE_ITR)],
          "reduced": {"finetune_phases_max_itr_default": [
              p.max_itr for p in default_finetune_phases()]}})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    arm_reset()
    ups_reset()

    # 1. The one-shot eval forward of 8 predicted decoders: one launch at B = 8.
    t0 = clock()
    with torch.no_grad():
        decoded, rate = net.forward(state, imgs, training=False)
    forward_wall_ms = 1e3 * (clock() - t0)
    if dict(TALLY["arm_by_batch"]) != {HN_IMAGES: 1}:
        raise AssertionError(f"the one-shot forward launched {dict(TALLY['arm_by_batch'])}")
    if tuple(decoded.shape) != (HN_IMAGES, 3, IMG_H, IMG_W) or not torch.isfinite(decoded).all() \
            or not torch.isfinite(rate).all():
        raise AssertionError("the one-shot forward's outputs are not finite or mis-shaped")
    # Rows 0-1 on the CPU: the hypernet's predictions from the same weights,
    # and the decoders on the card's predictions (so that no latent rounds
    # the other way on one device only).
    with torch.no_grad():
        lat_card, delta_card = net.predict(state, imgs[:HN_CPU_IMAGES])
        cpu_state = WholeNetState(*[tree_map(lambda t: t.cpu(), tree) for tree in state])
        lat_cpu, delta_cpu = net.predict(cpu_state, imgs[:HN_CPU_IMAGES].cpu())
        predict_err = max(float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-6))
                          for a, b in zip(tree_leaves([lat_card, delta_card]),
                                          tree_leaves([lat_cpu, delta_cpu])))
        if predict_err > 1e-3:
            raise AssertionError(f"card vs CPU predictions differ by {predict_err} (relative)")
        lat_c = [y.cpu() for y in lat_card]
        nets_c = net._nets(cpu_state, tree_map(lambda t: t.cpu(), delta_card))
        dec_cpu, rate_cpu, _ = coolchic_forward_latents(nets_c, lat_c, cfg, training=False)
        y_hat = [torch.round(y * cfg.encoder_gain) for y in lat_c]
        log_scale = arm_rate_plain(y_hat, nets_c["arm"], cfg.dim_arm)[2]
        scale = torch.exp(torch.clamp(log_scale - 4.0, -4.6, 5.0))
    rate_ok = (rate[:HN_CPU_IMAGES].cpu() - rate_cpu).abs() <= rate_tolerance(rate_cpu, scale)
    decoded_err = float((decoded[:HN_CPU_IMAGES].cpu() - dec_cpu).abs().max())
    if not bool(rate_ok.all()) or decoded_err > 1e-4:
        raise AssertionError(f"one-shot forward card vs CPU: {int((~rate_ok).sum())} rates out "
                             f"of tolerance, decoded max abs diff {decoded_err}")
    latent_std = float(torch.cat([y.flatten() for y in lat_card]).std())
    delta_std = {m: float(torch.cat([t.flatten() for t in tree_leaves(delta_card[m])]).std())
                 for m in delta_card}

    # Prediction alone (no kernel), device time by CUDA events.
    with torch.no_grad():
        predict_ms = {b: time_ms(lambda b=b: net.predict(state, imgs[:b]), n_warmup=1,
                                 n_iter=5, per_sample=2) for b in (1, HN_IMAGES)}

    # 2. The dataset sweep, plain and with the delta-subset search.
    named = [(f"synthetic_{b}", images[b]) for b in range(HN_IMAGES)]
    t0 = clock()
    rows = eval_dataset(net, state, named, HN_LMBDA)
    sweep_s = clock() - t0
    t0 = clock()
    rows_search = eval_dataset(net, state, named, HN_LMBDA, delta_subset_search=True)
    sweep_search_s = clock() - t0
    for row in rows + rows_search:
        if not all(math.isfinite(row[k]) for k in ("rate_bpp", "psnr_db", "mse")):
            raise AssertionError(f"eval_dataset row not finite: {row}")

    # 3. The one-shot encode to a stream, decoded by the integer pipeline.
    streams = []
    for b in HN_STREAM_IMAGES:
        timings = {}
        data, info = hypernet_to_bitstream(net, state, imgs[b], HN_LMBDA, timings=timings)
        path = OUT_DIR / f"hypernet_{b}.cool"
        path.write_bytes(data)
        t0 = time.perf_counter()
        img_int, _ = decode_bitstream(path.read_bytes(), integer_pipeline=True)
        decode_s = time.perf_counter() - t0
        # The eval forward's estimate on the stream's own params and latents.
        _, full = decode_bitstream(data, integer_pipeline=True, full_info=True)
        params = from_numpy_pytree(tree_map(lambda a: np.asarray(a, np.float32), full["params"]),
                                   "cuda")
        params["latents"] = [torch.tensor(np.asarray(y, np.float32) / cfg.encoder_gain,
                                          device="cuda") for y in full["latents"]]
        est = eval_metrics(params, cfg, imgs[b], HN_LMBDA)
        psnr_est, bpp_est = est.psnr_db.item(), est.rate_latent_bpp.item()
        psnr_int = psnr_db(img_int, images[b])
        real_latent_bpp = 8 * sum(full["frame_header"].n_bytes_per_latent) / cfg.n_pixels
        if abs(psnr_int - psnr_est) >= 0.1:
            raise AssertionError(f"image {b}: decoded PSNR {psnr_int} vs estimate {psnr_est}")
        if bpp_est > 0.05 and abs(real_latent_bpp - bpp_est) / bpp_est >= 0.2:
            raise AssertionError(f"image {b}: real latent rate {real_latent_bpp} vs {bpp_est}")
        streams.append({
            "image": b, "file": path.name, "n_bytes": len(data), "psnr_db": psnr_int,
            "psnr_db_estimate": psnr_est, "real_latent_bpp": real_latent_bpp,
            "rate_latent_bpp_estimate": bpp_est, **timings, "decode_s": decode_s,
            "delta_q_steps": {m: [i.q_step_w, i.q_step_b] for m, i in info["delta_infos"].items()},
            "delta_rate_bits": {m: i.rate_bits for m, i in info["delta_infos"].items()},
            "nn_q_steps": {m: [i.q_step_w, i.q_step_b] for m, i in info["nn_infos"].items()}})

    # 4. The rated delta-subset search on image 0.
    options = []
    t0 = clock()
    best = eval_image_delta_subsets_rated(net, state, imgs[0], HN_LMBDA, all_options=options)
    rated_s = clock() - t0

    # 5. A finetune of image 0 from the one-shot decoder, phases cut.
    t0 = clock()
    m0, _, logs = finetune_coolchic(net, state, imgs[0], HN_LMBDA, 0,
                                    default_finetune_phases(HN_FINETUNE_ITR))
    finetune_s = clock() - t0
    if not logs.loss <= m0.loss.item():
        raise AssertionError(f"finetuned loss {logs.loss} > one-shot loss {m0.loss.item()}")

    launches = arm_launches()
    launches_by_batch = check_batch_sizes_seen("the hypernet path")
    check_ups_launches("the hypernet path")
    peak_bytes = torch.cuda.max_memory_allocated()
    emit({
        "phase": "hypernet_path",
        "launches": launches, "arm_rate_launches_by_batch": launches_by_batch,
        "one_shot_forward_wall_ms": forward_wall_ms,
        "predict_ms": {str(b): ms for b, ms in predict_ms.items()},
        "card_vs_cpu": {"rows": HN_CPU_IMAGES, "predict_max_rel_err": predict_err,
                        "decoded_max_abs_diff": decoded_err,
                        "rate_max_abs_diff": float((rate[:HN_CPU_IMAGES].cpu() - rate_cpu)
                                                   .abs().max())},
        "latent_std": latent_std, "delta_std": delta_std,
        "eval_dataset_s": sweep_s, "eval_dataset_search_s": sweep_search_s,
        "eval_dataset_rows": rows, "eval_dataset_search_options": [
            r["option_selected"] for r in rows_search],
        "streams": streams,
        "rated_search": {"best": best, "options": options, "seconds": rated_s},
        "finetune": {"one_shot_loss": m0.loss.item(), "finetuned_loss": logs.loss,
                     "one_shot_psnr_db": m0.psnr_db.item(), "finetuned_psnr_db": logs.psnr_db,
                     "seconds": finetune_s},
        "max_memory_allocated_bytes": peak_bytes,
    })
    return launches


def hypernet_step_card_vs_cpu(net, state, imgs) -> dict:
    """One whole-net train step (deterministic quantizer, lr ``HT_CPU_LR``)
    from the same state and images on the card and on the CPU. The losses
    must agree to 1e-4 relative. Adam's first step moves a parameter by
    g / (|g| + eps) * lr, about lr * sign(g): where a gradient is near eps
    (1e-8, after the clip) a small difference between the two devices'
    gradients moves it anywhere in (-lr, lr). The ConvNeXt latent encoder,
    the heads and the decoders (smooth activations) agree closely; the
    resnet18's ReLUs and max-pool can switch at other elements on the two
    devices (inputs within rounding of a tie), which moves its weight
    gradients further apart. Hence: every move within 2 lr (a flip), and
    moves beyond 1 % of lr on at most 1e-4 of the parameters outside the
    resnet and 1 % of those inside it. Raises on a miss."""
    import torch

    from coolchic_tpu_torch.hypernet import WholeNetState
    from coolchic_tpu_torch.hypernet.training import make_wholenet_train_step, state_leaves
    from coolchic_tpu_torch.params import tree_map
    from coolchic_tpu_torch.train.presets import TrainerPhase

    phase = TrainerPhase(lr=HT_CPU_LR, max_itr=1, quantizer_type="none",
                         quantizer_noise_type="none")
    out = {}
    for device in ("cuda", "cpu"):
        s = WholeNetState(*[tree_map(lambda t: t.to(device).clone(), tree) for tree in state])
        before = [t.detach().cpu().clone() for t in state_leaves(s)]
        tx, step = make_wholenet_train_step(net, phase)
        t0 = time.perf_counter()
        s, _, loss = step(s, tx.init(s), imgs.to(device), 1e-3, None, HT_CPU_LR, 0.3, 0.0)
        loss = loss.item()
        out[device] = (loss, [a.cpu() - b for a, b in zip(state_leaves(s), before)],
                       time.perf_counter() - t0)
    (loss_card, moves_card, card_s), (loss_cpu, moves_cpu, cpu_s) = out["cuda"], out["cpu"]
    in_resnet = [k.startswith("ResNet") for k in state.hypernet]
    in_resnet += [False] * (len(moves_card) - len(in_resnet))
    diffs = {True: [], False: []}
    for a, b, r in zip(moves_card, moves_cpu, in_resnet):
        diffs[r].append((a - b).abs().flatten())
    diff = {r: torch.cat(d) for r, d in diffs.items()}
    share = {r: float((d > 0.01 * HT_CPU_LR).double().mean()) for r, d in diff.items()}
    max_diff = max(float(d.max()) for d in diff.values())
    res = {"batch": int(imgs.shape[0]), "lr": HT_CPU_LR, "loss_card": loss_card,
           "loss_cpu": loss_cpu, "loss_rel_err": abs(loss_card - loss_cpu) / abs(loss_cpu),
           "max_abs_move_diff": max_diff, "share_beyond_1pct_lr_resnet": share[True],
           "share_beyond_1pct_lr_elsewhere": share[False],
           "n_params": {"resnet": int(diff[True].numel()), "elsewhere": int(diff[False].numel())},
           "card_s": card_s, "cpu_s": cpu_s}
    if res["loss_rel_err"] > 1e-4 or max_diff > 2 * HT_CPU_LR or share[True] > 1e-2 \
            or share[False] > 1e-4:
        raise AssertionError(f"train step card vs CPU: {res}")
    return res


def phase_hypernet_train_path() -> int:
    """The hypernet trainer at full width through its CLI
    (``hypernet_train.main``, ``--synthetic --device cuda``, the JAX CLI's
    no-config default, samples cut): ``--mode no`` with checkpoints, ``--mode
    delta --init_from`` it, ``--resume`` that run to more samples, ``--mode
    small``, then ``iterations_to_match`` of the resumed delta net. Before
    it, one train step on the card against the CPU. Returns the kernel
    launches of the path. Raises on any miss."""
    import shutil

    import numpy as np
    import torch

    from coolchic_tpu_torch import hypernet as hn
    from coolchic_tpu_torch import hypernet_train
    from coolchic_tpu_torch.eval.hypernet import iterations_to_match
    from coolchic_tpu_torch.hypernet import DeltaWholeNet, training
    from coolchic_tpu_torch.hypernet import inference
    from coolchic_tpu_torch.metalearning import synthetic_batches
    from coolchic_tpu_torch.utils import trace
    from coolchic_tpu_torch.utils.types import DecoderConfig

    def clock() -> float:
        torch.cuda.synchronize()
        return time.perf_counter()

    root = OUT_DIR / "hypernet_train"
    shutil.rmtree(root, ignore_errors=True)
    workdirs = {m: root / m for m in ("no", "delta", "small")}
    cfg = DecoderConfig().to_coolchic_config((HT_PATCH, HT_PATCH))

    # The one-step check, from the delta net's init with the heads' output
    # layers drawn as in the hypernet path (at init every delta is zero, and
    # so is the gradient of the heads' hidden layers).
    net = DeltaWholeNet(cfg, backbone_arch="resnet18")
    state = net.init(0, device="cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    for head in ("MLP_0", "MLP_1", "MLP_2"):
        key = f"{head}.Dense_{getattr(net.module, head).n_layers - 1}.weight"
        state.hypernet[key] = HN_HEAD_STD * torch.randn(
            state.hypernet[key].shape, generator=gen, device="cuda")
    imgs = torch.tensor(next(synthetic_batches(HT_CPU_BATCH, (HT_PATCH, HT_PATCH), seed=7)))
    ups_reset()
    card_vs_cpu = hypernet_step_card_vs_cpu(net, state, imgs)
    # Launches of the whole-net steps, which count_ups_training_steps does
    # not see: one card step here (the first of its graph: eager), then those
    # of each train_wholenet call, whose replays the wrapper does not see
    # (its train span counts them).
    ups_per_step = 4 * (cfg.latent_n_grids - 1)
    ups_steps = {"launches": ups_per_step, "replayed": 0}
    del net, state

    common = ["--synthetic", "--device", "cuda", "--disable_wandb", "--patch_size",
              str(HT_PATCH), "--batch_size", str(HT_BATCH), "--lmbda", "1e-3"]
    runs = [
        ("no", ["--mode", "no", "--workdir", str(workdirs["no"]), "--n_samples",
                str(HT_SAMPLES["no"]), "--checkpointing_freq", str(HT_CKPT_FREQ["no"])]),
        ("delta", ["--mode", "delta", "--init_from", str(workdirs["no"]), "--workdir",
                   str(workdirs["delta"]), "--n_samples", str(HT_SAMPLES["delta"]),
                   "--checkpointing_freq", str(HT_CKPT_FREQ["delta"])]),
        ("resume", ["--mode", "delta", "--resume", "--workdir", str(workdirs["delta"]),
                    "--n_samples", str(HT_SAMPLES["resume"]), "--checkpointing_freq",
                    str(HT_CKPT_FREQ["resume"])]),
        ("small", ["--mode", "small", "--workdir", str(workdirs["small"]), "--n_samples",
                   str(HT_SAMPLES["small"])]),
    ]
    emit({"phase": "hypernet_train_path_config", "backbone": "resnet18", "n_hidden_channels": 64,
          "heads": {"synthesis": [1024, 3], "arm": [1024, 3], "upsampling": [256, 3]},
          "output_activation": "tanh", "patch": [HT_PATCH, HT_PATCH], "dec_cfg": vars(
              DecoderConfig()), "batch": HT_BATCH, "lmbda": 1e-3,
          "phase": {"lr": 1e-4, "schedule_lr": True, "quantizer": "softround + gaussian",
                    "softround_temperature": [0.3, 0.3], "noise_parameter": [0.25, 0.25]},
          "runs": {name: args for name, args in runs},
          "iterations_to_match": {"max_itr": HT_MATCH[0], "check_every": HT_MATCH[1]},
          "reduced": {"n_samples_default": 10_000, "n_samples": HT_SAMPLES,
                      "iterations_to_match_max_itr_default": 2000}})

    # What each run hands train_wholenet, its wall time, and every checkpoint
    # write (during the training loop, or the CLI's final one).
    calls, writes, current = [], [], {"run": None, "in_loop": False}
    real_train, real_save = hn.train_wholenet, inference.save_checkpoint

    def spy_train(net, state, data_iter, eval_imgs, **kw):
        current["in_loop"] = True
        ups_steps["launches"] += ups_per_step * max(
            (kw["n_samples"] - kw.get("samples_offset", 0)) // kw["batch_size"], 1)
        t0 = clock()
        best, logs = real_train(net, state, data_iter, eval_imgs, **kw)
        wall_s = clock() - t0
        steps = trace.spans("train")[-1].attrs
        ups_steps["replayed"] += ups_per_step * (steps["graph_replays"] - steps["graph_captures"])
        calls.append({"net": net, "state": state, "eval_imgs": eval_imgs, "kw": kw,
                      "best": best, "logs": logs, "wall_s": wall_s, "steps": steps})
        current["in_loop"] = False
        return best, logs

    def spy_save(state, path, samples_seen=0):
        t0 = time.perf_counter()
        real_save(state, path, samples_seen)
        writes.append({"file": f"{Path(path).parent.name}/{Path(path).name}",
                       "seconds": time.perf_counter() - t0, **current})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    arm_reset()
    hn.train_wholenet = spy_train
    inference.save_checkpoint = training.save_checkpoint = spy_save
    resume_from = None
    try:
        for name, args in runs:
            current["run"] = name
            if name == "resume":
                resume_from = max(workdirs["delta"].glob("samples_*.pkl"),
                                  key=lambda q: int(q.stem.split("_")[1]))
            if hypernet_train.main(common + args) != 0:
                raise AssertionError(f"hypernet_train {name} returned non-zero")
        delta_net = calls[2]["net"]
        delta_best = inference.load_checkpoint(workdirs["delta"], device="cuda")
        img = torch.tensor(np.round(synthetic_image(HT_PATCH, HT_PATCH, seed=0) * 255.0) / 255.0,
                           device="cuda")
        t0 = clock()
        match = iterations_to_match(delta_net, delta_best, img, 1e-3, 0, max_itr=HT_MATCH[0],
                                    check_every=HT_MATCH[1])
        match_s = clock() - t0
    finally:
        hn.train_wholenet = real_train
        inference.save_checkpoint = training.save_checkpoint = real_save
    launches = arm_launches()
    launches_by_batch = check_batch_sizes_seen("the hypernet train path", HT_BATCH_SIZES)
    check_ups_launches("the hypernet train path", ups_steps["launches"], ups_steps["replayed"])
    peak_bytes = torch.cuda.max_memory_allocated()
    n_validations = sum(len(c["logs"]) for c in calls)
    n_match_evals = (HT_MATCH[0] // HT_MATCH[1]) * (1 + 1) + 1
    if launches < n_validations + n_match_evals:
        raise AssertionError(f"{launches} launches for {n_validations} validations and "
                             f"{n_match_evals} evaluations of iterations_to_match")

    # Resume holds: the state the resumed run starts from is the checkpoint it loads.
    ckpt_state, ckpt_samples = inference.load_checkpoint_meta(resume_from, device="cuda")
    resumed = calls[2]
    if resumed["kw"]["samples_offset"] != ckpt_samples or not all(
            torch.equal(a, b) for a, b in zip(training.state_leaves(resumed["state"]),
                                              training.state_leaves(ckpt_state))):
        raise AssertionError(f"the resumed run does not start from {resume_from.name}")
    seen = [log.samples_seen for log in resumed["logs"]]
    if seen[-1] != HT_SAMPLES["resume"] or min(seen) <= ckpt_samples:
        raise AssertionError(f"the resumed run's validations at {seen}")

    # Before and after: each run's start state and best state on its eval batch.
    per_run = {}
    for (name, _), call in zip(runs, calls):
        ev = {}
        for when, st in (("before", call["state"]), ("after", call["best"])):
            m = training.evaluate_wholenet(call["net"], st, call["eval_imgs"], 1e-3)
            ev[when] = {k: float(v) for k, v in m.items()}
        n_steps = max((call["kw"]["n_samples"] - call["kw"]["samples_offset"]) // HT_BATCH, 1)
        ckpt_s = sum(w["seconds"] for w in writes if w["run"] == name and w["in_loop"])
        per_run[name] = {
            "steps": n_steps, "wall_s": call["wall_s"], "steps_per_s": n_steps / call["wall_s"],
            "samples_per_s": n_steps * HT_BATCH / call["wall_s"],
            "steps_per_s_without_checkpoints": n_steps / (call["wall_s"] - ckpt_s),
            "samples_offset": call["kw"]["samples_offset"],
            "steps_by_kind": {k: call["steps"][k] for k in training.STEP_COUNTS},
            "validations": [log._asdict() for log in call["logs"]], "eval": ev}
        if call["steps"]["graph_replays"] + call["steps"]["eager_steps"] != n_steps:
            raise AssertionError(f"{name}: {n_steps} steps, ran as {per_run[name]['steps_by_kind']}")
    if not per_run["no"]["eval"]["after"]["loss"] < per_run["no"]["eval"]["before"]["loss"]:
        raise AssertionError(f"the NO run did not learn: {per_run['no']['eval']}")
    for name, run in per_run.items():
        if not all(math.isfinite(v) for e in run["eval"].values() for v in e.values()):
            raise AssertionError(f"{name}: eval metrics not finite: {run['eval']}")
    if not all(math.isfinite(v) for v in match["scratch_losses"]) or not math.isfinite(
            match["one_shot_loss"]):
        raise AssertionError(f"iterations_to_match: {match}")

    # evaluate_wholenet at B = 8 (wall, synchronised), after the counted run.
    call = calls[2]
    eval_ms = []
    for _ in range(5):
        t0 = clock()
        training.evaluate_wholenet(call["net"], call["best"], call["eval_imgs"], 1e-3)
        eval_ms.append(1e3 * (clock() - t0))
    emit({
        "phase": "hypernet_train_path",
        "launches": launches, "arm_rate_launches_by_batch": launches_by_batch,
        "validations": n_validations, "card_vs_cpu_step": card_vs_cpu, "runs": per_run,
        "evaluate_wholenet_ms_b8": statistics.median(eval_ms),
        "checkpoint_writes": writes,
        "resume": {"from": resume_from.name, "samples_offset": ckpt_samples,
                   "validations_at": seen},
        "iterations_to_match": {**match, "seconds": match_s},
        "max_memory_allocated_bytes": peak_bytes,
    })
    return launches


def sharded_encode_rank(t_launch: float, *args, mesh, **kwargs):
    """What the rank of the sharded encode runs (``tallied_launch`` starts
    it, ``parallel.launch`` gives it ``mesh``): the first NCCL collective
    (the communicator's creation), then ``encode_batch_sharded``; returns
    its result and the rank's seconds."""
    import torch
    import torch.distributed as dist

    from coolchic_tpu_torch.parallel import encode_batch_sharded

    started = time.time()
    t0 = time.perf_counter()
    dist.barrier(group=mesh.group)
    torch.cuda.synchronize()
    group_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = encode_batch_sharded(*args, mesh=mesh, **kwargs)
    torch.cuda.synchronize()
    return out, {"launcher_startup_s": started - t_launch, "process_group_startup_s": group_s,
                 "rank_encode_s": time.perf_counter() - t0, "rank_device": str(mesh.device),
                 "backend": mesh.backend, "world_size": mesh.world_size}


def phase_multi_gpu_and_tools_path(run, cfg, img) -> int:
    """``parallel/`` at world size 1 on NCCL (the sharded encode), the
    trainer's ``--data_parallel``, ``encode_simpler``, ``retrain_latents`` and
    ``detailed_eval_metrics`` (see the module docstring, item 9). Returns the
    kernel launches of the phase, its ranks' included. Raises on any miss."""
    import shutil

    import numpy as np
    import torch

    from coolchic_tpu_torch import encode_simpler, hypernet_train, parallel, retrain_latents
    from coolchic_tpu_torch.bitstream import decode_bitstream
    from coolchic_tpu_torch.hypernet import NOWholeNet
    from coolchic_tpu_torch.hypernet.inference import load_checkpoint
    from coolchic_tpu_torch.hypernet.training import evaluate_wholenet
    from coolchic_tpu_torch.metalearning import synthetic_batches
    from coolchic_tpu_torch.train.encode import encode_frame_batch
    from coolchic_tpu_torch.train.step import detailed_eval_metrics, eval_metrics
    from coolchic_tpu_torch.utils import trace
    from coolchic_tpu_torch.utils.types import DecoderConfig

    def clock() -> float:
        torch.cuda.synchronize()
        return time.perf_counter()

    seen = {}

    def sizes_of(step: str, before: Counter, checked) -> None:
        """The launches of ``step`` by batch size, each held by the checks."""
        delta = {b: n - before.get(b, 0) for b, n in TALLY["arm_by_batch"].items()
                 if n > before.get(b, 0)}
        if not set(delta) <= set(checked):
            raise AssertionError(f"{step} launched the kernel on batches of {sorted(delta)}; "
                                 f"checked at its pyramid: {checked}")
        seen[step] = {str(b): n for b, n in sorted(delta.items())}

    root = OUT_DIR / "multi_gpu_and_tools"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    n_images = len(MG_LMBDAS)
    enc, reductions = cut_recipe(MG_WARMUP_MAX_ITR, MG_PHASE_MAX_ITR)
    dec = DecoderConfig()
    batch_cfg = dec.to_coolchic_config((IMG_H, IMG_W))
    targets = torch.tensor(np.stack([np.round(synthetic_image(IMG_H, IMG_W, seed=b) * 255.0)
                                     / 255.0 for b in range(n_images)]).astype(np.float32))
    seeds = list(range(n_images))
    emit({"phase": "multi_gpu_and_tools_path_config", "sharded_encode": {
        "images": n_images, "img_size": [IMG_H, IMG_W], "lmbdas": list(MG_LMBDAS),
        "world_size": 1, "backend": "nccl", "dec_cfg": vars(dec),
        "candidates": [wp.candidates for wp in enc.recipe.warmup.phases], "reduced": reductions},
        "data_parallel_train": {"mode": "no", "patch": [HT_PATCH, HT_PATCH], "batch": HT_BATCH,
                                "n_samples": MG_HT_SAMPLES, "data_parallel": [0, 1]},
        "encode_simpler": {"budget": "debug", "img_size": [IMG_H, IMG_W]},
        "retrain_latents": {"init": "zeros", "n_itr": MG_RETRAIN_ITR, "frame": 0}})

    torch.cuda.synchronize()
    arm_reset()
    ups_reset()

    # --- the sharded encode, one rank on NCCL, and its reference here, both
    # with cuDNN's deterministic algorithms (the rank takes this process's
    # switches). The replicate padding's backward still sums with atomics,
    # so the two runs agree within a tolerance, not bit for bit.
    torch.backends.cudnn.deterministic = True
    try:
        before = Counter(TALLY["arm_by_batch"])
        t0 = clock()
        (res, infos), rank = tallied_launch(sharded_encode_rank, 1, "cuda", time.time(),
                                            targets, MG_LMBDAS, batch_cfg, enc.recipe, seeds,
                                            with_quant_info=True)
        sharded_s = clock() - t0
        sharded_launches = arm_launches()
        sizes_of("sharded_encode", before, BATCH_SIZES)
        # The rank's, whose steps are the reference's.
        ups_sharded = sum(TALLY["ups_by_geometry"].values())
        before = Counter(TALLY["arm_by_batch"])
        t0 = clock()
        want, want_infos = encode_frame_batch(targets.cuda(), MG_LMBDAS, batch_cfg, enc.recipe,
                                              seeds, with_quant_info=True)
        reference_s = clock() - t0
        sizes_of("sharded_encode_reference", before, BATCH_SIZES)
        if ups_sharded != UPS_WANT["launches"]:
            raise AssertionError(f"the sharded encode launched ups_wgrad {ups_sharded} times, "
                                 f"its reference's steps make {UPS_WANT['launches']}")
    finally:
        torch.backends.cudnn.deterministic = False
    emit({"phase": "multi_gpu_launcher_startup", "seconds": rank["launcher_startup_s"]})
    emit({"phase": "multi_gpu_process_group_startup", "seconds": rank["process_group_startup_s"],
          "backend": rank["backend"], "world_size": rank["world_size"]})
    emit({"phase": "multi_gpu_sharded_encode_seconds", "sharded_s": sharded_s,
          "rank_encode_s": rank["rank_encode_s"], "reference_encode_frame_batch_s": reference_s})
    flat = [-10.0 * math.log10(float(np.mean((t - t.mean(axis=(1, 2), keepdims=True)) ** 2)))
            for t in targets.numpy()]
    diff = {"psnr_db": float((res.psnr_db - want.psnr_db).abs().max()),
            "rate_latent_bpp_rel": float(((res.rate_latent_bpp - want.rate_latent_bpp).abs()
                                          / want.rate_latent_bpp).max()),
            "loss_rel": float(((res.loss - want.loss).abs() / want.loss).max())}
    if not (diff["psnr_db"] <= 0.1 and diff["rate_latent_bpp_rel"] <= 0.05
            and diff["loss_rel"] <= 0.02):
        raise AssertionError(f"the sharded encode differs from encode_frame_batch: {diff}")
    if rank["rank_device"] != "cuda:0" or rank["backend"] != "nccl":
        raise AssertionError(f"sharded encode: {len(infos)} infos, rank {rank}")
    for b in range(n_images):
        if not (math.isfinite(res.loss[b]) and res.psnr_db[b] > flat[b]):
            raise AssertionError(f"sharded image {b}: PSNR {res.psnr_db[b]} vs flat {flat[b]}")
    sharded = {"psnr_db": res.psnr_db.tolist(), "rate_latent_bpp": res.rate_latent_bpp.tolist(),
               "reference_psnr_db": want.psnr_db.tolist(), "max_diff": diff,
               "infos_equal": infos == want_infos, "n_train_steps": res.stats.n_train_steps,
               "image_steps_per_s_rank": res.stats.n_train_steps / rank["rank_encode_s"],
               "launches_rank": sharded_launches}

    # --- the trainer with --data_parallel 1 against 0.
    common = ["--synthetic", "--device", "cuda", "--disable_wandb", "--mode", "no",
              "--patch_size", str(HT_PATCH), "--batch_size", str(HT_BATCH), "--lmbda", "1e-3",
              "--n_samples", str(MG_HT_SAMPLES)]
    eval_imgs = torch.tensor(next(synthetic_batches(HT_BATCH, (HT_PATCH, HT_PATCH), seed=999)),
                             device="cuda")
    net = NOWholeNet(DecoderConfig().to_coolchic_config((HT_PATCH, HT_PATCH)))
    ups_per_step = 4 * (batch_cfg.latent_n_grids - 1)
    dp = {}
    real_launch = parallel.launch
    # The CLI's rank (--data_parallel 1) under the tallies. This holds only
    # because hypernet_train.main imports parallel.launch when it is called;
    # should that change, the rank's launches go uncounted and the ups count
    # below falls short.
    parallel.launch = tallied_launch
    try:
        for n in (0, 1):
            wd = root / f"hnet_dp{n}"
            before = Counter(TALLY["arm_by_batch"])
            t0 = clock()
            if hypernet_train.main(common + ["--workdir", str(wd), "--data_parallel",
                                             str(n)]) != 0:
                raise AssertionError(f"hypernet_train --data_parallel {n} returned non-zero")
            wall = clock() - t0
            sizes_of(f"hypernet_train_dp{n}", before, HT_BATCH_SIZES)
            if n == 0:  # one device: its steps are CUDA graphs (see check_ups_launches)
                steps = trace.spans("train")[-1].attrs
                ups_replayed = ups_per_step * (steps["graph_replays"] - steps["graph_captures"])
            best = load_checkpoint(wd / f"samples_{MG_HT_SAMPLES}.pkl", device="cuda")
            m = {k: float(v) for k, v in evaluate_wholenet(net, best, eval_imgs, 1e-3).items()}
            dp[n] = {"wall_s": wall, "samples_per_s": MG_HT_SAMPLES / wall, "eval": m,
                     "checkpoints": sorted(p.name for p in wd.iterdir())}
    finally:
        parallel.launch = real_launch
    rel = abs(dp[1]["eval"]["loss"] - dp[0]["eval"]["loss"]) / dp[0]["eval"]["loss"]
    if not rel <= 1e-4 or dp[1]["checkpoints"] != dp[0]["checkpoints"]:
        raise AssertionError(f"--data_parallel 1 vs 0: eval loss {rel} apart, {dp}")

    # --- encode_simpler --budget debug on the main path's image.
    cool = root / "simpler_512x768.cool"
    before = Counter(TALLY["arm_by_batch"])
    t0 = clock()
    simple = encode_simpler.encode(encode_simpler._build_argparser().parse_args(
        ["-i", str(OUT_DIR / "synthetic_512x768.ppm"), "-o", str(cool), "--budget", "debug",
         "--device", "cuda"]))
    simple["seconds"] = clock() - t0
    sizes_of("encode_simpler", before, BATCH_SIZES)
    _, info = decode_bitstream(cool.read_bytes(), integer_pipeline=True, full_info=True)
    simple["real_latent_bpp"] = 8 * sum(info["frame_header"].n_bytes_per_latent) / (IMG_H * IMG_W)
    est = simple["rate_latent_bpp"]
    if not abs(simple["psnr_db"] - simple["psnr_db_estimate"]) < 0.1 or (
            est > 0.05 and abs(simple["real_latent_bpp"] - est) / est >= 0.2):
        raise AssertionError(f"encode_simpler's stream against its estimate: {simple}")

    # --- retrain_latents on frame 0 of the video path's checkpoint (a copy).
    ckpt = root / "video_encoder.pkl"
    shutil.copy(OUT_DIR / "video" / "video_encoder.pkl", ckpt)
    before = Counter(TALLY["arm_by_batch"])
    t0 = clock()
    retrained = retrain_latents.retrain(retrain_latents._build_argparser().parse_args(
        ["--checkpoint", str(ckpt), "--input",
         str(OUT_DIR / f"synthetic_{VIDEO_W}x{VIDEO_H}_420_8b.yuv"), "--init", "zeros",
         "--n_itr", str(MG_RETRAIN_ITR), "--device", "cuda"]))
    retrained["seconds"] = clock() - t0
    sizes_of("retrain_latents", before, VIDEO_BATCH_SIZES)
    if not retrained["loss_after"] < retrained["loss_before"]:
        raise AssertionError(f"retrain_latents did not lower the loss: {retrained}")

    # --- detailed_eval_metrics of the main path's trained decoder.
    before = Counter(TALLY["arm_by_batch"])
    target = torch.tensor(img, device="cuda")
    detailed = {k: v.item() for k, v in detailed_eval_metrics(
        run.result.params, cfg, target, 1e-3).items()}
    sizes_of("detailed_eval_metrics", before, BATCH_SIZES)
    # The sharded rank's launches, and the trainer's steps in this process
    # (--data_parallel 0) and in its rank (1).
    ups_more = ups_sharded + 2 * ups_per_step * max(MG_HT_SAMPLES // HT_BATCH, 1)
    check_ups_launches("the multi-GPU and tools path", ups_more, ups_replayed)
    m = eval_metrics(run.result.params, cfg, target, 1e-3)
    per_grid = sum(detailed[f"latent_{i}_bpp"] for i in range(cfg.latent_n_grids))
    for k in ("loss", "total_rate_bpp"):
        if abs(detailed[k] - getattr(m, k).item()) > 1e-6 * abs(getattr(m, k).item()):
            raise AssertionError(f"detailed_eval_metrics {k} {detailed[k]} vs {getattr(m, k)}")
    if abs(per_grid - detailed["rate_latent_bpp"]) > 1e-5 * detailed["rate_latent_bpp"]:
        raise AssertionError(f"per-grid rates sum to {per_grid}, not {detailed}")
    launches = arm_launches()

    emit({"phase": "multi_gpu_and_tools_path", "launches": launches,
          "arm_rate_launches_by_step_and_batch": seen, "sharded_encode": sharded,
          "data_parallel_train": dp, "encode_simpler": simple, "retrain_latents": retrained,
          "detailed_eval_metrics": detailed})
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a GPU",
              file=sys.stderr)
        return 1
    if not (REPO / "coolchic_tpu_torch").is_dir():
        print(f"chip_smoke: no coolchic_tpu_torch package beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))  # torch_kernel_checks.py

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    phase_seconds = {}

    def timed(name, fn, *args):
        start = time.perf_counter()
        result = fn(*args)
        phase_seconds[name] = time.perf_counter() - start
        return result

    timed("build", phase_build)
    pyramid = timed("kernel_checks", phase_kernel_checks)
    ups = timed("ups_wgrad", phase_ups_wgrad)
    install_launch_tallies()
    count_ups_training_steps()
    launches, run, cfg, img, cool, single_steps_per_s = timed("main_path", phase_main_path)
    timed("bitstream", phase_bitstream, run, cfg, img, cool)
    batch_launches = timed("batch_path", phase_batch_path, single_steps_per_s)
    video_launches = timed("video_path", phase_video_path)
    hypernet_launches = timed("hypernet_path", phase_hypernet_path, run.result.params)
    hypernet_train_launches = timed("hypernet_train_path", phase_hypernet_train_path)
    tools_launches = timed("multi_gpu_and_tools_path", phase_multi_gpu_and_tools_path, run, cfg,
                           img)
    emit({"kernels": [{
        "name": "arm_rate",
        "route": "cuda",
        "source": "coolchic_tpu_torch/csrc/arm_rate.cu",
        "replaces": "coolchic_tpu/ops/pallas_arm.py:86",
        "launches": (launches + batch_launches + video_launches + hypernet_launches
                     + hypernet_train_launches + tools_launches),
        "launches_main_path": launches,
        "launches_batch_path": batch_launches,
        "launches_video_path": video_launches,
        "launches_hypernet_path": hypernet_launches,
        "launches_hypernet_train_path": hypernet_train_launches,
        "launches_multi_gpu_and_tools_path": tools_launches,
        "max_abs_err": pyramid["max_abs_err"],
        "ms": pyramid["ms"],
        "plain_ms": pyramid["plain_ms"],
        "bound_ms": pyramid["bound_ms"],
        "bound_by": pyramid["bound_by"],
        "bound_f64_ms": pyramid["bound_f64_ms"],
        "bound_simt_ms": pyramid["bound_simt_ms"],
        "wrapper_ms": pyramid["wrapper_ms"],
        "ms_batch8": pyramid["ms_batch8"],
        "bound_batch8_ms": pyramid["bound_batch8_ms"],
        "ms_by_batch": pyramid["ms_by_batch"],
        "n_latents_1080p": pyramid["n_latents_1080p"],
        "ms_1080p_by_batch": pyramid["ms_1080p_by_batch"],
        "ms_256x256_by_batch": pyramid["ms_256x256_by_batch"],
        "bound_1080p_ms": pyramid["bound_1080p_ms"],
        "bound_f64_1080p_ms": pyramid["bound_f64_1080p_ms"],
        "library_ms": None,  # no single PyTorch call computes this function
    }, {
        "name": "ups_wgrad",
        "route": "cuda",
        "source": "coolchic_tpu_torch/csrc/ups_wgrad.cu",
        "replaces": None,  # cuDNN's grouped and ATen's depthwise weight gradients
        "launches": sum(p["launches"] for p in UPS_BY_PATH.values()),
        "launches_by_path": UPS_BY_PATH,
        "geometries_checked": len(UPS_CHECKED),
        "by_shape": ups,
    }], "seconds": time.perf_counter() - t0, "phase_seconds": phase_seconds})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
