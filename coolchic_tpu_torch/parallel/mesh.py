"""Several GPUs: an image-sharded batch encode and train step over
``torch.distributed``.

Counterpart of ``coolchic_tpu/parallel/mesh.py``. JAX runs one SPMD program
over a device mesh; the port runs one process per GPU (rank r on
``cuda:r``, NCCL), or per CPU worker (gloo), started by ``launch``. Each
rank owns the rows ``[r * B / W, (r + 1) * B / W)`` of a batch of B images
(``shard_leading_axis``), as JAX's sharding of the leading axis gives device
r. Per-image encodes are independent: a rank runs the one-device engine on
its rows, and the only collectives are the mean loss of
``batched_train_step`` (JAX's ``pmean``) and the gather of an encode's
results, so that every rank returns the whole batch in image order.
"""

from __future__ import annotations

import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.models.coolchic import init_coolchic_params
from coolchic_tpu_torch.params import from_numpy_pytree, stack_params, to_numpy_pytree, tree_map
from coolchic_tpu_torch.train.encode import EncodeResult, EncodeStats, encode_frame_batch
from coolchic_tpu_torch.train.presets import Preset, TrainerPhase
from coolchic_tpu_torch.train.step import AdamState, make_generator, train_step, trained_tensors
from coolchic_tpu_torch.utils.types import resolve_device

IMAGE_AXIS = "images"  # the JAX mesh axis's name: here, the ranks of the group


@dataclass(frozen=True)
class Mesh:
    """This process's place in the initialised process group."""

    rank: int
    world_size: int
    device: torch.device  # cuda:rank on NCCL, the CPU on gloo
    backend: str
    group: Any  # the process group of the collectives

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n``; raises unless ``n`` is a
        multiple of the world size."""
        if n % self.world_size:
            raise ValueError(f"a batch of {n} does not split over {self.world_size} ranks")
        per_rank = n // self.world_size
        return slice(self.rank * per_rank, (self.rank + 1) * per_rank)


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The ``Mesh`` of the process group ``launch`` initialised. Raises when
    no group is initialised (no fallback to one process or to the CPU), when
    ``n_devices`` is not the group's size, or when a NCCL group has more
    ranks than the GPUs of this machine."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("no process group is initialised: start the ranks with "
                           "coolchic_tpu_torch.parallel.launch")
    world, rank, backend = dist.get_world_size(), dist.get_rank(), dist.get_backend()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"asked for {n_devices} devices in a group of {world} ranks")
    if backend == "nccl":
        if world > torch.cuda.device_count():
            raise RuntimeError(f"{world} ranks but {torch.cuda.device_count()} GPUs")
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    return Mesh(rank, world, device, backend, dist.group.WORLD)


def _backend_flags() -> Dict[str, bool]:
    """The precision and determinism switches a rank takes from its caller."""
    return {"matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "cudnn_deterministic": torch.backends.cudnn.deterministic}


def _worker(rank: int, world_size: int, device_type: str, workdir: str, flags: Dict[str, bool],
            fn: Callable, args: tuple, kwargs: dict) -> None:
    torch.backends.cuda.matmul.allow_tf32 = flags["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = flags["cudnn_tf32"]
    torch.backends.cudnn.deterministic = flags["cudnn_deterministic"]
    device_id = None
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        backend, device_id = "nccl", torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)  # W processes share the cores
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"file://{workdir}/rendezvous", rank=rank,
                            world_size=world_size, device_id=device_id)
    try:
        result = fn(*args, **kwargs, mesh=make_mesh())
        if rank == 0:
            torch.save(result, Path(workdir) / "result.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world_size: int, device: str | torch.device, *args, **kwargs) -> Any:
    """Run ``fn(*args, **kwargs, mesh=make_mesh())`` on ``world_size`` ranks,
    each a process of its own (``torch.multiprocessing.spawn``, the spawn
    start method): NCCL with rank r on ``cuda:r`` for a CUDA ``device``, gloo on
    the CPU (one thread per rank) for ``"cpu"``. Each rank takes the caller's
    TF32 and cuDNN-determinism switches (``torch.backends``), so that it
    computes as the caller would. The ranks meet through a file in a
    temporary directory (no TCP port). Returns rank 0's result, its
    tensors on the CPU; every process has ended when it returns. ``fn`` and
    its arguments must pickle (``fn`` a module-level function)."""
    device = torch.device(device)
    if world_size < 1:
        raise ValueError(f"world_size must be at least 1, got {world_size}")
    if device.type == "cuda" and world_size > torch.cuda.device_count():
        raise RuntimeError(f"{world_size} ranks on cuda but {torch.cuda.device_count()} GPUs")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device}")
    with tempfile.TemporaryDirectory(prefix="coolchic_launch_") as workdir:
        torch.multiprocessing.spawn(
            _worker, args=(world_size, device.type, workdir, _backend_flags(), fn, args, kwargs),
            nprocs=world_size, join=True)
        return torch.load(Path(workdir) / "result.pt", map_location="cpu", weights_only=False)


def shard_leading_axis(tree: Any, mesh: Mesh) -> Any:
    """This rank's rows of every [B]-leading leaf (tensors or numpy arrays,
    in nested dicts / lists / tuples), as tensors on the rank's device.
    Raises unless B is a multiple of the world size."""
    return tree_map(lambda a: torch.as_tensor(a[mesh.rows(a.shape[0])]).to(mesh.device), tree)


def init_batch_params(seeds: Sequence[int], cfg: CoolChicConfig, batch: int,
                      latent_init: str = "zeros", device: str | torch.device = "cuda"):
    """[B]-stacked parameters, one decoder per image, image b from
    ``make_generator(device, seeds[b], 0)`` (the encoder's draw without a
    warm-up)."""
    if len(seeds) != batch:
        raise ValueError(f"{batch} images but {len(seeds)} seeds")
    device = resolve_device(device)
    return stack_params([init_coolchic_params(make_generator(device, s, 0), cfg, device,
                                              latent_init) for s in seeds])


def init_batch_opt_state(params_stack, cfg: CoolChicConfig, phase: TrainerPhase) -> AdamState:
    """Per-image Adam state (zero moments, a step count per image) of the
    leaves ``phase`` trains."""
    return AdamState.zeros(trained_tensors(params_stack, phase.optimized_module))


def batched_train_step(
    params_stack,
    opt_stack: AdamState,
    targets: torch.Tensor,
    lmbdas: torch.Tensor,
    generator: Optional[torch.Generator],
    cfg: CoolChicConfig,
    phase: TrainerPhase,
    mesh: Optional[Mesh] = None,
) -> Tuple[Any, AdamState, torch.Tensor]:
    """One gradient step of every decoder of the batch (``train/step.py::
    train_step`` at the phase's first learning rate, temperature and noise),
    in place. With a mesh, the arguments are this rank's rows
    (``shard_leading_axis``) and the returned loss is the mean over every
    rank's images: an all-reduce of the shard means over the world size, as
    JAX's ``pmean``, the step's one collective. Without, the one-process
    batch.

    Returns:
        (params, optimizer state, mean loss).
    """
    tensors = trained_tensors(params_stack, phase.optimized_module)
    for t in tensors:
        t.requires_grad_(True)
    try:
        losses = train_step(params_stack, tensors, opt_stack, targets, lmbdas, cfg, phase,
                            phase.lr, phase.softround_temperature[0], phase.noise_parameter[0],
                            generator)
    finally:
        for t in tensors:
            t.requires_grad_(False)
    mean = losses.mean()
    if mesh is not None:
        dist.all_reduce(mean, group=mesh.group)
        mean = mean / mesh.world_size
    return params_stack, opt_stack, mean


def _merge_stats(all_stats: List[EncodeStats]) -> EncodeStats:
    """Per-image counts summed over the ranks; the batched counts and stage
    seconds of the slowest rank."""
    merged = EncodeStats()
    merged.n_eval_forwards = sum(s.n_eval_forwards for s in all_stats)
    merged.n_train_steps = sum(s.n_train_steps for s in all_stats)
    merged.n_batched_eval_forwards = max(s.n_batched_eval_forwards for s in all_stats)
    merged.n_batched_steps = max(s.n_batched_steps for s in all_stats)
    merged.stage_seconds = {k: max(s.stage_seconds.get(k, 0.0) for s in all_stats)
                            for k in all_stats[0].stage_seconds}
    return merged


def encode_batch_sharded(
    targets,
    lmbdas,
    cfg: CoolChicConfig,
    preset: Preset,
    seeds: Sequence[int],
    mesh: Optional[Mesh] = None,
    with_quant_info: bool = False,
):
    """Overfit a batch of B images sharded over the ranks: each rank runs
    ``train/encode.py::encode_frame_batch`` (warm-up, every preset phase, the
    quantization search) on its rows, their lambdas and seeds, on its device;
    every eval forward of a rank is one kernel launch for its rows. The
    results are gathered (``all_gather_object`` of numpy), so that every rank
    returns the whole batch in image order. B must be a multiple of the world
    size. Without a mesh: ``encode_frame_batch`` of the whole batch.

    A rank's noise is drawn for its rows (one generator per phase from its
    own seeds), so the sharded encode equals, rank by rank,
    ``encode_frame_batch`` on that rank's rows; with a preset that draws no
    noise it also equals the one-process encode of the whole batch.

    Returns:
        EncodeResult (params stacked on the rank's device, [B] metrics on the
        host, stats merged over the ranks); with ``with_quant_info``,
        (EncodeResult, the B images' quantization infos).
    """
    if mesh is None:
        return encode_frame_batch(targets, lmbdas, cfg, preset, seeds,
                                  with_quant_info=with_quant_info)
    rows = mesh.rows(len(seeds))
    out = encode_frame_batch(torch.as_tensor(targets[rows]).to(mesh.device),
                             torch.as_tensor(lmbdas)[rows], cfg, preset, list(seeds[rows]),
                             with_quant_info=with_quant_info)
    res, infos = out if with_quant_info else (out, None)
    local = {"params": to_numpy_pytree(res.params), "loss": res.loss.numpy(),
             "psnr_db": res.psnr_db.numpy(), "rate_latent_bpp": res.rate_latent_bpp.numpy(),
             "stats": res.stats, "infos": infos}
    shards: List[Dict[str, Any]] = [None] * mesh.world_size
    dist.all_gather_object(shards, local, group=mesh.group)

    params = tree_map(lambda *xs: np.concatenate(xs), *[s["params"] for s in shards])
    metrics = [torch.from_numpy(np.concatenate([s[k] for s in shards]))
               for k in ("loss", "psnr_db", "rate_latent_bpp")]
    result = EncodeResult(from_numpy_pytree(params, mesh.device), *metrics,
                          _merge_stats([s["stats"] for s in shards]))
    if not with_quant_info:
        return result
    return result, (None if infos is None else [i for s in shards for i in s["infos"]])
