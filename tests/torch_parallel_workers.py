"""What the ranks of ``tests/test_torch_parallel.py`` and of the card test
of the sharded encode run. Each function is given to
``coolchic_tpu_torch.parallel.launch``, which calls it in a process of its
own with ``mesh=``; it lives in this module, which imports torch and the
port only, so that a rank imports neither JAX nor the test file."""

import numpy as np
import torch
import torch.distributed as dist

from coolchic_tpu_torch.hypernet import NOWholeNet, WholeNetState, train_wholenet
from coolchic_tpu_torch.hypernet.training import state_leaves
from coolchic_tpu_torch.metalearning import synthetic_batches
from coolchic_tpu_torch.params import from_numpy_pytree, to_numpy_pytree, tree_map
from coolchic_tpu_torch.parallel import (
    batched_train_step,
    encode_batch_sharded,
    init_batch_opt_state,
    shard_leading_axis,
)


def gather_rows(tree, mesh):
    """Every rank's rows of a [B]-leading numpy tree, in rank order."""
    shards = [None] * mesh.world_size
    dist.all_gather_object(shards, tree, group=mesh.group)
    return tree_map(lambda *xs: np.concatenate(xs), *shards)


def train_step(params, targets, lmbdas, cfg, phase, mesh):
    """``batched_train_step`` on this rank's rows; every rank's new params
    gathered, the mean loss, and the rank's TF32 / cuDNN switches."""
    params, targets, lmbdas = shard_leading_axis((params, targets, lmbdas), mesh)
    opt = init_batch_opt_state(params, cfg, phase)
    params, _, loss = batched_train_step(params, opt, targets, lmbdas, None, cfg, phase, mesh)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    return gather_rows(to_numpy_pytree(params), mesh), float(loss), flags


def encodes(targets, lmbdas, cfg, presets, seeds, mesh):
    """``encode_batch_sharded`` with each preset: (params, loss, PSNR, rate,
    infos) of the whole batch, and whether every rank returned the same."""
    out = []
    for preset in presets:
        res, infos = encode_batch_sharded(targets, lmbdas, cfg, preset, seeds, mesh=mesh,
                                          with_quant_info=True)
        out.append((to_numpy_pytree(res.params), res.loss.numpy(), res.psnr_db.numpy(),
                    res.rate_latent_bpp.numpy(), infos))
    views = [None] * mesh.world_size
    dist.all_gather_object(views, [(o[1].tolist(), o[4]) for o in out], group=mesh.group)
    return out, all(v == views[0] for v in views)


def encode_counting_launches(*args, mesh, **kwargs):
    """``encode_batch_sharded`` and the ARM kernel's launches this rank made
    for it."""
    from coolchic_tpu_torch.ops import arm_rate

    count = arm_rate.launch_count
    out = encode_batch_sharded(*args, mesh=mesh, **kwargs)
    return out, arm_rate.launch_count - count


def train_no_wholenet(cfg, n_hidden, weights, phase, lmbda, batch, n_samples, data_seed,
                      eval_imgs, seed, workdir, ckpt_freq, mesh):
    """``train_wholenet`` of a NO whole net; (best state as numpy, logs, whether
    every rank's best state is the same)."""
    net = NOWholeNet(cfg, n_hidden_channels=n_hidden)
    state = WholeNetState({k: torch.tensor(v) for k, v in weights[0].items()},
                          from_numpy_pytree(weights[1], "cpu"))
    best, logs = train_wholenet(
        net, state, synthetic_batches(batch, cfg.img_size, seed=data_seed), eval_imgs,
        lmbda=lmbda, phase=phase, seed=seed, n_samples=n_samples, batch_size=batch,
        freq_valid_samples=2 * batch, verbose=False, workdir=workdir,
        checkpointing_freq_samples=ckpt_freq, mesh=mesh)
    leaves = [t.numpy() for t in state_leaves(best)]
    views = [None] * mesh.world_size
    dist.all_gather_object(views, leaves, group=mesh.group)
    same = all(all(np.array_equal(a, b) for a, b in zip(v, leaves)) for v in views)
    return ({k: v.numpy() for k, v in best.hypernet.items()}, to_numpy_pytree(best.decoder)), \
        logs, same
