"""Hypernet training CLI, the counterpart of ``coolchic_tpu/hypernet_train.py``
(the NO, delta and small whole nets behind ``--mode``).

Usage:
    python -m coolchic_tpu_torch.hypernet_train --config=hnet.yaml --mode=no
    python -m coolchic_tpu_torch.hypernet_train --config=... --mode=delta \\
        --init_from=workdir_no/   # NO -> Delta initialization
    python -m coolchic_tpu_torch.hypernet_train --synthetic ...  # no data set needed

Runs on the GPU unless given ``--device cpu``. Checkpoints are
``<workdir>/samples_N.pkl`` in the JAX package's format; the last one,
``samples_{n_samples}.pkl``, holds the best state. ``--data_parallel N``
trains on N ranks (``parallel.launch``: one process per GPU over NCCL, or N
CPU processes over gloo with ``--device cpu``), each on its rows of every
batch, with the semantics of the one-device run
(``hypernet/training.py``); rank 0 writes the checkpoints.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="coolchic_tpu_torch hypernet trainer")
    p.add_argument("--config", type=Path, default=None, help="HypernetRunConfig YAML")
    p.add_argument("--mode", choices=["no", "delta", "small"], default="no")
    p.add_argument("--data_dir", type=Path, default=None)
    p.add_argument("--synthetic", action="store_true", help="use synthetic patches")
    p.add_argument("--workdir", type=Path, default=Path("hnet_workdir"))
    p.add_argument("--init_from", type=Path, default=None, help="NO checkpoint for delta init")
    p.add_argument(
        "--resume", action="store_true",
        help="continue from the latest samples_N.pkl in --workdir on the "
        "global schedule clock",
    )
    p.add_argument("--n_samples", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--lmbda", type=float, default=None)
    p.add_argument("--patch_size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--disable_wandb", action="store_true")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="gradient accumulation micro-batches")
    p.add_argument(
        "--data_parallel", type=int, default=0,
        help="shard batches over this many devices (0 = single device)",
    )
    p.add_argument(
        "--checkpointing_freq", type=int, default=None,
        help="write samples_N.pkl every N samples",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if not args.data_parallel:
        return _train(args)

    from coolchic_tpu_torch.parallel import launch
    from coolchic_tpu_torch.utils.types import HypernetRunConfig, load_config

    batch_size = args.batch_size or (
        load_config(args.config, HypernetRunConfig).batch_size if args.config else 8)
    if batch_size % args.data_parallel:
        raise ValueError(f"--data_parallel {args.data_parallel} does not divide the batch "
                         f"size {batch_size}")
    return launch(_train, args.data_parallel, args.device, args)


def _train(args: argparse.Namespace, mesh=None) -> int:
    """The trainer's run on one device, or on this rank's of ``mesh``."""
    import numpy as np
    import torch

    from coolchic_tpu_torch.hypernet import (
        DeltaWholeNet,
        NOWholeNet,
        SmallDeltaWholeNet,
        train_wholenet,
    )
    from coolchic_tpu_torch.hypernet.inference import (
        load_checkpoint, load_checkpoint_meta, save_checkpoint,
    )
    from coolchic_tpu_torch.metalearning import PatchDataset, synthetic_batches, train_test_split
    from coolchic_tpu_torch.train.presets import TrainerPhase
    from coolchic_tpu_torch.utils import logging as cclog
    from coolchic_tpu_torch.utils.types import (
        DecoderConfig, HypernetRunConfig, load_config, resolve_device,
    )

    device = resolve_device(args.device) if mesh is None else mesh.device
    lead = mesh is None or mesh.rank == 0
    if args.config is not None:
        run_cfg = load_config(args.config, HypernetRunConfig)
        patch = run_cfg.hypernet_cfg.patch_size
        cfg = run_cfg.hypernet_cfg.dec_cfg.to_coolchic_config(patch)
        n_samples = args.n_samples or run_cfg.n_samples
        batch_size = args.batch_size or run_cfg.batch_size
        lmbda = args.lmbda or run_cfg.lmbda
        phase = run_cfg.recipe.all_phases[0]
        n_hidden = run_cfg.hypernet_cfg.n_hidden_channels
        backbone = run_cfg.hypernet_cfg.backbone_arch
        unfreeze = run_cfg.unfreeze_backbone
        workdir = Path(run_cfg.workdir or args.workdir)
        # As in JAX, only the heads' only_biases reaches the nets, not their widths.
        hn_kwargs = dict(
            only_biases_arm=run_cfg.hypernet_cfg.arm.only_biases,
            only_biases_synthesis=run_cfg.hypernet_cfg.synthesis.only_biases,
        )
        dbl = run_cfg.hypernet_cfg.double_backbone
    else:
        patch = (args.patch_size, args.patch_size)
        cfg = DecoderConfig().to_coolchic_config(patch)
        n_samples = args.n_samples or 10_000
        batch_size = args.batch_size or 8
        lmbda = args.lmbda or 1e-3
        phase = TrainerPhase(
            lr=1e-4,
            max_itr=1,
            schedule_lr=True,
            quantizer_type="softround",
            quantizer_noise_type="gaussian",
            softround_temperature=(0.3, 0.3),
            noise_parameter=(0.25, 0.25),
        )
        n_hidden, backbone, unfreeze = 64, "resnet18", 0
        workdir = args.workdir
        hn_kwargs = {}
        dbl = False

    if args.mode == "no":
        net = NOWholeNet(cfg, n_hidden_channels=n_hidden)
        state = net.init(args.seed, device=device)
    elif args.mode == "small":
        net = SmallDeltaWholeNet(cfg, n_hidden_channels=n_hidden, **hn_kwargs)
        state = net.init(args.seed, device=device)
    else:
        net = DeltaWholeNet(
            cfg, backbone_arch=backbone, n_hidden_channels=n_hidden,
            double_backbone=dbl, **hn_kwargs,
        )
        state = net.init(args.seed, device=device)
        if args.init_from is not None and not args.resume:
            no_state = load_checkpoint(args.init_from, device=device)
            state = net.load_from_no_coolchic(no_state, state)
            if lead:
                print(f"initialized from NO checkpoint {args.init_from}")

    samples_offset = 0
    if args.resume:
        state, samples_offset = load_checkpoint_meta(Path(workdir), device=device)
        if lead:
            print(f"resumed from {workdir} at {samples_offset} samples")
        if samples_offset >= n_samples:
            if lead:
                print("nothing left to train")
            return 0

    if args.synthetic or args.data_dir is None:
        data = synthetic_batches(batch_size, patch, seed=args.seed)
        eval_imgs = next(synthetic_batches(batch_size, patch, seed=999))
    else:
        ds = PatchDataset.from_dir(args.data_dir, patch, seed=args.seed)
        train_paths, test_paths = train_test_split(ds.paths)
        train_ds = PatchDataset(train_paths, patch, args.seed)
        test_ds = PatchDataset(test_paths or train_paths, patch, args.seed)
        data = train_ds.batches(batch_size)
        eval_imgs = [test_ds[i] for i in range(min(8, len(test_ds)))]
    eval_imgs = torch.tensor(np.asarray(eval_imgs), device=device)

    cclog.init(
        config={
            "mode": args.mode,
            "n_samples": n_samples,
            "batch_size": batch_size,
            "lmbda": lmbda,
            "backbone": backbone,
        },
        disable=args.disable_wandb or not lead,
    )
    best, _ = train_wholenet(
        net,
        state,
        data,
        eval_imgs,
        lmbda=lmbda,
        phase=phase,
        seed=args.seed + 1,
        n_samples=n_samples,
        batch_size=batch_size,
        unfreeze_backbone_samples=unfreeze,
        workdir=workdir,
        checkpointing_freq_samples=args.checkpointing_freq,
        grad_accumulation_steps=args.grad_accum,
        samples_offset=samples_offset,
        mesh=mesh,
    )
    cclog.finish()
    if lead:
        save_checkpoint(best, workdir / f"samples_{n_samples}.pkl", n_samples)
        print(f"saved {workdir / f'samples_{n_samples}.pkl'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
