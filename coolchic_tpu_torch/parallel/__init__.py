"""Several GPUs over ``torch.distributed``: one process per GPU, a batch of
images sharded over them. Counterpart of ``coolchic_tpu/parallel/``."""

from coolchic_tpu_torch.parallel.mesh import (
    IMAGE_AXIS,
    Mesh,
    batched_train_step,
    encode_batch_sharded,
    init_batch_opt_state,
    init_batch_params,
    launch,
    make_mesh,
    shard_leading_axis,
)

__all__ = [
    "IMAGE_AXIS",
    "Mesh",
    "batched_train_step",
    "encode_batch_sharded",
    "init_batch_opt_state",
    "init_batch_params",
    "launch",
    "make_mesh",
    "shard_leading_axis",
]
