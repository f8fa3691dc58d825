"""Training data of the amortized encoder. Counterpart of
``coolchic_tpu/metalearning/``."""

from coolchic_tpu_torch.metalearning.data import (
    N_MAX_TEST,
    PatchDataset,
    random_patch,
    synthetic_batches,
    train_test_split,
)

__all__ = ["N_MAX_TEST", "PatchDataset", "random_patch", "synthetic_batches", "train_test_split"]
