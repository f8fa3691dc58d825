"""The amortized encoder (hypernet): one forward predicts an image's latents
and per-image weight deltas to a shared Cool-chic decoder; its training loop
in ``training.py``. Counterpart of ``coolchic_tpu/hypernet/`` with the same
exports."""

from coolchic_tpu_torch.hypernet.backbone import get_backbone
from coolchic_tpu_torch.hypernet.blocks import LatentHyperNet
from coolchic_tpu_torch.hypernet.heads import CoolchicHyperNet
from coolchic_tpu_torch.hypernet.latent_decoder import LatentDecoder, apply_layer_deltas
from coolchic_tpu_torch.hypernet.training import (
    evaluate_wholenet,
    make_wholenet_train_step,
    train_wholenet,
)
from coolchic_tpu_torch.hypernet.wholenet import (
    DeltaWholeNet,
    NOWholeNet,
    SmallDeltaWholeNet,
    WholeNetState,
)

__all__ = [
    "get_backbone",
    "LatentHyperNet",
    "CoolchicHyperNet",
    "LatentDecoder",
    "apply_layer_deltas",
    "evaluate_wholenet",
    "make_wholenet_train_step",
    "train_wholenet",
    "DeltaWholeNet",
    "NOWholeNet",
    "SmallDeltaWholeNet",
    "WholeNetState",
]
