"""The program's decoder configuration, built from a configuration file."""

from __future__ import annotations

from typing import Dict

from coolchic_tpu_torch.models.config import CoolChicConfig


def decoder_config(config: Dict, height: int, width: int) -> CoolChicConfig:
    """The ``CoolChicConfig`` of the file's decoder widths at ``height`` x ``width``."""
    return CoolChicConfig(
        img_size=(height, width), layers_synthesis=tuple(config["layers_synthesis"]),
        n_ft_per_res=tuple(config["n_ft_per_res"]), dim_arm=config["dim_arm"],
        n_hidden_layers_arm=config["n_hidden_layers_arm"], encoder_gain=config["encoder_gain"],
        ups_k_size=config["ups_k_size"], ups_preconcat_k_size=config["ups_preconcat_k_size"])
