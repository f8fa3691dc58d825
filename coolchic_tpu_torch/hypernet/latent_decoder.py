"""LatentDecoder: the Cool-chic decoder driven by given latents and optional
per-layer weight deltas.

Counterpart of ``coolchic_tpu/hypernet/latent_decoder.py``. The decoder's
nets and the latents are plain arguments (parameter dicts of tensors), so
the decoder reduces to (1) the rule that adds one delta per layer, to the
weights or, in the bias-only mode, to the biases, and (2) ``as_coolchic``,
which folds nets, deltas and latents into a standard per-image parameter
dict (detached).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.models.coolchic import coolchic_forward_latents
from coolchic_tpu_torch.params import tree_map

Params = Dict[str, Any]


def apply_layer_deltas(
    module_params: Dict[str, Any],
    deltas: Optional[Sequence[torch.Tensor]],
    bias_only: bool = False,
) -> Dict[str, Any]:
    """Add one delta per layer to a ``{"layers": [{"weight", "bias"}, ...]}``
    module; ``bias_only`` adds them to the biases (the COIN++-style mode)."""
    if deltas is None:
        return module_params
    layers = module_params["layers"]
    if len(deltas) != len(layers):
        raise ValueError(f"need {len(layers)} deltas, got {len(deltas)}")
    key = "bias" if bias_only else "weight"
    new_layers = [
        {**layer, key: layer[key] + torch.reshape(d, layer[key].shape)}
        for layer, d in zip(layers, deltas)
    ]
    return {**module_params, "layers": new_layers}


class LatentDecoder:
    """Decoder as a function of (nets, latents, deltas); ``only_delta_biases``
    selects the bias-only delta rule for both the ARM and the synthesis."""

    def __init__(self, cfg: CoolChicConfig, only_delta_biases: bool = False):
        self.cfg = cfg
        self.only_delta_biases = only_delta_biases

    def _with_deltas(
        self,
        nets: Params,
        synth_delta: Optional[Sequence[torch.Tensor]],
        arm_delta: Optional[Sequence[torch.Tensor]],
    ) -> Params:
        nets = dict(nets)
        if synth_delta is not None:
            nets["synthesis"] = apply_layer_deltas(
                nets["synthesis"], synth_delta, self.only_delta_biases)
        if arm_delta is not None:
            nets["arm"] = apply_layer_deltas(nets["arm"], arm_delta, self.only_delta_biases)
        return nets

    def forward(
        self,
        nets: Params,
        latents: List[torch.Tensor],
        synth_delta: Optional[Sequence[torch.Tensor]] = None,
        arm_delta: Optional[Sequence[torch.Tensor]] = None,
        quantizer_noise_type: str = "kumaraswamy",
        quantizer_type: str = "softround",
        soft_round_temperature: float = 0.3,
        noise_parameter: float = 1.0,
        training: bool = True,
        noise: Optional[Sequence[torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """The decoder on given latents ([C, h_i, w_i] each) with the deltas
        added at run time. Returns (decoded, rate, extras)."""
        return coolchic_forward_latents(
            self._with_deltas(nets, synth_delta, arm_delta),
            latents,
            self.cfg,
            quantizer_noise_type=quantizer_noise_type,
            quantizer_type=quantizer_type,
            soft_round_temperature=soft_round_temperature,
            noise_parameter=noise_parameter,
            training=training,
            noise=noise,
            generator=generator,
        )

    def as_coolchic(
        self,
        nets: Params,
        latents: List[torch.Tensor],
        synth_delta: Optional[Sequence[torch.Tensor]] = None,
        arm_delta: Optional[Sequence[torch.Tensor]] = None,
        stop_grads: bool = True,
    ) -> Params:
        """Nets, deltas and latents folded into a per-image parameter dict for
        ``coolchic_forward`` and the training loop, detached. The latents are
        stored unchanged: both forwards apply ``encoder_gain`` at use time,
        so ``coolchic_forward(as_coolchic(...))`` equals ``forward(...)``."""
        if not stop_grads:
            raise ValueError("only the stop_grads=True path is defined")
        params = dict(self._with_deltas(nets, synth_delta, arm_delta))
        params["latents"] = list(latents)
        return tree_map(lambda t: t.detach(), params)
