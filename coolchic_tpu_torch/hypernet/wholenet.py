"""Whole-net amortized encoders: NO (shared decoder) and Delta variants.

Counterpart of ``coolchic_tpu/hypernet/wholenet.py``. The amortized path
predicts Cool-chic latents, and optionally per-image weight deltas to a
shared decoder, in one forward pass.

Where the JAX package decodes the B images of a batch as one ``jax.vmap``
over (latents, base + delta), the port builds the B decoders as one
parameter dict with a leading [B] axis (base + delta, or the shared decoder
``expand``ed to the batch, a view but for the ARM's few KB that the kernel
reads laid out per image) and runs ``coolchic_forward`` once:
an eval forward of B decoders is one launch of the ARM-rate kernel
(``ops/arm_rate.py::arm_rate_pyramid_batch``), each image with its own ARM.

The hypernet's weights are a state dict of the net's module (torch layouts,
flax's names: ``hypernet/bridge.py``); the module itself lives on the meta
device and runs through ``torch.func.functional_call``. The noise of a
training-mode forward is drawn from a ``torch.Generator`` (one draw per
grid for the whole batch) or given as ``noise``, as in ``coolchic_forward``.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.func import functional_call

from coolchic_tpu_torch.hypernet.blocks import LatentHyperNet, init_params
from coolchic_tpu_torch.hypernet.heads import CoolchicHyperNet, SmallCoolchicHyperNet
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.models.coolchic import coolchic_forward_latents, init_coolchic_params
from coolchic_tpu_torch.params import tree_map
from coolchic_tpu_torch.train.quantize_model import _combine_nets
from coolchic_tpu_torch.train.step import make_generator
from coolchic_tpu_torch.utils.types import resolve_device

Params = Dict[str, Any]


def _nets_only(params: Params) -> Params:
    return {k: v for k, v in params.items() if k != "latents"}


def _contiguous_arm(nets: Params) -> Params:
    """The ARM kernel reads image b's weights at b times a stride, so a
    batch's ARM weights are copied (a few KB) where they are views: the
    shared decoder expanded to the batch, or slices of a head's output."""
    return {**nets, "arm": tree_map(torch.Tensor.contiguous, nets["arm"])}


class WholeNetState(NamedTuple):
    """Trainable state of an amortized encoder."""

    hypernet: Dict[str, torch.Tensor]  # state dict of the encoder (+ heads for Delta)
    decoder: Params  # shared decoder networks (arm / upsampling / synthesis)


class _WholeNet:
    """What the three variants share: the module on the meta device and the
    seeded init."""

    cfg: CoolChicConfig
    module: torch.nn.Module

    def init(self, seed: int = 0, device: str | torch.device = "cuda") -> WholeNetState:
        """Weights drawn with flax's initializers (hypernet) and the
        decoder's own init, from two generators seeded with ``seed``."""
        device = resolve_device(device)
        hypernet = init_params(self.module, make_generator(device, seed, 0), device)
        decoder = _nets_only(init_coolchic_params(make_generator(device, seed, 1), self.cfg, device))
        return WholeNetState(hypernet=hypernet, decoder=decoder)

    def _apply(self, state: WholeNetState, img: torch.Tensor):
        return functional_call(self.module, state.hypernet, (img,))


class NOWholeNet(_WholeNet):
    """Latent encoder + shared decoder, no per-image weights."""

    def __init__(self, cfg: CoolChicConfig, n_hidden_channels: int = 64):
        self.cfg = cfg
        with torch.device("meta"):
            self.module = LatentHyperNet(cfg.latent_n_grids, n_hidden_channels)

    def predict_latents(self, state: WholeNetState, img: torch.Tensor) -> List[torch.Tensor]:
        """img [B, 3, H, W] -> list of [B, 1, h_i, w_i] latent grids."""
        return self._apply(state, img)

    def forward(
        self,
        state: WholeNetState,
        img: torch.Tensor,
        quantizer_noise_type: str = "gaussian",
        quantizer_type: str = "softround",
        soft_round_temperature: float = 0.3,
        noise_parameter: float = 0.25,
        training: bool = True,
        noise: Optional[Sequence[torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (decoded [B, 3, H, W], rate [B, n_latents]); the shared
        decoder is given to the batch as an expanded view (its ARM copied)."""
        latents = self.predict_latents(state, img)
        batch = img.shape[0]
        nets = _contiguous_arm(tree_map(lambda t: t.expand(batch, *t.shape), state.decoder))
        return coolchic_forward_latents(
            nets, latents, self.cfg, quantizer_noise_type=quantizer_noise_type,
            quantizer_type=quantizer_type, soft_round_temperature=soft_round_temperature,
            noise_parameter=noise_parameter, training=training, noise=noise,
            generator=generator)[:2]

    def image_to_coolchic(self, state: WholeNetState, img: torch.Tensor) -> Params:
        """A standard per-image parameter dict (for finetuning or the
        bitstream) from one [3, H, W] image. The predicted latents are in the
        stored (pre-gain) convention already."""
        latents = self.predict_latents(state, img[None])
        params = dict(state.decoder)
        params["latents"] = [y[0].detach() for y in latents]
        return params


class DeltaWholeNet(_WholeNet):
    """Hypernet predicting latents + weight deltas to a shared decoder.

    ``mode="full"``: the heads predict the decoder weights outright (no zero
    output init, no shared base added)."""

    def __init__(
        self,
        cfg: CoolChicConfig,
        backbone_arch: str = "resnet18",
        mode: str = "delta",
        **hn_kwargs,
    ):
        if mode not in ("delta", "full"):
            raise ValueError(f"mode must be 'delta' or 'full', found {mode}")
        self.cfg = cfg
        self.mode = mode
        with torch.device("meta"):
            self.module = CoolchicHyperNet(
                cfg, backbone_arch=backbone_arch, deltas=(mode == "delta"), **hn_kwargs)
        self.use_delta = True

    def predict(self, state: WholeNetState, img: torch.Tensor):
        """img [B, 3, H, W] -> (latents, list of [B, 1, h_i, w_i]; deltas,
        {"synthesis", "arm", "upsampling"} with a leading [B] axis)."""
        latents, syn_d, arm_d, ups_d = self._apply(state, img)
        return latents, {"synthesis": syn_d, "arm": arm_d, "upsampling": ups_d}

    def _nets(self, state: WholeNetState, deltas: Params) -> Params:
        if self.mode == "full":  # the predicted weights are the decoder
            return _contiguous_arm({m: deltas[m] for m in state.decoder})
        return _combine_nets(state.decoder, deltas)

    def forward(
        self,
        state: WholeNetState,
        img: torch.Tensor,
        quantizer_noise_type: str = "gaussian",
        quantizer_type: str = "softround",
        soft_round_temperature: float = 0.3,
        noise_parameter: float = 0.25,
        training: bool = True,
        noise: Optional[Sequence[torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched forward: every image decodes through base + its own delta,
        all B in one decoder forward. Returns (decoded [B, 3, H, W], rate
        [B, n_latents])."""
        latents, deltas = self.predict(state, img)
        if not self.use_delta:
            deltas = tree_map(lambda d: d * 0.0, deltas)
        return coolchic_forward_latents(
            self._nets(state, deltas), latents, self.cfg,
            quantizer_noise_type=quantizer_noise_type, quantizer_type=quantizer_type,
            soft_round_temperature=soft_round_temperature, noise_parameter=noise_parameter,
            training=training, noise=noise, generator=generator)[:2]

    def image_to_coolchic(self, state: WholeNetState, img: torch.Tensor) -> Params:
        """Per-image params (base + delta, predicted latents) of one
        [3, H, W] image, for finetuning or the bitstream."""
        latents, deltas = self.predict(state, img[None])
        params = self._nets(state, tree_map(lambda d: d[0], deltas))
        params["latents"] = [y[0].detach() for y in latents]
        return params

    def load_from_no_coolchic(
        self, no_state: WholeNetState, delta_state: WholeNetState
    ) -> WholeNetState:
        """Start from a trained NOWholeNet: its latent encoder and shared
        decoder; the delta heads already start at zero output."""
        prefix = "LatentHyperNet_0."
        hypernet = {k: v for k, v in delta_state.hypernet.items() if not k.startswith(prefix)}
        hypernet.update({prefix + k: v for k, v in no_state.hypernet.items()})
        return WholeNetState(hypernet=hypernet, decoder=no_state.decoder)


class SmallDeltaWholeNet(DeltaWholeNet):
    """Delta wholenet with the compact conv hypernet: no ResNet backbone, no
    upsampling deltas."""

    def __init__(self, cfg: CoolChicConfig, mode: str = "delta", **hn_kwargs):
        if mode != "delta":
            raise ValueError("the small hypernet is a delta-only variant")
        self.cfg = cfg
        self.mode = mode
        with torch.device("meta"):
            self.module = SmallCoolchicHyperNet(cfg, **hn_kwargs)
        self.use_delta = True
