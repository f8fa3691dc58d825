"""The Cool-chic frame decoder as a function of a parameter dict.

Counterpart of ``coolchic_tpu/models/coolchic.py``: quantize the gained
latents, measure their rate with the ARM, upsample, synthesize; for a P or B
frame, motion-compensate the reference frames with the synthesized flows.
In eval mode the rate comes from ``ops.arm_rate``, which launches the CUDA
kernel on a CUDA tensor (and runs the plain ARM on a CPU tensor); ``mu`` and
``log_scale`` are then None. In training mode the plain ARM of
``models/arm.py`` runs, since the backward needs it.

A batch of B decoders is the same parameter dict with a leading [B] axis on
every leaf (``params.stack_params``): the forward then runs all of them in
one pass, row b equal to the single forward on row b's parameters. The batch
axis is written out rather than vmapped: the eval rate is a ctypes kernel
launch that ``torch.func.vmap`` cannot trace, and with the axis explicit a
step issues as many device kernels for B decoders as for one (grouped
convolutions with ``groups = B``, batched matrix products in the ARM).

With ``valid_hw`` an image smaller than the buffer is encoded as if
unpadded (``models/masking.py``). The eval rate still goes through the
kernel: masked latents are exact zeros, so valid latents read the context
the unpadded encode's zero padding gives them, and the mask multiplies the
rate afterwards.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from coolchic_tpu_torch.models.arm import arm_rate_plain, init_arm_params
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.models.masking import level_valid_hw, valid_mask_2d
from coolchic_tpu_torch.models.quantizer import clip_like_jax, quantize
from coolchic_tpu_torch.models.synthesis import init_synthesis_params, synthesis_apply
from coolchic_tpu_torch.models.upsampling import init_upsampling_params, upsampling_apply
from coolchic_tpu_torch.ops.arm_rate import arm_rate_pyramid, arm_rate_pyramid_batch

Params = Dict[str, Any]


def init_coolchic_params(
    generator: torch.Generator, cfg: CoolChicConfig, device, latent_init: str = "zeros"
) -> Params:
    """Parameters of one frame. Latents start at zero, or at 1e-2 * N(0, 1)
    with ``latent_init="normal"``."""
    latents: List[torch.Tensor] = []
    for shape in cfg.latent_shapes:
        if latent_init == "zeros":
            latents.append(torch.zeros(shape, device=device))
        else:
            latents.append(1e-2 * torch.randn(shape, generator=generator, device=device))
    return {
        "latents": latents,
        "arm": init_arm_params(generator, cfg.dim_arm, cfg.n_hidden_layers_arm, device),
        "upsampling": init_upsampling_params(
            cfg.ups_k_size,
            cfg.ups_preconcat_k_size,
            n_ups_kernel=cfg.latent_n_grids - 1,
            n_ups_preconcat_kernel=cfg.latent_n_grids - 1,
            device=device,
        ),
        "synthesis": init_synthesis_params(
            generator, cfg.total_latent_channels, cfg.parsed_synthesis_layers(), device
        ),
    }


def coolchic_forward(
    params: Params,
    cfg: CoolChicConfig,
    quantizer_noise_type: str = "kumaraswamy",
    quantizer_type: str = "softround",
    soft_round_temperature: float = 0.3,
    noise_parameter: float = 1.0,
    ac_max_val: int = -1,
    training: bool = True,
    noise: Optional[Sequence[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    valid_hw: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
    """Cool-chic forward pass of one decoder, or of B decoders when every
    leaf of ``params`` has a leading [B] axis.

    Args:
        params: parameter dict (see the package docstring).
        cfg: static architecture.
        ac_max_val: if != -1, clamp y_hat to [-ac_max_val, ac_max_val + 1].
        training: False selects hardround with no noise and the ARM kernel.
        noise: optional raw noise draw per grid (see ``quantize``); else the
            noise is drawn with ``generator`` (one draw per grid, for the
            whole batch).
        valid_hw: integer tensor [2] (or [B, 2]) of the true (H, W): latents
            outside the valid pyramid are forced to zero and their rate
            masked out, and replicate-padded ops see the replicated valid
            edge. None: the whole buffer is the image.

    Returns:
        (raw_out [C_out, H, W], rate_bits [n_latents], extras) with extras
        ``mu`` / ``log_scale`` (None in eval mode) and ``flat_latent``; each
        with a leading [B] axis for a batch.
    """
    noise_type = quantizer_noise_type if training else "none"
    q_type = quantizer_type if training else "hardround"
    batched = params["latents"][0].dim() == 4

    y_hat: List[torch.Tensor] = []
    masks: List[torch.Tensor] = []
    for level, latent in enumerate(params["latents"]):
        q = quantize(
            latent * cfg.encoder_gain,
            noise_type,
            q_type,
            soft_round_temperature,
            noise_parameter,
            noise=None if noise is None else noise[level],
            generator=generator,
        )
        if ac_max_val != -1:
            q = torch.clamp(q, -ac_max_val, ac_max_val + 1)
        if level in cfg.frozen_zero_grids:
            q = q * 0.0
        if valid_hw is not None:
            mask = valid_mask_2d(q.shape[-2], q.shape[-1], *level_valid_hw(valid_hw, level))
            q = q * mask.unsqueeze(-3)
            masks.append(mask.unsqueeze(-3).expand(q.shape).flatten(-3))
        y_hat.append(q)

    flat_latent = torch.cat([y.flatten(-3) for y in y_hat], dim=-1)
    if training:
        rate, mu, log_scale = arm_rate_plain(y_hat, params["arm"], cfg.dim_arm)
    else:
        eval_rate = arm_rate_pyramid_batch if batched else arm_rate_pyramid
        rate = eval_rate(y_hat, params["arm"], cfg.dim_arm, cfg.n_hidden_layers_arm)
        mu = log_scale = None
    if valid_hw is not None:
        rate = rate * torch.cat(masks, dim=-1)

    dense = upsampling_apply(
        params["upsampling"], y_hat, cfg.ups_k_size, cfg.ups_preconcat_k_size, valid_hw
    )
    raw_out = synthesis_apply(
        params["synthesis"], dense, cfg.parsed_synthesis_layers(), valid_hw
    )
    extras = {"mu": mu, "log_scale": log_scale, "flat_latent": flat_latent}
    return raw_out, rate, extras


def coolchic_forward_latents(
    net_params: Params,
    latents: Sequence[torch.Tensor],
    cfg: CoolChicConfig,
    quantizer_noise_type: str = "kumaraswamy",
    quantizer_type: str = "softround",
    soft_round_temperature: float = 0.3,
    noise_parameter: float = 1.0,
    ac_max_val: int = -1,
    training: bool = True,
    noise: Optional[Sequence[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
    """``coolchic_forward`` with the latents given apart from the nets (the
    hypernet's predicted latents): [C, h, w] grids with unbatched nets, or
    [B, C, h, w] grids with every net leaf [B, ...] for B decoders."""
    params = dict(net_params)
    params["latents"] = list(latents)
    return coolchic_forward(
        params,
        cfg,
        quantizer_noise_type=quantizer_noise_type,
        quantizer_type=quantizer_type,
        soft_round_temperature=soft_round_temperature,
        noise_parameter=noise_parameter,
        ac_max_val=ac_max_val,
        training=training,
        noise=noise,
        generator=generator,
    )


def frame_forward(
    params: Params,
    cfg: CoolChicConfig,
    quantizer_noise_type: str = "kumaraswamy",
    quantizer_type: str = "softround",
    soft_round_temperature: float = 0.3,
    noise_parameter: float = 1.0,
    ac_max_val: int = -1,
    training: bool = True,
    bitdepth: int = 8,
    noise: Optional[Sequence[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    valid_hw: Optional[torch.Tensor] = None,
    refs: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
    """Frame forward: ``coolchic_forward``, then the decoded frame in [0, 1].

    I frame: the synthesis output, in eval mode rounded to ``2^bitdepth - 1``
    levels. P / B frame (``cfg.frame_type``): the synthesized flows and gains
    motion-compensate the reference frame(s) ``refs`` ([3, H, W] each, or
    [B, 3, H, W] for a batch). In training the float warp
    (``video/intercoding.py::inter_predict``); in eval the decoder's
    fixed-point warp on the 12-frac output and the stored references
    (``inter_levels``), so that the estimate is what the stream decodes to.
    Then a clip to [0, 1] with JAX's gradient at a tie.
    """
    raw_out, rate, extras = coolchic_forward(
        params,
        cfg,
        quantizer_noise_type=quantizer_noise_type,
        quantizer_type=quantizer_type,
        soft_round_temperature=soft_round_temperature,
        noise_parameter=noise_parameter,
        ac_max_val=ac_max_val,
        training=training,
        noise=noise,
        generator=generator,
        valid_hw=valid_hw,
    )
    max_dynamic = 2.0**bitdepth - 1.0
    if cfg.frame_type == "I":
        decoded = raw_out
        if not training:
            decoded = torch.round(decoded * max_dynamic) / max_dynamic
    else:
        # Imported here: the video package's encoder imports this module.
        from coolchic_tpu_torch.video.intercoding import inter_levels, inter_predict

        n_refs = 2 if cfg.frame_type == "B" else 1
        if refs is None or len(refs) < n_refs:
            raise ValueError(f"a {cfg.frame_type} frame forward needs {n_refs} reference frame(s)")
        batched = raw_out.dim() == 4
        raw = raw_out if batched else raw_out[None]
        ref0, ref1 = [(r if batched else r[None]) for r in refs[:n_refs]] + [None] * (2 - n_refs)
        if training:
            decoded = inter_predict(raw, ref0, ref1, cfg.flow_gain)
        else:
            levels = inter_levels(raw, ref0, ref1, cfg.flow_gain, bitdepth)
            # A true division: a CUDA division by a Python number multiplies
            # by its reciprocal, an ulp off on some levels.
            decoded = levels.to(raw.dtype) / torch.full((), max_dynamic, device=raw.device)
        decoded = decoded if batched else decoded[0]
    return clip_like_jax(decoded, 0.0, 1.0), rate, extras


def macs_per_pixel(cfg: CoolChicConfig) -> Dict[str, float]:
    """Analytic multiply-accumulate count per decoded pixel of the eval
    forward, as the decoder runs it (separable 1-D upsampling passes)."""
    h, w = cfg.img_size
    n_pix = h * w
    shapes = cfg.latent_shapes

    # ARM: per latent, n_hidden residual dim x dim products and the 2-wide head.
    n_latents = sum(c * hh * ww for c, hh, ww in shapes)
    arm_macs = n_latents * (cfg.n_hidden_layers_arm * cfg.dim_arm * cfg.dim_arm + cfg.dim_arm * 2)

    # Upsampling: each x2 step runs two polyphase 1-D passes of ups_k / 2
    # taps over every output pixel, plus the pre-concat filter's two 1-D
    # passes over the grid it joins.
    ups_macs = 0
    acc_px = shapes[-1][0] * shapes[-1][1] * shapes[-1][2]
    for i in range(len(shapes) - 2, -1, -1):
        c_i, h_i, w_i = shapes[i]
        up_px = 4 * acc_px
        ups_macs += up_px * cfg.ups_k_size
        ups_macs += (c_i * h_i * w_i) * 2 * cfg.ups_preconcat_k_size
        acc_px = up_px + c_i * h_i * w_i  # an odd size's crop is not subtracted
    # Synthesis: dense convolutions at full resolution.
    syn_macs = 0
    in_ft = cfg.total_latent_channels
    for out_ft, k_size, _res, _relu in cfg.parsed_synthesis_layers():
        syn_macs += n_pix * in_ft * out_ft * k_size * k_size
        in_ft = out_ft

    total = arm_macs + ups_macs + syn_macs
    return {
        "arm": arm_macs / n_pix,
        "upsampling": ups_macs / n_pix,
        "synthesis": syn_macs / n_pix,
        "total": total / n_pix,
    }
