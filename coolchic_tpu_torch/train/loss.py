"""Rate-distortion loss: MSE + lmbda * (R_latent + R_nn) / n_pixels.

Counterpart of ``coolchic_tpu/train/loss.py``, for one frame or a batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from coolchic_tpu_torch.models.masking import valid_mask_2d


class LossOutput(NamedTuple):
    loss: torch.Tensor
    mse: torch.Tensor
    psnr_db: torch.Tensor
    rate_latent_bpp: torch.Tensor
    rate_nn_bpp: torch.Tensor
    total_rate_bpp: torch.Tensor


def _mean_hw(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x, dim=(-2, -1))


def yuv420_mse(decoded_444: torch.Tensor, target_444: torch.Tensor) -> torch.Tensor:
    """(4 MSE_y + MSE_u + MSE_v) / 6, chroma on the 2x2-subsampled grid."""
    d, t = decoded_444, target_444
    mse_y = _mean_hw((d[..., 0, :, :] - t[..., 0, :, :]) ** 2)
    mse_u = _mean_hw((d[..., 1, ::2, ::2] - t[..., 1, ::2, ::2]) ** 2)
    mse_v = _mean_hw((d[..., 2, ::2, ::2] - t[..., 2, ::2, ::2]) ** 2)
    return (4.0 * mse_y + mse_u + mse_v) / 6.0


def masked_mse(
    decoded: torch.Tensor, target: torch.Tensor, valid_hw: torch.Tensor, frame_data_type: str
) -> torch.Tensor:
    """MSE over the valid (hv, wv) region only. 4:2:0 frames have even true
    dims, so the even-index subsample of the luma mask has exactly
    ceil(hv / 2) * ceil(wv / 2) ones."""
    hv, wv = valid_hw[..., 0], valid_hw[..., 1]
    m = valid_mask_2d(decoded.shape[-2], decoded.shape[-1], hv, wv, decoded.dtype)
    n_pixels = (hv * wv).to(decoded.dtype)
    if frame_data_type != "yuv420":
        err = ((decoded - target) * m.unsqueeze(-3)) ** 2
        return torch.sum(err, dim=(-3, -2, -1)) / (decoded.shape[-3] * n_pixels)
    mc = m[..., ::2, ::2]
    n_c = (((hv + 1) // 2) * ((wv + 1) // 2)).to(decoded.dtype)
    d, t = decoded, target
    mse_y = torch.sum(((d[..., 0, :, :] - t[..., 0, :, :]) * m) ** 2, dim=(-2, -1)) / n_pixels
    mse_u = torch.sum(((d[..., 1, ::2, ::2] - t[..., 1, ::2, ::2]) * mc) ** 2, dim=(-2, -1)) / n_c
    mse_v = torch.sum(((d[..., 2, ::2, ::2] - t[..., 2, ::2, ::2]) * mc) ** 2, dim=(-2, -1)) / n_c
    return (4.0 * mse_y + mse_u + mse_v) / 6.0


def loss_function(
    decoded: torch.Tensor,
    rate_bits: torch.Tensor,
    target: torch.Tensor,
    lmbda: float | torch.Tensor,
    rate_nn_bits: float | torch.Tensor = 0.0,
    frame_data_type: str = "rgb",
    valid_hw: Optional[torch.Tensor] = None,
) -> LossOutput:
    """RD loss of one frame ([C, H, W] images, [n_latents] rate: scalar
    outputs) or of a batch ([B, C, H, W], [B, n_latents], ``lmbda`` and
    ``rate_nn_bits`` a number or [B]: outputs [B]); ``rate_nn_bits`` carries
    no gradient. With ``valid_hw`` ([2] or [B, 2]) the MSE and the bpp are
    taken over the valid region only (the forward already masks the rate of
    padded latents, ``models/masking.py``)."""
    if valid_hw is not None:
        mse = masked_mse(decoded, target, valid_hw, frame_data_type)
        n_pixels = (valid_hw[..., 0] * valid_hw[..., 1]).to(decoded.dtype)
    else:
        if frame_data_type == "yuv420":
            mse = yuv420_mse(decoded, target)
        else:
            mse = torch.mean((decoded - target) ** 2, dim=(-3, -2, -1))
        n_pixels = decoded.shape[-2] * decoded.shape[-1]
    rate_latent_bits = torch.sum(rate_bits, dim=-1)
    rate_bpp = (rate_latent_bits + rate_nn_bits) / n_pixels
    loss = mse + lmbda * rate_bpp
    psnr_db = -10.0 * torch.log10(mse + 1e-10)
    if isinstance(rate_nn_bits, (int, float)):  # a fill on the device, not a copy from the host
        rate_nn = mse.new_full((), float(rate_nn_bits))
    else:
        rate_nn = torch.as_tensor(rate_nn_bits, dtype=mse.dtype, device=mse.device)
    rate_nn_bpp = rate_nn / n_pixels
    return LossOutput(
        loss=loss,
        mse=mse,
        psnr_db=psnr_db,
        rate_latent_bpp=rate_latent_bits / n_pixels,
        rate_nn_bpp=rate_nn_bpp,
        total_rate_bpp=rate_bpp,
    )
