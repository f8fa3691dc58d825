"""Rate-distortion loss: MSE + lmbda * (R_latent + R_nn) / n_pixels.

Counterpart of ``coolchic_tpu/train/loss.py`` (without mixed-size masking).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LossOutput(NamedTuple):
    loss: torch.Tensor
    mse: torch.Tensor
    psnr_db: torch.Tensor
    rate_latent_bpp: torch.Tensor
    rate_nn_bpp: torch.Tensor
    total_rate_bpp: torch.Tensor


def yuv420_mse(decoded_444: torch.Tensor, target_444: torch.Tensor) -> torch.Tensor:
    """(4 MSE_y + MSE_u + MSE_v) / 6, chroma on the 2x2-subsampled grid."""
    mse_y = torch.mean((decoded_444[0] - target_444[0]) ** 2)
    mse_u = torch.mean((decoded_444[1, ::2, ::2] - target_444[1, ::2, ::2]) ** 2)
    mse_v = torch.mean((decoded_444[2, ::2, ::2] - target_444[2, ::2, ::2]) ** 2)
    return (4.0 * mse_y + mse_u + mse_v) / 6.0


def loss_function(
    decoded: torch.Tensor,
    rate_bits: torch.Tensor,
    target: torch.Tensor,
    lmbda: float,
    rate_nn_bits: float | torch.Tensor = 0.0,
    frame_data_type: str = "rgb",
) -> LossOutput:
    """RD loss of one frame; ``rate_nn_bits`` carries no gradient."""
    if frame_data_type == "yuv420":
        mse = yuv420_mse(decoded, target)
    else:
        mse = torch.mean((decoded - target) ** 2)
    n_pixels = decoded.shape[-2] * decoded.shape[-1]
    rate_latent_bits = torch.sum(rate_bits)
    rate_bpp = (rate_latent_bits + rate_nn_bits) / n_pixels
    loss = mse + lmbda * rate_bpp
    psnr_db = -10.0 * torch.log10(mse + 1e-10)
    rate_nn_bpp = torch.as_tensor(rate_nn_bits, dtype=mse.dtype, device=mse.device) / n_pixels
    return LossOutput(
        loss=loss,
        mse=mse,
        psnr_db=psnr_db,
        rate_latent_bpp=rate_latent_bits / n_pixels,
        rate_nn_bpp=rate_nn_bpp,
        total_rate_bpp=rate_bpp,
    )
