"""The port on a GPU: the ARM kernel against its plain version, and the eval
forward on the card against the CPU. Every test here needs an NVIDIA GPU
and skips without one. The file imports no JAX, so it runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: ``models.arm.rate_tolerance`` (rtol = atol = 1e-4, plus what f32
resolves for latents whose Laplace scale is under 1/8 or whose rate is over
12 bits; cuBLAS sums the plain ARM's matmuls in another order than the
kernel).
"""

import numpy as np
import pytest
import torch

from coolchic_tpu_torch.models.arm import arm_rate_plain, init_arm_params, rate_tolerance
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.models.coolchic import init_coolchic_params
from coolchic_tpu_torch.ops import arm_rate as ops
from coolchic_tpu_torch.params import from_numpy_pytree, to_numpy_pytree
from coolchic_tpu_torch.train.step import eval_metrics

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _arm_params(dim_arm, n_hidden, seed, device):
    gen = torch.Generator(device).manual_seed(seed)
    params = init_arm_params(gen, dim_arm, n_hidden, device)
    w0 = params["layers"][0]["weight"]
    params["layers"][0]["weight"] = torch.randn(w0.shape, generator=gen, device=device) * 0.2
    return params, gen


@pytest.mark.parametrize("dim_arm,n_hidden", [(8, 1), (16, 2), (24, 2), (32, 2), (24, 0)])
def test_kernel_matches_plain(cuda, dim_arm, n_hidden):
    params, gen = _arm_params(dim_arm, n_hidden, dim_arm, cuda)
    latents = [torch.round(torch.randn((1, h, w), generator=gen, device=cuda) * 3.0)
               for h, w in ((16, 24), (37, 130), (9, 5))]
    count = ops.launch_count
    got = ops.arm_rate_pyramid(latents, params, dim_arm, n_hidden)
    assert ops.launch_count == count + 1
    want, _, log_scale = arm_rate_plain(latents, params, dim_arm)
    scale = torch.exp(torch.clamp(log_scale - 4.0, -4.6, 5.0))
    torch.cuda.synchronize()
    assert torch.all((got - want).abs() <= rate_tolerance(want, scale))


def test_more_planes_than_one_launch_takes(cuda):
    """70 channels: two launches (64 planes each at most), one flat rate."""
    params, gen = _arm_params(8, 1, 1, cuda)
    latents = [torch.round(torch.randn((70, 6, 11), generator=gen, device=cuda) * 2.0)]
    count = ops.launch_count
    got = ops.arm_rate_pyramid(latents, params, 8, 1)
    assert ops.launch_count == count + 2
    want, _, log_scale = arm_rate_plain(latents, params, 8)
    scale = torch.exp(torch.clamp(log_scale - 4.0, -4.6, 5.0))
    assert torch.all((got - want).abs() <= rate_tolerance(want, scale))


def test_wrapper_raises_instead_of_falling_back(cuda):
    params, _ = _arm_params(8, 1, 2, cuda)
    with pytest.raises(TypeError):
        ops.arm_rate(torch.zeros(4, 5, dtype=torch.float64, device=cuda), params, 8, 1)
    with pytest.raises(ValueError):
        ops.arm_rate(torch.zeros(4, 5, device=cuda), from_numpy_pytree(
            to_numpy_pytree(params), "cpu"), 8, 1)


def test_eval_forward_on_the_card_matches_the_cpu(cuda):
    cfg = CoolChicConfig(img_size=(45, 61), dim_arm=16, n_hidden_layers_arm=2)
    params = init_coolchic_params(torch.Generator(cuda).manual_seed(0), cfg, cuda,
                                  latent_init="normal")
    rng = np.random.default_rng(0)
    params["latents"] = [torch.tensor(rng.standard_normal(s).astype(np.float32) * 0.3,
                                      device=cuda) for s in cfg.latent_shapes]
    target = torch.tensor(rng.uniform(size=(3, 45, 61)).astype(np.float32))
    count = ops.launch_count
    on_card = eval_metrics(params, cfg, target.to(cuda), 1e-3)
    assert ops.launch_count == count + 1
    on_cpu = eval_metrics(from_numpy_pytree(to_numpy_pytree(params), "cpu"), cfg, target, 1e-3)
    np.testing.assert_allclose(on_card.rate_latent_bpp.item(), on_cpu.rate_latent_bpp.item(),
                               rtol=1e-5)
    np.testing.assert_allclose(on_card.psnr_db.item(), on_cpu.psnr_db.item(), atol=0.01)
