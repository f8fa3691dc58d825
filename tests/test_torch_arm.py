"""ARM of the PyTorch port vs the JAX package: contexts, MLP, rate, pyramid
order, and the wrapper of the CUDA kernel (plain version on CPU tensors).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances (both sides f32 on the CPU):
  * contexts: exact (the same values are gathered);
  * MLP outputs mu / log_scale / scale: rtol = atol = 1e-5 (sums of at most
    32 products, in another order);
  * rate, from the same mu and scale and end to end:
    ``models.arm.rate_tolerance``: rtol = atol = 1e-4 for every latent whose
    scale is at least 1/8 and whose rate is at most 12 bits. Two kinds get
    one more term. Where the scale nears its 0.01 floor the Laplace CDF is
    steep, so the ~1e-6 by which another summation order moves mu moves the
    rate by up to ~1.1e-3 bits. The probability of a tail latent (over 12
    bits) is a difference of two CDF values near 0 or 1, so an ulp there
    (XLA's and PyTorch's expm1 differ) moves its rate by ~2^(rate - 23) / ln 2
    bits. The summed rate is held at rtol 1e-5.

``python tests/test_torch_arm.py`` prints, for each case of
``test_plain_rate_matches_jax``, the largest error, the latents beyond
rtol = atol = 1e-4 and the term each of them needs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coolchic_tpu.models import arm as jarm
from coolchic_tpu.models.config import CoolChicConfig as JaxConfig
from coolchic_tpu.models.coolchic import coolchic_forward as jax_coolchic_forward
from coolchic_tpu.models.coolchic import init_coolchic_params as jax_init_params
from coolchic_tpu_torch.models import arm as tarm
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.models.coolchic import coolchic_forward
from coolchic_tpu_torch.ops import arm_rate as ops
from coolchic_tpu_torch.params import from_numpy_pytree

ARM_CASES = [(d, h) for d in (8, 16, 24, 32) for h in (1, 2)]
SHAPES = [(16, 24), (37, 130)]


def arm_params_np(rng, dim_arm, n_hidden):
    """As tests/test_pallas_arm.py builds them: init rules (zero hidden
    layers, head N(0,1)/4, zero biases), then a first weight of 0.2 N(0, 1)
    so that mu and scale vary."""
    layers = [
        {"weight": np.zeros((dim_arm, dim_arm), np.float32), "bias": np.zeros(dim_arm, np.float32)}
        for _ in range(n_hidden)
    ]
    layers.append(
        {"weight": (rng.standard_normal((2, dim_arm)) / 4).astype(np.float32),
         "bias": np.zeros(2, np.float32)}
    )
    layers[0]["weight"] = (rng.standard_normal(layers[0]["weight"].shape) * 0.2).astype(np.float32)
    return {"layers": layers}


def latent_np(rng, hw):
    return np.round(rng.standard_normal(hw) * 3.0).astype(np.float32)


def jax_rate(lat, params_np, dim_arm):
    """(rate, scale) of the JAX ARM on one plane."""
    ctx = jarm.get_neighbors(jnp.asarray(lat)[None], dim_arm)
    mu, scale, _ = jarm.arm_apply(jax.tree.map(jnp.asarray, params_np), ctx)
    rate = jarm.latent_rate_bits(jnp.asarray(lat).reshape(-1), mu, scale)
    return np.asarray(rate), np.asarray(scale)


def assert_rate_close(got, want, scale):
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    tol = tarm.rate_tolerance(want, torch.as_tensor(scale))
    err = (got - want).abs()
    assert torch.all(err <= tol), f"max err {err.max().item()}, worst err/tol {(err / tol).max().item()}"
    np.testing.assert_allclose(got.sum().item(), want.sum().item(), rtol=1e-5)


@pytest.mark.parametrize("dim_arm", [8, 16, 24, 32])
def test_context_offsets_and_neighbors_match_jax(dim_arm):
    assert tarm.context_offsets(dim_arm) == jarm.context_offsets(dim_arm)
    lat = latent_np(np.random.default_rng(dim_arm), (2, 11, 13))
    want = np.asarray(jarm.get_neighbors(jnp.asarray(lat), dim_arm))
    got = tarm.get_neighbors(torch.tensor(lat), dim_arm).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dim_arm,n_hidden", ARM_CASES)
def test_arm_apply_and_rate_bits_match_jax(dim_arm, n_hidden):
    rng = np.random.default_rng(10 * dim_arm + n_hidden)
    params = arm_params_np(rng, dim_arm, n_hidden)
    lat = latent_np(rng, (16, 24))
    ctx = jarm.get_neighbors(jnp.asarray(lat)[None], dim_arm)
    mu, scale, log_scale = jarm.arm_apply(jax.tree.map(jnp.asarray, params), ctx)
    t_mu, t_scale, t_log_scale = tarm.arm_apply(
        from_numpy_pytree(params, "cpu"), torch.tensor(np.asarray(ctx))
    )
    for got, want in ((t_mu, mu), (t_scale, scale), (t_log_scale, log_scale)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # The rate itself, from the same mu and scale.
    flat = lat.reshape(-1)
    want = np.asarray(jarm.latent_rate_bits(jnp.asarray(flat), mu, scale))
    got = tarm.latent_rate_bits(
        torch.tensor(flat), torch.tensor(np.asarray(mu)), torch.tensor(np.asarray(scale))
    ).numpy()
    assert_rate_close(got, want, np.asarray(scale))


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("dim_arm,n_hidden", ARM_CASES)
def test_plain_rate_matches_jax(dim_arm, n_hidden, hw):
    rng = np.random.default_rng(100 * dim_arm + 10 * n_hidden + hw[0])
    params = arm_params_np(rng, dim_arm, n_hidden)
    lat = latent_np(rng, hw)
    want, scale = jax_rate(lat, params, dim_arm)
    got = ops.arm_rate(torch.tensor(lat), from_numpy_pytree(params, "cpu"), dim_arm, n_hidden)
    assert got.shape == hw
    assert_rate_close(got.reshape(-1), want, scale)


def test_rate_tolerance_terms():
    rate = torch.tensor([0.0, 4.0, 12.0, 16.0])
    # Off the scale floor and up to 12 bits: exactly rtol = atol = 1e-4.
    for s in (0.125, 100.0):
        wide = tarm.rate_tolerance(rate, torch.full_like(rate, s))
        torch.testing.assert_close(wide[:3], 1e-4 + 1e-4 * rate[:3], rtol=0, atol=0)
    # Steep, at the 0.01 scale floor: the mu term adds ~1.1e-3 bits.
    narrow = tarm.rate_tolerance(rate, torch.full_like(rate, 0.01))
    assert (narrow - wide)[0].item() == pytest.approx(2.0**-17 / (0.01 * np.log(2.0)), rel=1e-3)
    # Tail, over 12 bits: 2^(rate - 21) on top.
    assert wide[3].item() - 1e-4 - 16e-4 == pytest.approx(2.0**-5, rel=1e-3)


def test_pyramid_matches_coolchic_forward_order():
    """Flat rate over 3 grids (odd sizes) in the order of the JAX forward."""
    jcfg = JaxConfig(img_size=(29, 37), n_ft_per_res=(1, 1, 1), dim_arm=8, n_hidden_layers_arm=1,
                     layers_synthesis=("8-1-linear-relu", "X-1-linear-none"))
    cfg = CoolChicConfig(img_size=(29, 37), n_ft_per_res=(1, 1, 1), dim_arm=8,
                         n_hidden_layers_arm=1,
                         layers_synthesis=("8-1-linear-relu", "X-1-linear-none"))
    params = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(3)
    params["arm"] = arm_params_np(rng, 8, 1)
    params["latents"] = [(rng.standard_normal(s) * 0.2).astype(np.float32)
                         for s in jcfg.latent_shapes]
    _, want, extras = jax_coolchic_forward(jax.tree.map(jnp.asarray, params), jcfg, training=False)
    scale = np.exp(np.clip(np.asarray(extras["log_scale"]) - 4.0, -4.6, 5.0))
    tparams = from_numpy_pytree(params, "cpu")
    y_hat = [torch.round(t * cfg.encoder_gain) for t in tparams["latents"]]
    got = ops.arm_rate_pyramid(y_hat, tparams["arm"], 8, 1)
    assert_rate_close(got, np.asarray(want), scale)
    # And through the port's own eval forward.
    _, fwd_rate, extras = coolchic_forward(tparams, cfg, training=False)
    torch.testing.assert_close(fwd_rate, got, rtol=0, atol=0)
    assert extras["mu"] is None and extras["log_scale"] is None


def test_pack_arm_weights_layout():
    rng = np.random.default_rng(0)
    params = from_numpy_pytree(
        {"layers": [{"weight": rng.standard_normal((8, 8)).astype(np.float32),
                     "bias": rng.standard_normal(8).astype(np.float32)},
                    {"weight": rng.standard_normal((2, 8)).astype(np.float32),
                     "bias": rng.standard_normal(2).astype(np.float32)}]}, "cpu")
    flat = ops.pack_arm_weights(params, 8, 1)
    assert flat.numel() == 8 * 8 + 8 + 2 * 8 + 2 + 2  # padded to a multiple of 4
    torch.testing.assert_close(flat[:64].reshape(8, 8), params["layers"][0]["weight"])
    torch.testing.assert_close(flat[64:72], params["layers"][0]["bias"])
    torch.testing.assert_close(flat[72:88].reshape(2, 8), params["layers"][1]["weight"])
    torch.testing.assert_close(flat[88:90], params["layers"][1]["bias"])
    assert flat[90:].abs().sum().item() == 0.0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    params = tarm.init_arm_params(torch.Generator().manual_seed(0), 8, 1, "cpu")
    with pytest.raises(ValueError):
        ops.arm_rate(torch.zeros(4, 5), params, 12, 1)
    with pytest.raises(TypeError):
        ops.arm_rate(torch.zeros(4, 5, dtype=torch.float64), params, 8, 1)
    with pytest.raises(ValueError):
        ops.arm_rate(torch.zeros(1, 4, 5), params, 8, 1)
    with pytest.raises(ValueError):
        ops.pack_arm_weights(params, 8, 2)
    count = ops.launch_count
    ops.arm_rate(torch.zeros(4, 5), params, 8, 1)
    assert ops.launch_count == count  # the CPU path launches nothing


if __name__ == "__main__":
    # Per-case report for test_plain_rate_matches_jax (JAX on the CPU).
    jax.config.update("jax_platforms", "cpu")
    print("dim_arm n_hidden shape n_latents n_steep n_tail max_err max_err_others n_beyond_1e-4 "
          "terms_needed")
    for hw in SHAPES:
        for dim_arm, n_hidden in ARM_CASES:
            rng = np.random.default_rng(100 * dim_arm + 10 * n_hidden + hw[0])
            params = arm_params_np(rng, dim_arm, n_hidden)
            lat = latent_np(rng, hw)
            want, scale = jax_rate(lat, params, dim_arm)
            got = ops.arm_rate(torch.tensor(lat), from_numpy_pytree(params, "cpu"), dim_arm,
                               n_hidden).reshape(-1).numpy()
            err = np.abs(got - want)
            steep, tail = scale < tarm.STEEP_SCALE, np.abs(want) > tarm.TAIL_RATE
            plain = ~steep & ~tail
            beyond = err > 1e-4 + 1e-4 * np.abs(want)
            terms = sorted({("steep+tail" if st and ta else "steep" if st else "tail" if ta
                             else "none") for st, ta in zip(steep[beyond], tail[beyond])})
            print(dim_arm, n_hidden, f"{hw[0]}x{hw[1]}", err.size, int(steep.sum()),
                  int(tail.sum()), f"{err.max():.3g}", f"{err[plain].max(initial=0.0):.3g}",
                  int(beyond.sum()), ",".join(terms) or "-")
