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
from torch_kernel_checks import (
    LARGE_ARMS, LARGE_SEEDS, arm_rate_f64, check_rate, compare_rates, holds, large_latent_case,
)

ARM_CASES = [(d, h) for d in (8, 16, 24, 32) for h in (1, 2)]
SHAPES = [(16, 24), (37, 130)]
# (dim_arm, n_hidden, seed) of a large-latent input that 3xTF32 misses and
# f32 resolves (``python tests/test_torch_arm.py`` lists such seeds).
PIN_3XTF32 = (24, 2, 32)


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


def tf32_rna(x):
    """cvt.rna.tf32.f32: round to 10 explicit mantissa bits, to nearest, ties
    away from zero (the sign bit stands apart, so adding half an ulp to the
    bits rounds the magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def permuted(k):
    """The kernel's feature order: feature 8j + 2t + e at k position t + 4e
    of the 8-deep k-step j of an m16n8k8 mma (t < 4, e < 2)."""
    return [8 * j + 2 * t + e for j in range(k // 8) for e in (0, 1) for t in range(4)]


def matmul_3xtf32(x, w):
    """x @ w.T as 3xTF32 on m16n8k8: operands split into rna_tf32(v) and
    rna_tf32(v - hi); per 8-deep k-step, a_lo b_hi, a_hi b_lo and a_hi b_hi,
    each a sum of 8 exact products added to an f32 accumulator."""
    perm = permuted(x.shape[1])
    x, w = x[:, perm], w[:, perm]
    xh, wh = tf32_rna(x), tf32_rna(w)
    xl, wl = tf32_rna(x - xh), tf32_rna(w - wh)
    acc = torch.zeros(x.shape[0], w.shape[0])
    for j in range(0, x.shape[1], 8):
        for a, b in ((xl, wh), (xh, wl), (xh, wh)):
            acc = (acc.double() + a[:, j : j + 8].double() @ b[:, j : j + 8].double().T).float()
    return acc


def jax_rate_planes(latents, params_np, dim_arm):
    """The JAX rate over [1, H, W] planes, flat in their order."""
    return np.concatenate([jax_rate(y[0], params_np, dim_arm)[0] for y in latents])


def emulated_kernel_rate(latents, params, dim_arm, scheme):
    """The flat rate of [1, H, W] planes as a tensor-core kernel computes it.
    ``"f64"``: the kernel of ``csrc/arm_rate.cu`` (f64 mma: exact products,
    f64 sums and activations, each hidden layer relu(b + x (W + I)^T) with
    the residual folded into the weights; the f32 epilogue with y - mu in
    f64). ``"3xtf32"``: the same MLP as the plain version, in f32 with every
    matmul in 3xTF32."""
    ys = [torch.tensor(y) for y in latents]
    x = torch.cat([tarm.get_neighbors(y, dim_arm) for y in ys])
    layers = [{k: torch.tensor(v) for k, v in layer.items()} for layer in params["layers"]]
    if scheme == "f64":
        perm = permuted(dim_arm)
        eye = torch.eye(dim_arm, dtype=torch.float64)
        x = x.double()
        for layer in layers[:-1]:
            w = layer["weight"].double() + eye
            x = torch.relu(layer["bias"].double() + x[:, perm] @ w[:, perm].T)
        raw = x[:, perm] @ layers[-1]["weight"][:, perm].double().T + layers[-1]["bias"].double()
    else:
        for layer in layers[:-1]:
            x = torch.relu(matmul_3xtf32(x, layer["weight"]) + layer["bias"] + x)
        raw = matmul_3xtf32(x, layers[-1]["weight"]) + layers[-1]["bias"]
    scale = torch.exp(torch.clamp(raw[:, 1].float() - 4.0, -4.6, 5.0))
    flat = torch.cat([y.reshape(-1) for y in ys])
    cdf = lambda v: tarm.laplace_cdf((v.double() - raw[:, 0]).float(), 0.0, scale)
    proba = torch.clamp(cdf(flat + 0.5) - cdf(flat - 0.5), min=2.0**-16)
    return -torch.log2(proba)


def assert_rate_close_neither(got, want, scale):
    res = compare_rates(torch.as_tensor(got), torch.as_tensor(want), torch.as_tensor(scale))
    assert holds(res), res


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("dim_arm,n_hidden", ARM_CASES)
def test_tensor_core_scheme_matches_jax(dim_arm, n_hidden, hw):
    """On test_plain_rate_matches_jax's inputs, the kernel's f64 MMA scheme
    holds the rate to the JAX one within rate_tolerance."""
    rng = np.random.default_rng(100 * dim_arm + 10 * n_hidden + hw[0])
    params = arm_params_np(rng, dim_arm, n_hidden)
    lat = latent_np(rng, hw)
    want, scale = jax_rate(lat, params, dim_arm)
    got = emulated_kernel_rate([lat[None]], params, dim_arm, "f64")
    assert_rate_close_neither(got, want, scale)


@pytest.mark.parametrize("dim_arm,n_hidden", LARGE_ARMS)
def test_f64_scheme_on_latents_beyond_tf32_integers(dim_arm, n_hidden):
    """Every seed of LARGE_SEEDS: the f64 scheme within tolerance of the
    float64 rate, and of the port's f32 rate wherever that one is itself
    within tolerance of float64."""
    f32_off = []
    for seed in LARGE_SEEDS:
        params, latents = large_latent_case(dim_arm, n_hidden, seed)
        assert max(np.abs(y).max() for y in latents) > 2048
        got = emulated_kernel_rate(latents, params, dim_arm, "f64")
        res = check_rate(got, from_numpy_pytree(latents, "cpu"),
                         from_numpy_pytree(params, "cpu"), dim_arm)
        assert holds(res["vs_f64"]), (seed, res)
        if res["f32_holds"]:
            assert holds(res["vs_f32"]), (seed, res)
        else:
            f32_off.append(seed)
    assert len(f32_off) < len(LARGE_SEEDS) // 2, f32_off


def test_3xtf32_misses_f32_accuracy_on_large_latents():
    """Why the kernel's MMA is f64: 3xTF32 keeps ~22 bits of each operand
    against f32's 24, and on these inputs misses the tolerance against the
    float64 rate where f32 (JAX) holds it."""
    params, latents = large_latent_case(*PIN_3XTF32)
    want64, scale64 = arm_rate_f64(from_numpy_pytree(latents, "cpu"),
                                   from_numpy_pytree(params, "cpu"), PIN_3XTF32[0])
    worst = lambda r: ((torch.as_tensor(r) - want64).abs()
                       / tarm.rate_tolerance(want64, scale64)).max().item()
    assert worst(jax_rate_planes(latents, params, PIN_3XTF32[0])) < 1.0
    assert worst(emulated_kernel_rate(latents, params, PIN_3XTF32[0], "3xtf32")) > 1.0
    assert worst(emulated_kernel_rate(latents, params, PIN_3XTF32[0], "f64")) < 1.0


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


def test_plane_table_shapes_and_offsets():
    """One entry per plane in forward order, offsets into the flat rate, the
    stride to the same plane of a batch's next image (its grid's C * H * W),
    and one chunk (launch) per ``MAX_PLANES`` planes."""
    table = ops.plane_table(((2, 5, 3), (1, 4, 4), (ops.MAX_PLANES, 1, 2)))
    assert table.planes[:3] == ((0, 0, 5, 3, 0), (0, 1, 5, 3, 15), (1, 0, 4, 4, 30))
    assert table.planes[3] == (2, 0, 1, 2, 46)
    assert len(table.planes) == 3 + ops.MAX_PLANES
    assert table.n_latents == 46 + 2 * ops.MAX_PLANES
    assert table.n_launches == 2
    (s0, n0, h0, w0, o0, t0), (s1, n1, h1, w1, o1, t1) = table.chunks
    assert (s0, n0, s1, n1) == (0, ops.MAX_PLANES, ops.MAX_PLANES, 3)
    assert list(h0[:4]) == [5, 5, 4, 1] and list(w0[:4]) == [3, 3, 4, 2]
    assert list(o0[:4]) == [0, 15, 30, 46]
    assert list(o1) == [46 + 2 * (ops.MAX_PLANES - 3 + i) for i in range(3)]
    assert list(t0[:4]) == [30, 30, 16, 2 * ops.MAX_PLANES] and set(t1) == {2 * ops.MAX_PLANES}
    assert ops.plane_table(((2, 5, 3),)) is ops.plane_table(((2, 5, 3),))  # cached


def _layer_params(dim_arm, n_hidden):
    rng = np.random.default_rng(0)
    return from_numpy_pytree(arm_params_np(rng, dim_arm, n_hidden), "cpu")


def test_layer_table_order():
    params = _layer_params(16, 2)
    got = ops.layer_table(params, 16, 2, torch.device("cpu"))
    want = [t for layer in params["layers"] for t in (layer["weight"], layer["bias"])]
    assert len(got) == 6 and all(a is b for a, b in zip(got, want))


@pytest.mark.parametrize("fault", ["layer_count", "too_deep", "shape", "dtype", "contiguity",
                                   "device"])
def test_layer_table_rejects(fault):
    params, n_hidden, error = _layer_params(8, 1), 1, ValueError
    layer = params["layers"][0]
    if fault == "layer_count":
        n_hidden = 2
    elif fault == "too_deep":
        n_hidden = ops.MAX_HIDDEN + 1
        params = _layer_params(8, n_hidden)
    elif fault == "shape":
        params["layers"][1]["weight"] = torch.zeros(3, 8)
    elif fault == "dtype":
        layer["bias"], error = layer["bias"].double(), TypeError
    elif fault == "contiguity":
        layer["weight"] = layer["weight"].T.contiguous().T
    elif fault == "device":
        layer["weight"] = layer["weight"].to("meta")
    with pytest.raises(error):
        ops.layer_table(params, 8, n_hidden, torch.device("cpu"))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    params = tarm.init_arm_params(torch.Generator().manual_seed(0), 8, 1, "cpu")
    with pytest.raises(ValueError):
        ops.arm_rate(torch.zeros(4, 5), params, 12, 1)
    with pytest.raises(TypeError):
        ops.arm_rate(torch.zeros(4, 5, dtype=torch.float64), params, 8, 1)
    with pytest.raises(ValueError):
        ops.arm_rate(torch.zeros(1, 4, 5), params, 8, 1)
    with pytest.raises(ValueError):
        ops.layer_table(params, 8, 2, torch.device("cpu"))
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
    # Large latents (|y| up to 3,000): for each ARM of LARGE_ARMS, the seeds
    # of LARGE_SEEDS on which f32 (JAX), the f64-mma kernel and 3xTF32 miss
    # rate_tolerance against the float64 rate.
    print("dim_arm n_hidden n_seeds: seeds_over_tolerance jax_f32 | f64 | 3xtf32")
    for dim_arm, n_hidden in LARGE_ARMS:
        over = ([], [], [])
        for seed in LARGE_SEEDS:
            params, latents = large_latent_case(dim_arm, n_hidden, seed)
            want64, scale64 = arm_rate_f64(from_numpy_pytree(latents, "cpu"),
                                           from_numpy_pytree(params, "cpu"), dim_arm)
            tol = tarm.rate_tolerance(want64, scale64)
            rates = (jax_rate_planes(latents, params, dim_arm),
                     emulated_kernel_rate(latents, params, dim_arm, "f64"),
                     emulated_kernel_rate(latents, params, dim_arm, "3xtf32"))
            for seeds, r in zip(over, rates):
                if ((torch.as_tensor(r) - want64).abs() > tol).any():
                    seeds.append(seed)
        print(dim_arm, n_hidden, len(LARGE_SEEDS), *over, sep=" | ")
