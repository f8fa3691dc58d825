"""Models of the PyTorch port vs the JAX package: quantizer, upsampling,
synthesis, forward (eval and noise-free training, values and gradients),
loss, and the parameter initialisation.

Inputs are made with numpy from a seed; noise is JAX's own draw, handed to
the port. Tolerances (both sides f32 on the CPU):
  * quantizer, upsampling, synthesis, loss: rtol = atol = 1e-5 (elementwise
    math and short sums, in another order);
  * forward output: rtol = atol = 1e-5, except that the eval-mode rounding
    to 1/255 may land on the other side of a .5 for a few pixels: those
    differ by exactly one level (at most 3 such pixels);
  * rate: ``models.arm.rate_tolerance`` (see tests/test_torch_arm.py);
  * gradients: rtol = 1e-4, atol = 1e-6 (a backward through the ARM and
    three convolutions, summed in another order); at JAX's zero-latent
    initialisation, where the clips tie, rtol = 1e-5 (only the synthesis
    biases get a gradient there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coolchic_tpu.models import quantizer as jq
from coolchic_tpu.models.config import CoolChicConfig as JaxConfig
from coolchic_tpu.models.coolchic import frame_forward as jax_frame_forward
from coolchic_tpu.models.coolchic import init_coolchic_params as jax_init_params
from coolchic_tpu.models.synthesis import synthesis_apply as jax_synthesis_apply
from coolchic_tpu.models.upsampling import upsampling_apply as jax_upsampling_apply
from coolchic_tpu.train.loss import loss_function as jax_loss_function
from coolchic_tpu_torch.models import quantizer as tq
from coolchic_tpu_torch.models.arm import rate_tolerance
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.models.coolchic import frame_forward, init_coolchic_params
from coolchic_tpu_torch.models.synthesis import synthesis_apply
from coolchic_tpu_torch.models.upsampling import upsampling_apply
from coolchic_tpu_torch.params import from_numpy_pytree, to_numpy_pytree, tree_leaves
from coolchic_tpu_torch.train.loss import loss_function

LAYERS = ("8-1-linear-relu", "X-1-linear-none", "X-3-residual-relu", "X-3-residual-none")
ARCH = dict(img_size=(29, 37), n_ft_per_res=(1, 1, 1), dim_arm=8, n_hidden_layers_arm=1,
            layers_synthesis=LAYERS)

QUANT_MODES = [
    ("none", "gaussian"),
    ("none", "kumaraswamy"),
    ("softround", "gaussian"),
    ("softround", "kumaraswamy"),
    ("softround_alone", "none"),
    ("hardround", "none"),
    ("ste", "none"),
    ("true_ste", "none"),
]


def random_params(seed, cfg=JaxConfig(**ARCH)):
    """JAX-initialised params with every leaf made non-trivial (numpy)."""
    params = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)

    def perturb(a, s):
        return (a + s * rng.standard_normal(a.shape)).astype(np.float32)

    params["latents"] = [perturb(a, 0.3) for a in params["latents"]]
    params["arm"] = jax.tree.map(lambda a: perturb(a, 0.1), params["arm"])
    params["upsampling"] = jax.tree.map(lambda a: perturb(a, 0.05), params["upsampling"])
    params["synthesis"] = jax.tree.map(lambda a: perturb(a, 0.1), params["synthesis"])
    return params


@pytest.mark.parametrize("q_type,noise_type", QUANT_MODES)
def test_quantizer_matches_jax(q_type, noise_type):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((5, 7)) * 4).astype(np.float32)
    w = rng.standard_normal((5, 7)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    t, a = 0.3, 1.7
    raw = None
    if noise_type == "gaussian":
        raw = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    elif noise_type == "kumaraswamy":
        raw = np.asarray(jax.random.uniform(key, x.shape, jnp.float32))

    def jfun(xx):
        return jnp.sum(jq.quantize(xx, key, noise_type, q_type, t, a) * w)

    want, want_grad = jax.value_and_grad(jfun)(jnp.asarray(x))
    want_q = jq.quantize(jnp.asarray(x), key, noise_type, q_type, t, a)
    xt = torch.tensor(x, requires_grad=True)
    got_q = tq.quantize(xt, noise_type, q_type, t, a,
                        noise=None if raw is None else torch.tensor(raw))
    (got_q * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(got_q.detach().numpy(), np.asarray(want_q), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-5)


def test_quantizer_draws_noise_from_the_generator():
    x = torch.zeros(1000)
    a = tq.quantize(x, "kumaraswamy", "none", generator=torch.Generator().manual_seed(1))
    b = tq.quantize(x, "kumaraswamy", "none", generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.abs().max().item() <= 0.5 and a.std().item() > 0.1


def test_upsampling_matches_jax():
    params = random_params(1)
    jcfg = JaxConfig(**ARCH)
    want = jax_upsampling_apply(
        jax.tree.map(jnp.asarray, params["upsampling"]),
        [jnp.asarray(a) for a in params["latents"]], jcfg.ups_k_size, jcfg.ups_preconcat_k_size,
    )
    tp = from_numpy_pytree(params, "cpu")
    got = upsampling_apply(tp["upsampling"], tp["latents"], jcfg.ups_k_size,
                           jcfg.ups_preconcat_k_size)
    assert got.shape == (3, 29, 37)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_upsampling_bilinear_kernel_size_matches_jax():
    """ups_k_size 4 (bilinear init) and preconcat 3, odd sizes."""
    jcfg = JaxConfig(**{**ARCH, "ups_k_size": 4, "ups_preconcat_k_size": 3})
    params = random_params(2, jcfg)
    want = jax_upsampling_apply(
        jax.tree.map(jnp.asarray, params["upsampling"]),
        [jnp.asarray(a) for a in params["latents"]], 4, 3,
    )
    tp = from_numpy_pytree(params, "cpu")
    got = upsampling_apply(tp["upsampling"], tp["latents"], 4, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_synthesis_matches_jax():
    params = random_params(3)
    jcfg = JaxConfig(**ARCH)
    cfg = CoolChicConfig(**ARCH)
    x = np.random.default_rng(3).standard_normal((3, 29, 37)).astype(np.float32)
    want = jax_synthesis_apply(jax.tree.map(jnp.asarray, params["synthesis"]), jnp.asarray(x),
                               jcfg.parsed_synthesis_layers())
    got = synthesis_apply(from_numpy_pytree(params["synthesis"], "cpu"), torch.tensor(x),
                          cfg.parsed_synthesis_layers())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _assert_decoded_close(got, want, eval_mode):
    diff = np.abs(got - want)
    if not eval_mode:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    assert diff.max() <= 1.0 / 255.0 + 1e-6
    assert np.count_nonzero(diff > 1e-5) <= 3


@pytest.mark.parametrize(
    "training,extra",
    [(False, {}), (True, {}), (False, {"frozen_zero_grids": (1,)}), (True, {"ac_max_val": 2})],
)
def test_frame_forward_matches_jax(training, extra):
    extra = dict(extra)
    ac_max_val = extra.pop("ac_max_val", -1)
    jcfg = JaxConfig(**ARCH, **extra)
    cfg = CoolChicConfig(**ARCH, **extra)
    params = random_params(4)
    kw = dict(quantizer_noise_type="none", quantizer_type="ste", soft_round_temperature=0.3,
              ac_max_val=ac_max_val, training=training)
    dec_j, rate_j, extras_j = jax_frame_forward(jax.tree.map(jnp.asarray, params), jcfg, **kw)
    dec_t, rate_t, _ = frame_forward(from_numpy_pytree(params, "cpu"), cfg, **kw)
    _assert_decoded_close(dec_t.numpy(), np.asarray(dec_j), not training)
    scale = np.exp(np.clip(np.asarray(extras_j["log_scale"]) - 4.0, -4.6, 5.0))
    rate_t, rate_j = rate_t.detach(), torch.tensor(np.asarray(rate_j))
    assert torch.all((rate_t - rate_j).abs() <= rate_tolerance(rate_j, torch.tensor(scale)))
    if "frozen_zero_grids" in extra:
        n0 = 29 * 37
        assert rate_t[n0 : n0 + 15 * 19].std().item() == 0.0  # all-zero grid


def test_training_loss_gradients_match_jax():
    """The whole training objective (ste, no noise): loss and gradients of
    every parameter."""
    jcfg = JaxConfig(**ARCH)
    cfg = CoolChicConfig(**ARCH)
    params = random_params(5)
    target = np.random.default_rng(5).uniform(size=(3, 29, 37)).astype(np.float32)
    kw = dict(quantizer_noise_type="none", quantizer_type="ste", soft_round_temperature=0.3,
              training=True)

    def jloss(p):
        dec, rate, _ = jax_frame_forward(p, jcfg, **kw)
        return jax_loss_function(dec, rate, jnp.asarray(target), 1e-3).loss

    want, want_grads = jax.jit(jax.value_and_grad(jloss))(jax.tree.map(jnp.asarray, params))
    tp = from_numpy_pytree(params, "cpu")
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    dec, rate, _ = frame_forward(tp, cfg, **kw)
    loss = loss_function(dec, rate, torch.tensor(target), 1e-3).loss
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for g, w in zip(grads, jax.tree.leaves(want_grads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("frame_type", ["I", "P", "B"])
def test_zero_latent_gradient_matches_jax(frame_type):
    """The training loss (ste, no noise) at JAX's own initialisation: zero
    latents and zero synthesis biases make every synthesized sample exactly
    0, so the I frame's decoded image sits on the clip's lower bound and a P
    / B frame's zero flow puts every border sample on the warp's clip
    bounds. ``jnp.clip`` gives half the gradient at such a tie; the port's
    gradient equals ``jax.grad`` leaf by leaf (rtol 1e-5)."""
    arch = dict(img_size=(16, 24), n_ft_per_res=(1, 1, 1), dim_arm=8, n_hidden_layers_arm=1,
                layers_synthesis=("8-1-linear-relu", "X-1-linear-none", "X-3-residual-none"),
                frame_type=frame_type, out_channels={"I": 3, "P": 6, "B": 9}[frame_type])
    jcfg, cfg = JaxConfig(**arch), CoolChicConfig(**arch)
    params = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(7)
    target = rng.uniform(size=(3, 16, 24)).astype(np.float32)
    refs = [rng.uniform(size=(3, 16, 24)).astype(np.float32) for _ in range("IPB".index(frame_type))]
    kw = dict(quantizer_noise_type="none", quantizer_type="ste", soft_round_temperature=0.3,
              training=True)

    def jloss(p):
        dec, rate, _ = jax_frame_forward(p, jcfg, refs=tuple(map(jnp.asarray, refs)) or None, **kw)
        return jax_loss_function(dec, rate, jnp.asarray(target), 1e-3).loss

    want_grads = jax.grad(jloss)(jax.tree.map(jnp.asarray, params))
    tp = from_numpy_pytree(params, "cpu")
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    dec, rate, _ = frame_forward(tp, cfg, refs=tuple(map(torch.tensor, refs)) or None, **kw)
    grads = torch.autograd.grad(loss_function(dec, rate, torch.tensor(target), 1e-3).loss, leaves)
    assert any(np.abs(g.numpy()).max() > 1e-3 for g in grads)
    for g, w in zip(grads, jax.tree.leaves(want_grads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=0)


@pytest.mark.parametrize("frame_data_type", ["rgb", "yuv420"])
def test_loss_matches_jax(frame_data_type):
    rng = np.random.default_rng(6)
    dec = rng.uniform(size=(3, 16, 24)).astype(np.float32)
    tgt = rng.uniform(size=(3, 16, 24)).astype(np.float32)
    rate = rng.uniform(0, 8, size=(600,)).astype(np.float32)
    want = jax_loss_function(jnp.asarray(dec), jnp.asarray(rate), jnp.asarray(tgt), 2e-3, 1234.0,
                             frame_data_type=frame_data_type)
    got = loss_function(torch.tensor(dec), torch.tensor(rate), torch.tensor(tgt), 2e-3, 1234.0,
                        frame_data_type=frame_data_type)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5, atol=1e-5)


def test_init_params_layout_matches_jax():
    jcfg = JaxConfig(**ARCH)
    cfg = CoolChicConfig(**ARCH)
    want = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    got = to_numpy_pytree(init_coolchic_params(torch.Generator().manual_seed(0), cfg, "cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
    # The deterministic leaves are equal; the random ones follow the same rules.
    for key in ("latents", "upsampling"):
        for g, w in zip(jax.tree.leaves(got[key]), jax.tree.leaves(want[key])):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got["arm"]["layers"][0]["weight"], 0.0)
    bound = np.sqrt(1.0 / (3 * 1 * 1)) / 8**2
    assert np.abs(got["synthesis"]["layers"][0]["weight"]).max() <= bound
    np.testing.assert_array_equal(got["synthesis"]["layers"][2]["weight"], 0.0)


def test_config_matches_jax():
    for kw in (ARCH, {"img_size": (512, 768)}, {**ARCH, "frozen_zero_grids": (0, 2)}):
        j, t = JaxConfig(**kw), CoolChicConfig(**kw)
        assert t.latent_shapes == j.latent_shapes
        assert t.n_latents == j.n_latents
        assert t.parsed_synthesis_layers() == j.parsed_synthesis_layers()
    with pytest.raises(ValueError):
        CoolChicConfig(img_size=(8, 8), dim_arm=12)
