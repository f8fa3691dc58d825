"""Batched and mixed-size overfitting of the PyTorch port vs the JAX package:
the masking helpers, the masked forward, the batched forward, the batched
phase engine, the per-image clip + Adam, the batched NN-quantization search,
a mixed-size batch encode, and the batched ARM rate on CPU tensors.

Inputs are made with numpy from a seed and handed to both packages; a batch
goes through ``jax.vmap`` of the JAX function and through the port's stacked
parameters. Small sizes: 16x24 and 24x32 images, dim_arm 8, 1 hidden layer,
3 grids. Tolerances (both sides f32 on the CPU):
  * masking helpers: exact;
  * masked eval forward vs the unpadded forward: decoded atol 2e-5, rate sum
    and loss 1e-5 relative, PSNR 1e-3 dB (the JAX package's own test);
  * forward vs JAX: decoded rtol = atol = 1e-4 (eval mode: one 8-bit level on
    at most 0.5 % of the samples, as tests/test_torch_models.py), rate by
    ``models.arm.rate_tolerance``;
  * one phase: logs rtol 1e-4 (atol 1e-9 for a loss that is zero), params
    atol 1e-4 (Adam normalises each step, so an f32 difference in a gradient
    near zero can move a parameter by up to ~lr per step);
  * clip + Adam: rtol 1e-5, atol 1e-7;
  * quantization search: identical q-steps and exp-Golomb orders per image.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from coolchic_tpu.models import coolchic as jcc
from coolchic_tpu.models import masking as jmask
from coolchic_tpu.models.arm import arm_apply as jax_arm_apply
from coolchic_tpu.models.arm import get_neighbors as jax_get_neighbors
from coolchic_tpu.models.config import CoolChicConfig as JaxConfig
from coolchic_tpu.train import presets as jp
from coolchic_tpu.train import step as jstep
from coolchic_tpu.train.loss import loss_function as jax_loss
from coolchic_tpu.train.quantize_model import quantize_model_with_info as jax_quantize_model
from coolchic_tpu_torch.models import masking as tmask
from coolchic_tpu_torch.models.arm import arm_rate_plain, rate_tolerance
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.models.coolchic import frame_forward
from coolchic_tpu_torch.ops.arm_rate import arm_rate_pyramid, arm_rate_pyramid_batch
from coolchic_tpu_torch.params import (
    from_numpy_pytree, stack_params, to_numpy_pytree, unstack_params,
)
from coolchic_tpu_torch.train import step as tstep
from coolchic_tpu_torch.train.encode import encode_frame, encode_frame_batch
from coolchic_tpu_torch.train.loss import loss_function
from coolchic_tpu_torch.train.presets import Preset, TrainerPhase, Warmup, WarmupPhase
from coolchic_tpu_torch.train.quantize_model import quantize_model_batch

ARCH = dict(n_ft_per_res=(1, 1, 1), dim_arm=8, n_hidden_layers_arm=1,
            layers_synthesis=("8-1-linear-relu", "X-1-linear-none", "X-3-residual-relu"))
SMALL, BIG = (16, 24), (24, 32)


def image(h, w, seed=0):
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    rng = np.random.default_rng(seed)
    img = np.stack([x, y, 0.5 * (x + y)]) + 0.05 * rng.standard_normal((3, h, w))
    return np.clip(img, 0, 1).astype(np.float32)


def random_params(seed, img_size=BIG):
    """JAX init, every leaf perturbed so that no module is at its zero start
    (numpy)."""
    cfg = JaxConfig(img_size=img_size, **ARCH)
    params = jax.tree.map(np.asarray, jcc.init_coolchic_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    scale = {"latents": 0.3, "arm": 0.1, "upsampling": 0.05, "synthesis": 0.05}
    return {k: jax.tree.map(
        lambda a: (a + scale[k] * rng.standard_normal(a.shape)).astype(np.float32), v)
        for k, v in params.items()}


def stack_np(trees):
    return jax.tree.map(lambda *leaves: np.stack(leaves), *trees)


def pad_to(a, h, w):
    return np.pad(a, [(0, 0)] * (a.ndim - 2) + [(0, h - a.shape[-2]), (0, w - a.shape[-1])])


def assert_rate_close(got, want, params, latents_jax, dim_arm=8):
    """Rates of the port against the JAX package's, with the Laplace scale of
    the JAX ARM on the same quantized latents."""
    ctx = jnp.concatenate([jax_get_neighbors(y, dim_arm) for y in latents_jax])
    scale = np.asarray(jax_arm_apply(jax.tree.map(jnp.asarray, params["arm"]), ctx)[1])
    want = torch.tensor(np.asarray(want))
    assert torch.all((got - want).abs() <= rate_tolerance(want, torch.tensor(scale)))


# --------------------------------------------------------------------------- #
# Masking helpers
# --------------------------------------------------------------------------- #
def test_masking_helpers_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 7, 9)).astype(np.float32)
    hw = np.array([[5, 9], [7, 4]], np.int32)
    for b in range(2):  # one image: valid_hw is [2]
        hv, wv = torch.tensor(hw[b, 0]), torch.tensor(hw[b, 1])
        np.testing.assert_array_equal(
            tmask.valid_mask_2d(7, 9, hv, wv).numpy(),
            np.asarray(jmask.valid_mask_2d(7, 9, hw[b, 0], hw[b, 1])))
        np.testing.assert_array_equal(
            tmask.replicate_extend(torch.tensor(x[b]), hv, wv).numpy(),
            np.asarray(jmask.replicate_extend(jnp.asarray(x[b]), hw[b, 0], hw[b, 1])))
    # A batch: valid_hw is [B, 2], and the rows differ.
    thw = torch.tensor(hw)
    want_mask = jax.vmap(lambda v: jmask.valid_mask_2d(7, 9, v[0], v[1]))(jnp.asarray(hw))
    np.testing.assert_array_equal(
        tmask.valid_mask_2d(7, 9, thw[:, 0], thw[:, 1]).numpy(), np.asarray(want_mask))
    want_ext = jax.vmap(lambda a, v: jmask.replicate_extend(a, v[0], v[1]))(
        jnp.asarray(x), jnp.asarray(hw))
    got_ext = tmask.replicate_extend(torch.tensor(x), thw[:, 0, None], thw[:, 1, None])
    np.testing.assert_array_equal(got_ext.numpy(), np.asarray(want_ext))
    # The same batch with the images on the second axis ([C, B, H, W]).
    got_cb = tmask.replicate_extend(torch.tensor(x).transpose(0, 1), thw[:, 0], thw[:, 1])
    np.testing.assert_array_equal(got_cb.transpose(0, 1).numpy(), np.asarray(want_ext))
    for level in range(4):
        want = jax.vmap(lambda v: jnp.stack(jmask.level_valid_hw(v, level)))(jnp.asarray(hw))
        got = torch.stack(tmask.level_valid_hw(thw, level), dim=-1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_replicate_extend_backward_is_a_scatter_add():
    x = torch.arange(12.0).reshape(1, 3, 4).requires_grad_(True)
    out = tmask.replicate_extend(x, torch.tensor(2), torch.tensor(3))
    out.sum().backward()
    want = torch.zeros(3, 4)
    want[:2, :3] = 1.0
    want[1, :3] += 1.0  # row 1 also feeds row 2
    want[:2, 2] += want[:2, 2]  # column 2 also feeds column 3
    np.testing.assert_array_equal(x.grad[0].numpy(), want.numpy())


# --------------------------------------------------------------------------- #
# Masked forward
# --------------------------------------------------------------------------- #
def test_masked_eval_forward_matches_jax_and_unpadded():
    cfg_s, cfg_b = CoolChicConfig(img_size=SMALL, **ARCH), CoolChicConfig(img_size=BIG, **ARCH)
    jcfg_b = JaxConfig(img_size=BIG, **ARCH)
    params = random_params(0, SMALL)
    padded = dict(params)
    padded["latents"] = [pad_to(a, h, w) for a, (_, h, w) in
                         zip(params["latents"], cfg_b.latent_shapes)]
    tgt_s = image(*SMALL)
    tgt_b = pad_to(tgt_s, *BIG)
    valid_hw = torch.tensor(SMALL)

    dec_s, rate_s, _ = frame_forward(from_numpy_pytree(params, "cpu"), cfg_s, training=False)
    dec_b, rate_b, _ = frame_forward(from_numpy_pytree(padded, "cpu"), cfg_b, training=False,
                                     valid_hw=valid_hw)
    # vs the unpadded forward (the tolerances of tests/test_mixed_batch.py)
    np.testing.assert_allclose(dec_b[:, : SMALL[0], : SMALL[1]].numpy(), dec_s.numpy(), atol=2e-5)
    assert rate_b.sum().item() == pytest.approx(rate_s.sum().item(), rel=1e-5)
    l_s = loss_function(dec_s, rate_s, torch.tensor(tgt_s), 1e-3)
    l_b = loss_function(dec_b, rate_b, torch.tensor(tgt_b), 1e-3, valid_hw=valid_hw)
    assert l_b.loss.item() == pytest.approx(l_s.loss.item(), rel=1e-5)
    assert l_b.psnr_db.item() == pytest.approx(l_s.psnr_db.item(), abs=1e-3)

    # vs the JAX package with valid_hw, on the whole buffer
    jhw = jnp.asarray(SMALL, jnp.int32)
    want_dec, want_rate, extras = jcc.frame_forward(
        jax.tree.map(jnp.asarray, padded), jcfg_b, training=False, valid_hw=jhw)
    diff = np.abs(dec_b.numpy() - np.asarray(want_dec))
    assert diff.max() <= 1.0 / 255.0 + 1e-6 and (diff > 1e-4).mean() <= 0.005
    assert rate_b.sum().item() == pytest.approx(float(jnp.sum(want_rate)), rel=1e-5)
    want_loss = jax_loss(want_dec, want_rate, jnp.asarray(tgt_b), 1e-3, valid_hw=jhw)
    assert l_b.loss.item() == pytest.approx(float(want_loss.loss), rel=1e-5)
    assert l_b.rate_latent_bpp.item() == pytest.approx(float(want_loss.rate_latent_bpp), rel=1e-5)


@pytest.mark.parametrize("frame_data_type", ["rgb", "yuv420"])
def test_masked_loss_matches_jax(frame_data_type):
    rng = np.random.default_rng(3)
    dec, tgt = rng.uniform(size=(2, 2, 3, 12, 16)).astype(np.float32)
    rate = rng.uniform(0, 4, (2, 50)).astype(np.float32)
    hw = np.array([[8, 10], [12, 14]], np.int32)
    lmbdas = np.array([1e-3, 4e-3], np.float32)
    want = jax.vmap(lambda d, r, t, l, v: jax_loss(d, r, t, l, 7.0, frame_data_type, v))(
        jnp.asarray(dec), jnp.asarray(rate), jnp.asarray(tgt), jnp.asarray(lmbdas),
        jnp.asarray(hw))
    got = loss_function(torch.tensor(dec), torch.tensor(rate), torch.tensor(tgt),
                        torch.tensor(lmbdas), 7.0, frame_data_type, torch.tensor(hw))
    for g, w in zip(got, want):
        assert g.shape == (2,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    one = loss_function(torch.tensor(dec[1]), torch.tensor(rate[1]), torch.tensor(tgt[1]),
                        4e-3, 7.0, frame_data_type, torch.tensor(hw[1]))
    np.testing.assert_allclose(one.loss.item(), got.loss[1].item(), rtol=1e-6)


# --------------------------------------------------------------------------- #
# Batched forward
# --------------------------------------------------------------------------- #
BATCH_HW = np.array([SMALL, BIG, (20, 30)], np.int32)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_batched_forward_matches_jax_vmap(training, masked):
    """Row b of the batch against row b of ``jax.vmap(frame_forward)`` and
    against the port's single forward on row b's parameters."""
    cfg, jcfg = CoolChicConfig(img_size=BIG, **ARCH), JaxConfig(img_size=BIG, **ARCH)
    rows = [random_params(s) for s in (1, 2, 3)]
    stacked = stack_np(rows)
    kw = dict(quantizer_noise_type="none", quantizer_type="ste", soft_round_temperature=0.3,
              training=training)
    if masked:
        want_dec, want_rate, _ = jax.vmap(
            lambda p, v: jcc.frame_forward(p, jcfg, valid_hw=v, **kw))(
                jax.tree.map(jnp.asarray, stacked), jnp.asarray(BATCH_HW))
    else:
        want_dec, want_rate, _ = jax.vmap(lambda p: jcc.frame_forward(p, jcfg, **kw))(
            jax.tree.map(jnp.asarray, stacked))
    valid_hws = torch.tensor(BATCH_HW) if masked else None
    got_dec, got_rate, extras = frame_forward(from_numpy_pytree(stacked, "cpu"), cfg,
                                              valid_hw=valid_hws, **kw)
    assert got_dec.shape == (3, 3, *BIG) and got_rate.shape == (3, cfg.n_latents)
    assert extras["flat_latent"].shape == (3, cfg.n_latents)
    for b, row in enumerate(rows):
        diff = np.abs(got_dec[b].numpy() - np.asarray(want_dec[b]))
        if training:
            np.testing.assert_allclose(got_dec[b].numpy(), np.asarray(want_dec[b]),
                                       rtol=1e-4, atol=1e-4)
        else:
            assert diff.max() <= 1.0 / 255.0 + 1e-6 and (diff > 1e-4).mean() <= 0.005
        # The quantized latents the JAX ARM saw (masked ones are zeros).
        y_hat = [jnp.round(jnp.asarray(a) * jcfg.encoder_gain) for a in row["latents"]]
        if masked:
            y_hat = [y * jmask.valid_mask_2d(y.shape[-2], y.shape[-1], *jmask.level_valid_hw(
                jnp.asarray(BATCH_HW[b]), lvl)) for lvl, y in enumerate(y_hat)]
        assert_rate_close(got_rate[b], want_rate[b], row, y_hat)
        one_dec, one_rate, _ = frame_forward(
            from_numpy_pytree(row, "cpu"), cfg, valid_hw=None if not masked else valid_hws[b],
            **kw)
        np.testing.assert_allclose(got_dec[b].numpy(), one_dec.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_rate[b].numpy(), one_rate.numpy(), rtol=1e-4, atol=1e-4)


def test_stack_and_unstack_params_round_trip():
    rows = [from_numpy_pytree(random_params(s), "cpu") for s in (1, 2)]
    stacked = stack_params(rows)
    want = from_numpy_pytree(stack_np([random_params(s) for s in (1, 2)]), "cpu")
    assert jax.tree.structure(to_numpy_pytree(stacked)) == jax.tree.structure(
        to_numpy_pytree(want))
    for g, w in zip(jax.tree.leaves(to_numpy_pytree(stacked)),
                    jax.tree.leaves(to_numpy_pytree(want))):
        np.testing.assert_array_equal(g, w)
    for back, row in zip(unstack_params(stacked), rows):
        for g, w in zip(jax.tree.leaves(to_numpy_pytree(back)),
                        jax.tree.leaves(to_numpy_pytree(row))):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dim_arm,n_hidden", [(8, 1), (24, 2), (16, 0)])
def test_batched_arm_rate_on_cpu_equals_per_row_plain(dim_arm, n_hidden):
    rng = np.random.default_rng(dim_arm + n_hidden)
    layers = [{"weight": 0.1 * rng.standard_normal((3, dim_arm, dim_arm)),
               "bias": 0.1 * rng.standard_normal((3, dim_arm))} for _ in range(n_hidden)]
    layers.append({"weight": 0.25 * rng.standard_normal((3, 2, dim_arm)),
                   "bias": 0.1 * rng.standard_normal((3, 2))})
    params = from_numpy_pytree({"layers": [{k: v.astype(np.float32) for k, v in layer.items()}
                                           for layer in layers]}, "cpu")
    latents = [torch.tensor(np.round(3 * rng.standard_normal((3, 1, h, w))).astype(np.float32))
               for h, w in ((9, 13), (5, 7), (3, 4))]
    got = arm_rate_pyramid_batch(latents, params, dim_arm, n_hidden)
    assert got.shape == (3, 9 * 13 + 5 * 7 + 3 * 4)
    for b, row in enumerate(unstack_params(params)):
        row_latents = [y[b] for y in latents]
        want = arm_rate_plain(row_latents, row, dim_arm)[0]
        np.testing.assert_allclose(got[b].numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(
            arm_rate_pyramid(row_latents, row, dim_arm, n_hidden).numpy(), want.numpy())
    with pytest.raises(ValueError):
        arm_rate_pyramid_batch([y[0] for y in latents], params, dim_arm, n_hidden)
    with pytest.raises(TypeError):
        arm_rate_pyramid_batch([y.double() for y in latents], params, dim_arm, n_hidden)


# --------------------------------------------------------------------------- #
# Phase engine
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("grad_scales", [(1e-3, 10.0), (10.0, 10.0)])
def test_per_image_clip_adam_matches_vmapped_optax(grad_scales):
    """Two images whose gradient norms lie on either side of the clip norm
    (or both above it): each is clipped by its own norm."""
    rng = np.random.default_rng(1)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.standard_normal((2, *s)).astype(np.float32) for s in shapes]
    scale = np.asarray(grad_scales, np.float32)
    grads = [[(scale.reshape(2, *[1] * len(s)) * rng.standard_normal((2, *s))).astype(np.float32)
              for s in shapes] for _ in range(3)]
    tx = jstep.make_optimizer()
    jparams = [jnp.asarray(p) for p in params]
    state = jax.vmap(tx.init)(jparams)
    tparams = [torch.tensor(p) for p in params]
    opt = tstep.AdamState.zeros(tparams)
    for g in grads:
        updates, state = jax.vmap(tx.update)([jnp.asarray(x) for x in g], state, jparams)
        jparams = optax.apply_updates(jparams, jax.tree.map(lambda u: -1e-2 * u, updates))
        tstep.clip_adam_update(tparams, [torch.tensor(x) for x in g], opt, 1e-2)
    assert opt.count.tolist() == [3, 3]
    for t, j in zip(tparams, jparams):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-7)
    for t, j in zip(opt.mu + opt.nu, list(state[1].mu) + list(state[1].nu)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-9)


def test_adam_count_is_per_image_after_a_reload():
    """Rows whose counts differ (one image reloaded alone) get each their
    own bias correction: equal to two separate single-image updates."""
    rng = np.random.default_rng(2)
    p = rng.standard_normal((2, 4)).astype(np.float32)
    g = [(0.01 * rng.standard_normal((2, 4))).astype(np.float32) for _ in range(3)]
    both = [torch.tensor(p)]
    opt = tstep.AdamState.zeros(both)
    fresh = opt.clone()
    tstep.clip_adam_update(both, [torch.tensor(g[0])], opt, 1e-2)
    opt.select_rows_(torch.tensor([False, True]), fresh)  # image 1 starts over
    assert opt.count.tolist() == [1, 0]
    tstep.clip_adam_update(both, [torch.tensor(g[1])], opt, 1e-2)
    assert opt.count.tolist() == [2, 1]
    row0, opt0 = [torch.tensor(p[:1])], None
    opt0 = tstep.AdamState.zeros(row0)
    for x in g[:2]:
        tstep.clip_adam_update(row0, [torch.tensor(x[:1])], opt0, 1e-2)
    row1 = [torch.tensor(p[1:])]
    tstep.clip_adam_update(row1, [torch.tensor(g[0][1:])], tstep.AdamState.zeros(row1), 1e-2)
    tstep.clip_adam_update(row1, [torch.tensor(g[1][1:])], tstep.AdamState.zeros(row1), 1e-2)
    np.testing.assert_allclose(both[0][0].numpy(), row0[0][0].numpy(), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(both[0][1].numpy(), row1[0][0].numpy(), rtol=1e-6, atol=1e-8)


PHASE_SEEDS = (2, 3, 4)
PHASE_LMBDAS = (1e-3, 0.0, 2e-2)


@pytest.mark.parametrize("schedule_lr", [True, False])
def test_batched_run_phase_matches_jax_vmap(schedule_lr, monkeypatch):
    """ste / no noise (deterministic), 3 blocks of 3 steps, patience 1 (under
    one block). Images 0 and 2 set a record at every block and train on.
    Image 1 cannot: its target is its own eval-mode decode and its lambda 0,
    so its first loss is 0. It is over patience at every block after the
    first, where it reloads its best params and Adam state alone
    (schedule_lr) or freezes alone (no schedule_lr)."""
    kw = dict(lr=2e-4, max_itr=9, freq_valid=3, patience=1, schedule_lr=schedule_lr,
              quantizer_type="ste", quantizer_noise_type="none",
              softround_temperature=(0.3, 0.2))
    arch = dict(ARCH, layers_synthesis=("8-1-linear-relu", "X-1-linear-none", "X-3-residual-none"))
    jcfg, cfg = JaxConfig(img_size=SMALL, **arch), CoolChicConfig(img_size=SMALL, **arch)
    rows = [random_params(s, SMALL) for s in PHASE_SEEDS]
    params = stack_np(rows)
    targets = np.stack([image(*SMALL, seed=s) for s in PHASE_SEEDS])
    targets[1] = frame_forward(from_numpy_pytree(rows[1], "cpu"), cfg, training=False)[0].numpy()
    jphase = jp.TrainerPhase(**kw)
    want_params, want_logs = jax.vmap(
        lambda p, t, l, k: jstep.run_phase(p, t, l, k, jcfg, jphase))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(targets),
            jnp.asarray(PHASE_LMBDAS, jnp.float32), jax.random.split(jax.random.PRNGKey(0), 3))

    masks = []
    select_rows = tstep.select_rows_
    monkeypatch.setattr(tstep, "select_rows_",
                        lambda dst, rows, src: (masks.append(rows.tolist()),
                                                select_rows(dst, rows, src))[1])
    start = from_numpy_pytree(params, "cpu")
    got_params, got_logs = tstep.run_phase_batch(
        start, torch.tensor(targets), PHASE_LMBDAS, cfg, TrainerPhase(**kw))

    # Records of images 0 and 2 only, and (schedule_lr) reloads of image 1 only.
    assert [True, False, True] in masks and [True, True, True] not in masks
    assert ([False, True, False] in masks) == schedule_lr
    # A frozen image stops counting steps.
    assert got_logs.n_train_steps.tolist() == ([9, 9, 9] if schedule_lr else [9, 3, 9])
    assert got_logs.n_batched_steps == 9 and got_logs.n_eval_forwards == 4
    assert got_logs.loss[1].item() == 0.0
    for got, want in ((got_logs.loss, want_logs.loss), (got_logs.psnr_db, want_logs.psnr_db),
                      (got_logs.rate_latent_bpp, want_logs.rate_latent_bpp)):
        assert got.shape == (3,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-9)
    for g, w in zip(jax.tree.leaves(to_numpy_pytree(got_params)), jax.tree.leaves(want_params)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-4)
    # Image 1's best params are the ones it started from; the others moved.
    for g, w in zip(jax.tree.leaves(to_numpy_pytree(got_params)), jax.tree.leaves(params)):
        np.testing.assert_array_equal(g[1], w[1])
    assert np.abs(to_numpy_pytree(got_params)["latents"][0][0] - params["latents"][0][0]).max() > 0
    # The input params are untouched.
    for g, w in zip(jax.tree.leaves(to_numpy_pytree(start)), jax.tree.leaves(params)):
        np.testing.assert_array_equal(g, w)


def test_batch_row_equals_single_run():
    """A batch row against the single-image run on that row after 60 steps
    (ste / no noise): the batched kernels sum in another order, and 60 Adam
    steps through a hard rounding amplify that, so the loss is held to 1e-2
    relative, the bound of the JAX package's own test of a vmapped row
    against the single run (tests/test_phase_segments.py)."""
    cfg = CoolChicConfig(img_size=SMALL, **ARCH)
    phase = TrainerPhase(lr=1e-2, max_itr=60, freq_valid=20, patience=10000, schedule_lr=True,
                         quantizer_type="ste", quantizer_noise_type="none",
                         softround_temperature=(0.3, 0.1))
    rows = [from_numpy_pytree(random_params(s, SMALL), "cpu") for s in (5, 6)]
    targets = torch.tensor(np.stack([image(*SMALL, seed=s) for s in (5, 6)]))
    _, logs = tstep.run_phase_batch(stack_params(rows), targets, [1e-3, 2e-3], cfg, phase)
    for b, lmbda in enumerate((1e-3, 2e-3)):
        _, one = tstep.run_phase(rows[b], targets[b], lmbda, cfg, phase)
        assert logs.loss[b].item() == pytest.approx(one.loss, rel=1e-2)
        assert one.n_train_steps == 60 and logs.n_train_steps[b].item() == 60


# --------------------------------------------------------------------------- #
# NN-quantization search and the encode
# --------------------------------------------------------------------------- #
def test_batched_quantize_model_matches_jax_vmap():
    cfg, jcfg = CoolChicConfig(img_size=BIG, **ARCH), JaxConfig(img_size=BIG, **ARCH)
    params = stack_np([random_params(s) for s in (5, 6)])
    hw = np.array([SMALL, BIG], np.int32)
    targets = np.stack([pad_to(image(*SMALL, seed=5), *BIG), image(*BIG, seed=6)])
    lmbdas = np.array([1e-3, 2e-2], np.float32)
    want_params, want_infos = jax.vmap(
        lambda p, t, l, v: jax_quantize_model(p, t, l, jcfg, valid_hw=v))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(targets), jnp.asarray(lmbdas),
            jnp.asarray(hw))
    got_params, got_infos, n_evals = quantize_model_batch(
        from_numpy_pytree(params, "cpu"), torch.tensor(targets), lmbdas, cfg, torch.tensor(hw))
    assert n_evals == 9 * 17 + 13 * 25 + 13 and len(got_infos) == 2
    for b in range(2):
        for module, want in want_infos.items():
            got = got_infos[b][module]
            assert got.q_step_w == float(want.q_step_w[b]), (b, module)
            assert got.q_step_b == float(want.q_step_b[b]), (b, module)
            assert (got.expgol_w, got.expgol_b) == (int(want.expgol_w[b]), int(want.expgol_b[b]))
            assert got.rate_bits == float(want.rate_bits[b])
    # The two images chose differently somewhere: the argmin is per image.
    assert any(got_infos[0][m][:2] != got_infos[1][m][:2] for m in got_infos[0])
    for g, w in zip(jax.tree.leaves(to_numpy_pytree(got_params)), jax.tree.leaves(want_params)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)


def tiny_preset():
    phase = TrainerPhase(lr=1e-2, max_itr=6, freq_valid=3, patience=100)
    return Preset(
        "tiny",
        all_phases=(
            phase,
            TrainerPhase(lr=1e-4, max_itr=2, freq_valid=2, quantize_model=True,
                         quantizer_type="ste", quantizer_noise_type="none"),
        ),
        warmup=Warmup((WarmupPhase(3, phase), WarmupPhase(2, phase))),
    )


def test_encode_frame_batch_mixed_sizes():
    """One batch holding two true sizes in a shared buffer, two lambdas."""
    cfg = CoolChicConfig(img_size=BIG, **ARCH)
    targets = torch.tensor(np.stack([pad_to(image(*SMALL, seed=1), *BIG), image(*BIG, seed=2)]))
    valid_hws = torch.tensor([SMALL, BIG])
    res, infos = encode_frame_batch(targets, [1e-3, 4e-3], cfg, tiny_preset(), seeds=[0, 1],
                                    valid_hws=valid_hws, with_quant_info=True)
    for values in (res.loss, res.psnr_db, res.rate_latent_bpp):
        assert values.shape == (2,) and torch.isfinite(values).all()
    assert res.psnr_db.min().item() > 10.0
    assert len(infos) == 2 and set(infos[0]) == {"arm", "synthesis", "upsampling"}
    for leaf, shape in zip(res.params["latents"], cfg.latent_shapes):
        assert tuple(leaf.shape) == (2, *shape)
    # Latents beyond image 0's true size took no gradient: still zero.
    assert res.params["latents"][0][0, :, SMALL[0]:, :].abs().max().item() == 0.0
    stats = res.stats
    # Per image-step: 2 images x (3 + 2 candidates) x 3 evals, 2 x (3 + 2), 2 x search.
    n_search = 9 * 17 + 13 * 25 + 13
    assert stats.n_eval_forwards == 2 * (5 * 3 + 3 + 2 + n_search)
    assert stats.n_train_steps == 2 * (5 * 6 + 6 + 2)
    # Per batch: each phase is one batched run, whatever its width.
    assert stats.n_batched_eval_forwards == 2 * 3 + 3 + 2 + n_search
    assert stats.n_batched_steps == 2 * 6 + 6 + 2
    assert list(stats.stage_seconds) == ["warmup", "phase_0", "phase_1", "quantize_model_1"]
    # The final metrics are those of the returned params, row by row.
    m = tstep.eval_metrics(res.params, cfg, targets, torch.tensor([1e-3, 4e-3]),
                           valid_hw=valid_hws)
    np.testing.assert_allclose(m.psnr_db.numpy(), res.psnr_db.numpy(), atol=0.3)


def test_encode_frame_takes_valid_hw():
    cfg = CoolChicConfig(img_size=BIG, **ARCH)
    target = torch.tensor(pad_to(image(*SMALL, seed=1), *BIG))
    res = encode_frame(target, 1e-3, cfg, tiny_preset(), seed=0, valid_hw=torch.tensor(SMALL))
    assert isinstance(res.loss, float) and np.isfinite(res.loss) and res.psnr_db > 10.0
    assert tuple(res.params["latents"][0].shape) == cfg.latent_shapes[0]
    assert res.params["latents"][0][:, SMALL[0]:, :].abs().max().item() == 0.0
