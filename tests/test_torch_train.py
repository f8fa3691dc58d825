"""Training engine of the PyTorch port vs the JAX package: schedules, the
clip + Adam update, one deterministic phase with patience, the
NN-quantization search, and a CPU encode through the warm-up.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances (both sides f32 on the CPU):
  * schedules: 1e-6 relative (the port computes them in float64);
  * clip + Adam: rtol = 1e-5, atol = 1e-7 (the same formula; the port
    scales the clipped gradient by 0.1/norm in one multiply, optax divides
    then multiplies);
  * one phase (10 steps): loss / PSNR / rate logs rtol = 1e-4, params
    atol = 1e-4 (Adam normalises each step, so an f32 difference in a
    gradient near zero can move a parameter by up to ~lr per step);
  * quantization search: identical q-steps and exp-Golomb orders, and the
    quantized params equal to 1e-6 (round(p / q) * q of the same inputs).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from coolchic_tpu.models.config import CoolChicConfig as JaxConfig
from coolchic_tpu.models.coolchic import init_coolchic_params as jax_init_params
from coolchic_tpu.train import presets as jp
from coolchic_tpu.train import step as jstep
from coolchic_tpu.train.quantize_model import expgol_bits_all_counts as jax_expgol
from coolchic_tpu.train.quantize_model import quantize_model_with_info as jax_quantize_model
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.params import from_numpy_pytree, to_numpy_pytree
from coolchic_tpu_torch.train import step as tstep
from coolchic_tpu_torch.train.encode import encode_frame_with_quant_info
from coolchic_tpu_torch.train.presets import Preset, TrainerPhase, Warmup, WarmupPhase
from coolchic_tpu_torch.train.quantize_model import expgol_bits_all_counts, quantize_model_with_info

ARCH = dict(img_size=(16, 24), n_ft_per_res=(1, 1, 1), dim_arm=8, n_hidden_layers_arm=1,
            layers_synthesis=("8-1-linear-relu", "X-1-linear-none", "X-3-residual-none"))


def target_np(seed=0):
    y, x = np.mgrid[0:16, 0:24] / 24.0
    rng = np.random.default_rng(seed)
    img = np.stack([x, y, 0.5 * (x + y)]) + 0.05 * rng.standard_normal((3, 16, 24))
    return np.clip(img, 0, 1).astype(np.float32)


def start_params(seed=0):
    """JAX init with non-zero latents and residual weights (numpy)."""
    params = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(seed), JaxConfig(**ARCH)))
    rng = np.random.default_rng(seed)
    params["latents"] = [(0.2 * rng.standard_normal(a.shape)).astype(np.float32)
                         for a in params["latents"]]
    params["arm"]["layers"][0]["weight"] = (
        0.1 * rng.standard_normal((8, 8))).astype(np.float32)
    return params


def test_schedules_match_jax():
    for t in (0, 3, 7, 10):
        np.testing.assert_allclose(tstep.linear_schedule(0.3, 0.1, t, 10),
                                   float(jstep._linear_schedule(0.3, 0.1, t, 10)), rtol=1e-6)
    for b in range(0, 12):
        np.testing.assert_allclose(tstep.cosine_lr(1e-2, 1e-5, b, 10.6),
                                   float(jstep._cosine_lr(1e-2, 1e-5, b, 10.6)), rtol=1e-6)
    phase = TrainerPhase(max_itr=250, freq_valid=100)
    assert tstep.phase_geometry(phase) == jstep._phase_geometry(
        jp.TrainerPhase(max_itr=250, freq_valid=100))


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])  # below / above the clip norm
def test_clip_adam_matches_optax(grad_scale):
    rng = np.random.default_rng(1)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(grad_scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]
             for _ in range(3)]
    tx = jstep.make_optimizer()
    jparams = [jnp.asarray(p) for p in params]
    state = tx.init(jparams)
    tparams = [torch.tensor(p)[None] for p in params]  # the batch of one image
    opt = tstep.AdamState.zeros(tparams)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jparams)
        jparams = [p - 1e-2 * u for p, u in zip(jparams, updates)]
        tstep.clip_adam_update(tparams, [torch.tensor(x)[None] for x in g], opt, 1e-2)
    assert opt.count.tolist() == [3]
    for t, j in zip(tparams, jparams):
        np.testing.assert_allclose(t[0].numpy(), np.asarray(j), rtol=1e-5, atol=1e-7)
    for t, j in zip(opt.mu + opt.nu, list(state[1].mu) + list(state[1].nu)):
        np.testing.assert_allclose(t[0].numpy(), np.asarray(j), rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("schedule_lr", [True, False])
def test_run_phase_matches_jax(schedule_lr):
    """ste / no noise (deterministic), 2 blocks of 5 steps, patience 0: the
    second block starts over patience, which reloads the best params and
    Adam state (schedule_lr) or ends the phase (no schedule_lr)."""
    kw = dict(lr=1e-3, max_itr=10, freq_valid=5, patience=0, schedule_lr=schedule_lr,
              quantizer_type="ste", quantizer_noise_type="none",
              softround_temperature=(0.3, 0.2))
    jcfg, cfg = JaxConfig(**ARCH), CoolChicConfig(**ARCH)
    params, target = start_params(2), target_np(2)
    want_params, want_logs = jstep.run_phase(
        jax.tree.map(jnp.asarray, params), jnp.asarray(target), 1e-3, jax.random.PRNGKey(0),
        jcfg, jp.TrainerPhase(**kw))
    got_params, got_logs = tstep.run_phase(
        from_numpy_pytree(params, "cpu"), torch.tensor(target), 1e-3, cfg, TrainerPhase(**kw))
    np.testing.assert_allclose(
        [got_logs.loss, got_logs.psnr_db, got_logs.rate_latent_bpp],
        [float(want_logs.loss), float(want_logs.psnr_db), float(want_logs.rate_latent_bpp)],
        rtol=1e-4)
    assert got_logs.n_eval_forwards == (3 if schedule_lr else 2)
    assert got_logs.n_train_steps == (10 if schedule_lr else 5)
    for g, w in zip(jax.tree.leaves(to_numpy_pytree(got_params)), jax.tree.leaves(want_params)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-4)
    # The phase trained something, and the input params are untouched.
    assert got_logs.loss != pytest.approx(tstep.eval_metrics(
        from_numpy_pytree(params, "cpu"), cfg, torch.tensor(target), 1e-3).loss.item(), rel=1e-6)


def test_latent_only_phase_leaves_networks_alone():
    cfg = CoolChicConfig(**ARCH)
    params = from_numpy_pytree(start_params(3), "cpu")
    phase = TrainerPhase(lr=1e-2, max_itr=6, freq_valid=3, quantizer_type="ste",
                         quantizer_noise_type="none", optimized_module=("latents",),
                         softround_temperature=(0.3, 0.3))
    best, logs = tstep.run_phase(params, torch.tensor(target_np(3)), 1e-3, cfg, phase)
    for key in ("arm", "upsampling", "synthesis"):
        for g, w in zip(jax.tree.leaves(to_numpy_pytree(best[key])),
                        jax.tree.leaves(to_numpy_pytree(params[key]))):
            np.testing.assert_array_equal(g, w)
    assert logs.n_train_steps == 6


def test_expgol_bits_match_jax():
    v = np.random.default_rng(4).integers(-300, 300, size=500).astype(np.float32)
    np.testing.assert_array_equal(expgol_bits_all_counts(torch.tensor(v)).numpy(),
                                  np.asarray(jax_expgol(jnp.asarray(v))))


def test_quantize_model_matches_jax():
    jcfg, cfg = JaxConfig(**ARCH), CoolChicConfig(**ARCH)
    params, target = start_params(5), target_np(5)
    want_params, want_infos = jax_quantize_model(
        jax.tree.map(jnp.asarray, params), jnp.asarray(target), 1e-3, jcfg)
    got_params, got_infos, n_evals = quantize_model_with_info(
        from_numpy_pytree(params, "cpu"), torch.tensor(target), 1e-3, cfg)
    assert n_evals == 9 * 17 + 13 * 25 + 13
    for module, want in want_infos.items():
        got = got_infos[module]
        assert got.q_step_w == float(want.q_step_w) and got.q_step_b == float(want.q_step_b)
        assert (got.expgol_w, got.expgol_b) == (int(want.expgol_w), int(want.expgol_b))
        assert got.rate_bits == float(want.rate_bits)
    for g, w in zip(jax.tree.leaves(to_numpy_pytree(got_params)), jax.tree.leaves(want_params)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)


def test_encode_runs_warmup_phases_and_quantization():
    """A tiny preset end to end on the CPU: counts of work and a result
    better than the start."""
    cfg = CoolChicConfig(**ARCH)
    phase = TrainerPhase(lr=1e-2, max_itr=6, freq_valid=3, patience=100)
    preset = Preset(
        "tiny",
        all_phases=(
            phase,
            TrainerPhase(lr=1e-4, max_itr=2, freq_valid=2, quantize_model=True,
                         quantizer_type="ste", quantizer_noise_type="none"),
        ),
        warmup=Warmup((WarmupPhase(3, phase), WarmupPhase(2, phase))),
    )
    target = torch.tensor(target_np(6))
    result, infos = encode_frame_with_quant_info(target, 1e-3, cfg, preset, seed=0)
    stats = result.stats
    assert set(infos) == {"arm", "synthesis", "upsampling"}
    # warm-up: 5 phases of 2 blocks, then 2 phases, then the search.
    assert stats.n_eval_forwards == 5 * 3 + 3 + 2 + (9 * 17 + 13 * 25 + 13)
    assert stats.n_train_steps == 5 * 6 + 6 + 2
    assert math.isfinite(result.loss) and result.psnr_db > 10.0
    assert list(stats.stage_seconds) == ["warmup", "phase_0", "phase_1", "quantize_model_1"]
