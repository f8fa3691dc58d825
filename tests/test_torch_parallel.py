"""Several ranks of the PyTorch port (``coolchic_tpu_torch/parallel/``) on the
CPU: gloo, world sizes 2 and 4, one process per rank started by
``parallel.launch``, at the tiny sizes of ``tests/test_parallel.py``.

- ``batched_train_step`` on W ranks, gathered, against the JAX package's
  ``batched_train_step(mesh=None)`` (its ``vmap`` over the images) and the
  port's one-process step, on a phase that draws no noise;
- ``encode_batch_sharded`` at W = 2 against ``encode_frame_batch`` on each
  rank's rows (a preset with noise: a rank draws its rows' noise) and, on a
  preset that draws no noise, against the one-process encode of the whole
  batch;
- ``train_wholenet(mesh=...)`` at W = 2 against W = 0, with the noise of the
  whole batch sliced to each rank, an eval and a checkpoint;
- the trainer's CLI with ``--data_parallel 2 --device cpu``, resumed;
- the raises.

What the ranks run is in ``torch_parallel_workers.py``. Every launch is made
once, in a module-scoped fixture, and shared by the tests that read it.

Tolerances: losses rtol 1e-6; a rank's encode equals the one-process encode
of its rows exactly (the same operations on the same rows); parameters after
Adam steps follow ``assert_moves_close``.
"""

import jax
import numpy as np
import pytest
import torch
import yaml

import torch_parallel_workers as workers
from coolchic_tpu.models.config import CoolChicConfig as JaxConfig
from coolchic_tpu.parallel import batched_train_step as jax_batched_train_step
from coolchic_tpu.parallel import init_batch_opt_state as jax_init_batch_opt_state
from coolchic_tpu.parallel import init_batch_params as jax_init_batch_params
from coolchic_tpu.train import presets as jp
from coolchic_tpu_torch import hypernet_train
from coolchic_tpu_torch.hypernet import NOWholeNet, WholeNetState, train_wholenet
from coolchic_tpu_torch.hypernet.inference import load_checkpoint
from coolchic_tpu_torch.hypernet.training import state_leaves
from coolchic_tpu_torch.metalearning import synthetic_batches
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.params import from_numpy_pytree, to_numpy_pytree
from coolchic_tpu_torch.parallel import (
    Mesh,
    batched_train_step,
    init_batch_opt_state,
    init_batch_params,
    launch,
    make_mesh,
    shard_leading_axis,
)
from coolchic_tpu_torch.train.encode import encode_frame_batch
from coolchic_tpu_torch.train.presets import Preset, TrainerPhase, Warmup, WarmupPhase

ARCH = dict(n_ft_per_res=(1, 1, 1), layers_synthesis=("8-1-linear-relu", "X-1-linear-none"),
            dim_arm=8, n_hidden_layers_arm=1)
CFG, JCFG = CoolChicConfig(img_size=(16, 16), **ARCH), JaxConfig(img_size=(16, 16), **ARCH)
BATCH = 4
LMBDAS = np.array([1e-3, 2e-3, 1e-3, 4e-3], np.float32)
SEEDS = [0, 1, 2, 3]
# One step that draws no noise (the two packages draw theirs differently).
NOISELESS = dict(quantizer_type="softround_alone", quantizer_noise_type="none")
STEP_LR = 1e-2
PHASE, JPHASE = (TrainerPhase(lr=STEP_LR, max_itr=1, **NOISELESS),
                 jp.TrainerPhase(lr=STEP_LR, max_itr=1, **NOISELESS))


def preset(noise: bool) -> Preset:
    """A short recipe (warm-up 3 -> 2 candidates, a training phase, a
    quantizing STE phase); without ``noise`` no stage draws any."""
    kw = {} if noise else NOISELESS
    phase = TrainerPhase(lr=1e-2, max_itr=6, freq_valid=3, patience=100, **kw)
    return Preset(
        "noisy" if noise else "noiseless",
        all_phases=(phase, TrainerPhase(lr=1e-4, max_itr=2, freq_valid=2, quantize_model=True,
                                        quantizer_type="ste", quantizer_noise_type="none")),
        warmup=Warmup((WarmupPhase(3, phase), WarmupPhase(2, phase))),
    )


def images(n, h, w, seed):
    return np.random.default_rng(seed).uniform(size=(n, 3, h, w)).astype(np.float32)


def assert_moves_close(got, want, lr, n_steps):
    """Parameters after ``n_steps`` Adam steps at ``lr`` (the rule of
    ``test_torch_hypernet_train.py::assert_states_close``): Adam's first
    steps move a parameter by about lr * sign(g), and where |g| is near eps a
    rounding difference moves it anywhere in (-lr, lr). So no parameter off
    by more than 2 lr a step, at most 1e-4 of them by more than 1 % of lr a
    step."""
    diff = np.concatenate([np.abs(np.asarray(a) - np.asarray(b)).ravel()
                           for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want))])
    assert diff.max() <= 2 * n_steps * lr, f"max abs parameter difference {diff.max()}"
    share = float((diff > 0.01 * n_steps * lr).mean())
    assert share <= 1e-4, f"{share} of the parameters off by more than 1 % of the steps"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- train step


@pytest.fixture(scope="module")
def step_runs():
    """One noiseless step of 4 decoders: JAX (vmap), the port in one
    process, and the port on 2 and on 4 ranks."""
    jparams = jax_init_batch_params(jax.random.PRNGKey(0), JCFG, BATCH, "normal")
    params = jax.tree.map(np.asarray, jparams)
    targets = images(BATCH, 16, 16, seed=1)
    jopt = jax_init_batch_opt_state(jparams, JCFG, JPHASE)
    jnew, _, jloss = jax_batched_train_step(
        jparams, jopt, jax.numpy.asarray(targets), jax.numpy.asarray(LMBDAS),
        jax.random.split(jax.random.PRNGKey(2), BATCH), JCFG, JPHASE)
    tparams = from_numpy_pytree(params, "cpu")
    tnew, _, tloss = batched_train_step(
        tparams, init_batch_opt_state(tparams, CFG, PHASE), torch.tensor(targets),
        torch.tensor(LMBDAS), None, CFG, PHASE)
    ranks = {2: launch(workers.train_step, 2, "cpu", params, targets, LMBDAS, CFG, PHASE)}
    # The ranks take the caller's TF32 / cuDNN switches: flip them for W = 4.
    switches = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, \
        torch.backends.cudnn.deterministic = (not v for v in switches)
    try:
        ranks[4] = launch(workers.train_step, 4, "cpu", params, targets, LMBDAS, CFG, PHASE)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, \
            torch.backends.cudnn.deterministic = switches
    ranks["switches"] = switches
    return {"jax": (jax.tree.map(np.asarray, jnew), float(jloss)),
            "port": (to_numpy_pytree(tnew), float(tloss)), "ranks": ranks}


def test_one_process_step_matches_jax_vmap(step_runs):
    (jparams, jloss), (tparams, tloss) = step_runs["jax"], step_runs["port"]
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert_moves_close(tparams, jparams, STEP_LR, 1)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_step_matches_one_process_and_jax(step_runs, world):
    params, loss, _ = step_runs["ranks"][world]
    (jparams, jloss), (tparams, tloss) = step_runs["jax"], step_runs["port"]
    np.testing.assert_allclose(loss, tloss, rtol=1e-6)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert_moves_close(params, tparams, STEP_LR, 1)
    assert_moves_close(params, jparams, STEP_LR, 1)


def test_ranks_take_the_callers_backend_switches(step_runs):
    switches = step_runs["ranks"]["switches"]
    assert step_runs["ranks"][2][2] == switches
    assert step_runs["ranks"][4][2] == tuple(not v for v in switches)


def test_init_batch_params_is_the_encoders_init():
    params = init_batch_params(SEEDS, CFG, BATCH, "normal", device="cpu")
    assert params["latents"][0].shape == (BATCH, *CFG.latent_shapes[0])
    res = encode_frame_batch(torch.tensor(images(1, 16, 16, 3)), [1e-3], CFG,
                             Preset("none", all_phases=()), [SEEDS[2]])
    for a, b in zip(to_numpy_pytree(res.params)["synthesis"],
                    to_numpy_pytree(init_batch_params([SEEDS[2]], CFG, 1, device="cpu"))[
                        "synthesis"]):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------- encode


@pytest.fixture(scope="module")
def encode_runs():
    """Both presets sharded over 2 ranks, and the one-process encodes: each
    rank's rows with noise, the whole batch without."""
    targets = images(BATCH, 16, 16, seed=4)
    sharded, same = launch(workers.encodes, 2, "cpu", targets, LMBDAS, CFG,
                           [preset(True), preset(False)], SEEDS)
    per_rank = [encode_frame_batch(torch.tensor(targets[r]), LMBDAS[r], CFG, preset(True),
                                   SEEDS[r], with_quant_info=True)
                for r in (slice(0, 2), slice(2, 4))]
    whole = encode_frame_batch(torch.tensor(targets), LMBDAS, CFG, preset(False), SEEDS,
                               with_quant_info=True)
    return {"sharded": sharded, "same_on_every_rank": same, "per_rank": per_rank,
            "whole": whole}


def test_sharded_encode_equals_each_ranks_rows(encode_runs):
    params, loss, psnr, rate, infos = encode_runs["sharded"][0]
    assert encode_runs["same_on_every_rank"]
    rows = [r for r, _ in encode_runs["per_rank"]]
    assert infos == [i for _, rank_infos in encode_runs["per_rank"] for i in rank_infos]
    np.testing.assert_array_equal(loss, np.concatenate([r.loss.numpy() for r in rows]))
    np.testing.assert_array_equal(psnr, np.concatenate([r.psnr_db.numpy() for r in rows]))
    np.testing.assert_array_equal(rate, np.concatenate([r.rate_latent_bpp.numpy() for r in rows]))
    want = jax.tree.map(lambda *xs: np.concatenate(xs), *[to_numpy_pytree(r.params) for r in rows])
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_sharded_noiseless_encode_equals_the_whole_batch(encode_runs):
    """Without noise a rank's rows train as they do in the whole batch; the
    two runs differ only in the batch the operations see, which leaves f32
    results within rounding (rtol 1e-5 on the metrics, 1e-4 on the params)."""
    params, loss, psnr, rate, infos = encode_runs["sharded"][1]
    whole, whole_infos = encode_runs["whole"]
    assert infos == whole_infos
    np.testing.assert_allclose(loss, whole.loss.numpy(), rtol=1e-5)
    np.testing.assert_allclose(psnr, whole.psnr_db.numpy(), rtol=1e-5)
    np.testing.assert_allclose(rate, whole.rate_latent_bpp.numpy(), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(to_numpy_pytree(whole.params))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


# --------------------------------------------------------------------------- hypernet training

HT_ARCH = dict(img_size=(32, 32), **ARCH)
HT_BATCH, HT_LR, HT_STEPS = 4, 1e-3, 3
HT_PHASE = TrainerPhase(lr=HT_LR, max_itr=1, schedule_lr=True, quantizer_type="softround",
                        quantizer_noise_type="gaussian", softround_temperature=(0.3, 0.2),
                        noise_parameter=(0.25, 0.1))


@pytest.fixture(scope="module")
def wholenet_runs(tmp_path_factory):
    """3 steps of a NO whole net (gaussian noise), validations every 2 steps
    and a checkpoint after 2: in one process, and on 2 ranks."""
    cfg = CoolChicConfig(**HT_ARCH)
    state = NOWholeNet(cfg, n_hidden_channels=8).init(0, device="cpu")
    weights = ({k: v.numpy() for k, v in state.hypernet.items()}, to_numpy_pytree(state.decoder))
    eval_imgs = next(synthetic_batches(HT_BATCH, (32, 32), seed=11))
    args = (cfg, 8, weights, HT_PHASE, 1e-3, HT_BATCH, HT_STEPS * HT_BATCH, 12, eval_imgs, 2)
    wd0, wd2 = tmp_path_factory.mktemp("w0"), tmp_path_factory.mktemp("w2")
    best, logs = train_wholenet(
        NOWholeNet(cfg, n_hidden_channels=8), state,
        synthetic_batches(HT_BATCH, (32, 32), seed=12), eval_imgs, lmbda=1e-3, phase=HT_PHASE,
        seed=2, n_samples=HT_STEPS * HT_BATCH, batch_size=HT_BATCH,
        freq_valid_samples=2 * HT_BATCH, verbose=False, workdir=wd0,
        checkpointing_freq_samples=2 * HT_BATCH)
    ranks = launch(workers.train_no_wholenet, 2, "cpu", *args, str(wd2), 2 * HT_BATCH)
    return {"one": (best, logs, wd0), "ranks": (*ranks, wd2)}


def flat_state(state):
    return [t.numpy() for t in state_leaves(state)]


def test_data_parallel_train_wholenet_matches_one_device(wholenet_runs):
    best, logs, wd0 = wholenet_runs["one"]
    (hyper, dec), rank_logs, same, wd2 = wholenet_runs["ranks"]
    assert same, "the ranks' best states differ"
    assert [l.samples_seen for l in rank_logs] == [l.samples_seen for l in logs] == [8, 12]
    for a, b in zip(rank_logs, logs):
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-6)
        np.testing.assert_allclose(a.eval_loss, b.eval_loss, rtol=1e-6)
        np.testing.assert_allclose(a.eval_psnr_db, b.eval_psnr_db, rtol=1e-6)
        np.testing.assert_allclose(a.eval_rate_bpp, b.eval_rate_bpp, rtol=1e-6)
    got = WholeNetState({k: torch.tensor(v) for k, v in hyper.items()},
                        from_numpy_pytree(dec, "cpu"))
    assert_moves_close(flat_state(got), flat_state(best), HT_LR, HT_STEPS)
    # Rank 0 wrote the one checkpoint; it holds the one-device run's state.
    assert sorted(p.name for p in wd2.iterdir()) == sorted(p.name for p in wd0.iterdir()) == [
        f"samples_{2 * HT_BATCH}.pkl"]
    assert_moves_close(flat_state(load_checkpoint(wd2, device="cpu")),
                       flat_state(load_checkpoint(wd0, device="cpu")), HT_LR, 2)


RUN_CFG = {
    "n_samples": 8,
    "batch_size": 4,
    "lmbda": "1e-3",
    "recipe": {"preset_name": "hnet_test", "warmup": {"phases": []}, "all_phases": [
        {"lr": "1e-3", "max_itr": 1, "schedule_lr": True, "quantizer_type": "softround",
         "quantizer_noise_type": "gaussian", "softround_temperature": [0.3, 0.2],
         "noise_parameter": [0.25, 0.1]}]},
    "hypernet_cfg": {
        "dec_cfg": {"layers_synthesis": "8-1-linear-relu,X-1-linear-none", "arm": "8,1",
                    "n_ft_per_res": "1,1,1"},
        "n_hidden_channels": 8, "patch_size": [32, 32]},
}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The trainer's CLI, ``--mode no`` for 2 steps with a checkpoint each
    step, then ``--resume`` to 3 steps: with ``--data_parallel 0`` and 2."""
    root = tmp_path_factory.mktemp("cli")
    path = root / "hnet.yaml"
    path.write_text(yaml.safe_dump(RUN_CFG))
    base = ["--config", str(path), "--synthetic", "--device", "cpu", "--disable_wandb",
            "--mode", "no", "--checkpointing_freq", "4"]
    out = {}
    for dp in (0, 2):
        wd = root / f"dp{dp}"
        args = base + ["--data_parallel", str(dp), "--workdir", str(wd)]
        assert hypernet_train.main(args) == 0
        first = sorted(p.name for p in wd.iterdir())
        assert hypernet_train.main(args + ["--resume", "--n_samples", "12"]) == 0
        out[dp] = (wd, first, sorted(p.name for p in wd.iterdir()))
    return out


def test_cli_data_parallel_runs_and_resumes(cli_runs):
    (wd0, first0, last0), (wd2, first2, last2) = cli_runs[0], cli_runs[2]
    assert first2 == first0 == ["samples_4.pkl", "samples_8.pkl"]
    assert last2 == last0 == ["samples_12.pkl", "samples_4.pkl", "samples_8.pkl"]
    for name, n_steps in (("samples_8.pkl", 2), ("samples_12.pkl", 3)):
        assert_moves_close(flat_state(load_checkpoint(wd2 / name, device="cpu")),
                           flat_state(load_checkpoint(wd0 / name, device="cpu")), 1e-3, n_steps)


# --------------------------------------------------------------------------- raises


def test_batch_not_divisible_raises():
    mesh = Mesh(rank=0, world_size=3, device=torch.device("cpu"), backend="gloo", group=None)
    with pytest.raises(ValueError, match="does not split over 3"):
        shard_leading_axis({"x": torch.zeros(4, 2)}, mesh)
    assert shard_leading_axis({"x": torch.arange(6)}, mesh)["x"].tolist() == [0, 1]


def test_too_many_gpus_raise():
    with pytest.raises(RuntimeError, match="GPUs"):
        launch(workers.train_step, torch.cuda.device_count() + 1, "cuda")
    with pytest.raises(RuntimeError, match="GPUs"):
        hypernet_train.main(["--synthetic", "--device", "cuda", "--disable_wandb",
                             "--batch_size", str(torch.cuda.device_count() + 1),
                             "--data_parallel", str(torch.cuda.device_count() + 1)])


def test_make_mesh_without_a_group_raises():
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh()
