"""Hypernet training of the PyTorch port against the JAX package, at the small
widths of ``tests/test_hypernet.py`` (32x32, 3 grids, dim_arm 8, a resnet18
backbone, 8 hidden channels in the latent encoder, heads 32 / 16 wide of one
layer): the data streams, the batch loss's gradient, the optimizer (one
global-norm clip at 1.0 and one Adam over every leaf), the train step with
its frozen backbone and its gradient accumulation, the evaluation, the train
loop with validation, patience and resume, checkpoints both ways, the CLI
and the configs, and ``iterations_to_match``.

Weights: the port's init of the hypernet (flax's distributions) and JAX's of
the decoder, every leaf then perturbed with a seeded numpy draw (at init the
delta heads output exact zeros and the gradients of their hidden layers are
zero), the same numpy arrays on both sides. Images: ``synthetic_batches``
from seeds. The quantizer is deterministic (``quantizer_type =
quantizer_noise_type = "none"``): JAX draws its noise per image from keys,
the port from a generator, and no two draws agree.

Tolerances (f32 on the CPU): losses and eval metrics rtol 1e-4; gradients
rtol 1e-4, atol 1e-6; rates by ``models.arm.rate_tolerance``; parameters
after Adam steps: see ``assert_states_close``. The JAX side's jitted steps
are built once per (net, quantizer, freeze, accumulation) and shared by the
tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from coolchic_tpu.eval.hypernet import iterations_to_match as jax_iterations_to_match
from coolchic_tpu.hypernet import inference as jinf
from coolchic_tpu.hypernet import training as jtraining
from coolchic_tpu.hypernet.wholenet import DeltaWholeNet as JaxDelta
from coolchic_tpu.hypernet.wholenet import NOWholeNet as JaxNO
from coolchic_tpu.hypernet.wholenet import WholeNetState as JaxState
from coolchic_tpu.io import write_png
from coolchic_tpu.metalearning import data as jdata
from coolchic_tpu.models.config import CoolChicConfig as JaxConfig
from coolchic_tpu.models.coolchic import init_coolchic_params as jax_init_params
from coolchic_tpu.train import presets as jp
from coolchic_tpu.utils.types import HypernetRunConfig as JaxRunConfig
from coolchic_tpu.utils.types import load_config as jax_load_config
from coolchic_tpu_torch import hypernet as thypernet
from coolchic_tpu_torch import hypernet_train
from coolchic_tpu_torch.eval.hypernet import iterations_to_match
from coolchic_tpu_torch.hypernet import DeltaWholeNet, NOWholeNet, WholeNetState
from coolchic_tpu_torch.hypernet import inference as tinf
from coolchic_tpu_torch.hypernet import training as ttraining
from coolchic_tpu_torch.hypernet.blocks import init_params
from coolchic_tpu_torch.hypernet.bridge import flax_to_state_dict, state_dict_to_flax
from coolchic_tpu_torch.metalearning import data as tdata
from coolchic_tpu_torch.models.arm import arm_rate_plain, rate_tolerance
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.params import from_numpy_pytree, to_numpy_pytree, tree_map
from coolchic_tpu_torch.train.presets import TrainerPhase
from coolchic_tpu_torch.utils.types import HypernetRunConfig, load_config

ARCH = dict(img_size=(32, 32), n_ft_per_res=(1, 1, 1),
            layers_synthesis=("8-1-linear-relu", "X-1-linear-none"), dim_arm=8,
            n_hidden_layers_arm=1)
JCFG, TCFG = JaxConfig(**ARCH), CoolChicConfig(**ARCH)
HN_KW = dict(synthesis_hidden_dim=32, synthesis_n_layers=1, arm_hidden_dim=32, arm_n_layers=1,
             ups_hidden_dim=16, ups_n_layers=1)
LMBDA = 1e-3
BATCH = 2
# The deterministic quantizer (see the module docstring).
DET = dict(quantizer_type="none", quantizer_noise_type="none",
           softround_temperature=(0.3, 0.3), noise_parameter=(0.0, 0.0))
LR = 1e-4
PHASE_T, PHASE_J = TrainerPhase(lr=LR, max_itr=1, **DET), jp.TrainerPhase(lr=LR, max_itr=1, **DET)
LOOP_LR = 2e-2  # large enough that an eval loss rises mid-run and the patience fires
TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small convolutions gain nothing from intra-op threads, and test
    processes that each spin a thread per core slow each other down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def perturb(tree, seed, scale=0.01):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(np.shape(a))).astype(np.float32),
        tree)


def batches(seed, n=1, batch=BATCH):
    it = tdata.synthetic_batches(batch, (32, 32), seed=seed)
    return [next(it) for _ in range(n)]


def flat(hypernet_tree, decoder_tree):
    """{path: array} of a state in flax's names and layouts."""
    leaves = jax.tree_util.tree_flatten_with_path({"h": hypernet_tree, "d": decoder_tree})[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def flat_port(state):
    return flat(state_dict_to_flax(state.hypernet), to_numpy_pytree(state.decoder))


def flat_jax(state):
    return flat(jax.tree.map(np.asarray, state.hypernet), jax.tree.map(np.asarray, state.decoder))


@pytest.fixture(scope="module")
def side():
    """The JAX nets and the numpy weights both sides start from; the JAX
    package's ``make_wholenet_train_step`` memoized, so that every test and
    every ``train_wholenet`` call shares one jitted step per kind."""
    td = DeltaWholeNet(TCFG, backbone_arch="resnet18", n_hidden_channels=8, **HN_KW)
    # The port's init draws flax's distributions (tests/test_torch_hypernet.py)
    # and costs no resnet18 compile.
    hyper = state_dict_to_flax(init_params(td.module, torch.Generator().manual_seed(0), "cpu"))
    dec = {k: v for k, v in jax_init_params(jax.random.PRNGKey(1), JCFG).items() if k != "latents"}
    hyper, dec = perturb(hyper, 0), perturb(dec, 1)
    weights = {"delta": (hyper, dec), "no": (hyper["LatentHyperNet_0"], dec)}
    nets = {"delta": (JaxDelta(JCFG, backbone_arch="resnet18", n_hidden_channels=8, **HN_KW), td),
            "no": (JaxNO(JCFG, n_hidden_channels=8), NOWholeNet(TCFG, n_hidden_channels=8))}

    cache = {}
    make = jtraining.make_wholenet_train_step

    def memo(net, phase, freeze_backbone=False, grad_accumulation_steps=1):
        key = (id(net), phase.quantizer_type, phase.quantizer_noise_type, freeze_backbone,
               grad_accumulation_steps)
        if key not in cache:
            cache[key] = make(net, phase, freeze_backbone, grad_accumulation_steps)
        return cache[key]

    mp = pytest.MonkeyPatch()
    mp.setattr(jtraining, "make_wholenet_train_step", memo)
    yield {"weights": weights, "nets": nets, "jax_step": memo}
    mp.undo()


def states(side, name):
    """(JAX state, a fresh port state) with the same weights."""
    hyper, dec = side["weights"][name]
    return (JaxState(hypernet=hyper, decoder=dec),
            WholeNetState(flax_to_state_dict(hyper), from_numpy_pytree(dec, "cpu")))


def assert_states_close(tstate, jstate, lr, n_steps):
    """Parameters after ``n_steps`` Adam steps at ``lr``. Adam's first steps
    move a parameter by g / (|g| + eps) * lr, about lr * sign(g), whatever
    |g| is; where |g| is near eps (1e-8, after the clip; some 3e-5 of the
    resnet18's weights here) a float-rounding difference between the two
    frameworks' gradients moves it anywhere in (-lr, lr). So: no parameter
    off by more than 2 lr a step (a flip), and at most 1e-4 of them by more
    than 1 % of lr a step."""
    got, want = flat_port(tstate), flat_jax(jstate)
    assert got.keys() == want.keys()
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in got])
    assert diff.max() <= 2 * n_steps * lr, f"max abs parameter difference {diff.max()}"
    share = float((diff > 0.01 * n_steps * lr).mean())
    assert share <= 1e-4, f"{share} of the parameters off by more than 1 % of the steps"


# --------------------------------------------------------------------------- data


def test_synthetic_batches_equal_jax():
    for seed, patch, batch in ((0, (32, 32), 2), (3, (16, 48), 3)):
        jit, tit = jdata.synthetic_batches(batch, patch, seed), tdata.synthetic_batches(
            batch, patch, seed)
        for _ in range(3):
            a, b = next(tit), next(jit)
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_patch_dataset_and_split_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(40, 52), (24, 20), (33, 64), (32, 32), (50, 31)]):
        write_png(rng.uniform(size=(3, h, w)).astype(np.float32), str(tmp_path / f"img_{i}.png"))
    (tmp_path / "notes.txt").write_text("not an image")
    tds = tdata.PatchDataset.from_dir(tmp_path, (32, 32), seed=4)
    jds = jdata.PatchDataset.from_dir(tmp_path, (32, 32), seed=4)
    assert tds.paths == jds.paths and len(tds) == 5
    for i in range(7):  # past the end wraps around, and the smaller images are reflect-padded
        assert np.array_equal(tds[i], jds[i])
    tb, jb = tds.batches(3), jds.batches(3)
    for _ in range(2):
        assert np.array_equal(next(tb), next(jb))
    for n in (5, 25, 700):  # at most 10 %, at most N_MAX_TEST
        paths = [tmp_path / f"p{rng.integers(1e6)}.png" for _ in range(n)]
        assert tdata.train_test_split(paths) == jdata.train_test_split(paths)
    assert tdata.N_MAX_TEST == jdata.N_MAX_TEST


# --------------------------------------------------------------------------- step


@pytest.mark.parametrize("name", ["no", "delta"])
def test_batch_loss_gradient_matches_jax(side, name):
    """Holds the summed gradient of the NO net's expanded shared decoder."""
    jnet, tnet = side["nets"][name]
    jstate, tstate = states(side, name)
    imgs = batches(5)[0]
    want_loss, want = jax.jit(jax.value_and_grad(lambda s: jtraining._batch_loss(
        jnet, s, jnp.asarray(imgs), LMBDA, None, "none", "none", 0.3, 0.0)))(jstate)
    leaves = ttraining.state_leaves(tstate)
    for t in leaves:
        t.requires_grad_(True)
    loss = ttraining._batch_loss(tnet, tstate, torch.tensor(imgs), LMBDA, "none", "none", 0.3, 0.0)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    keys = list(tstate.hypernet)
    dec_grads = iter(grads[len(keys):])
    gstate = WholeNetState(dict(zip(keys, grads[:len(keys)])),
                           tree_map(lambda _: next(dec_grads), tstate.decoder))
    got, ref = flat_port(gstate), flat_jax(want)
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **TOL)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("norm", [0.3, 30.0])
def test_clip_adam_matches_optax(k, norm):
    """One clip(1.0) + Adam over every leaf, below and above the norm; with
    k = 2 in optax.MultiSteps (the parameters move on every second call)."""
    rng = np.random.default_rng(int(norm * 10) + k)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": [rng.standard_normal(7).astype(np.float32)]}
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.scale_by_adam())
    if k > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=k)
    jopt, jp_ = tx.init(params), params
    tparams = from_numpy_pytree(params, "cpu")
    leaves = [tparams["a"], tparams["b"][0]]
    opt, topt = ttraining.WholeNetOptimizer(k), ttraining.WholeNetOptState(leaves, k)
    for step in range(4):
        g = {"a": rng.standard_normal((5, 3)).astype(np.float32),
             "b": [rng.standard_normal(7).astype(np.float32)]}
        scale = norm / np.sqrt(sum(float((x ** 2).sum()) for x in jax.tree.leaves(g)))
        g = jax.tree.map(lambda x: (x * scale).astype(np.float32), g)
        upd, jopt = tx.update(g, jopt, jp_)
        jp_ = jax.tree.map(lambda p, u: p - 1e-2 * u, jp_, upd)
        before = [t.clone() for t in leaves]
        opt.update_(leaves, [torch.tensor(g["a"]), torch.tensor(g["b"][0])], topt, 1e-2)
        if k > 1 and step % k == 0:
            assert all(torch.equal(a, b) for a, b in zip(before, leaves))
        np.testing.assert_allclose(leaves[0].numpy(), np.asarray(jp_["a"]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(leaves[1].numpy(), np.asarray(jp_["b"][0]), rtol=1e-6,
                                   atol=1e-7)
    assert topt.count == 4 // k


def test_two_train_steps_match_jax(side):
    jnet, tnet = side["nets"]["delta"]
    jstate, tstate = states(side, "delta")
    b1, b2 = batches(6, 2)
    tx, jstep = side["jax_step"](jnet, PHASE_J)
    jopt = tx.init(jstate)
    ttx, tstep = ttraining.make_wholenet_train_step(tnet, PHASE_T)
    topt = ttx.init(tstate)
    for n, b in enumerate((b1, b2), 1):
        jstate, jopt, jloss = jstep(jstate, jopt, jnp.asarray(b), LMBDA, jax.random.PRNGKey(0),
                                    LR, 0.3, 0.0)
        tstate, topt, tloss = tstep(tstate, topt, torch.tensor(b), LMBDA, None, LR, 0.3, 0.0)
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4)
        assert_states_close(tstate, jstate, LR, n)
    assert topt.count == int(jopt[1].count) == 2


def test_freeze_backbone_matches_jax(side):
    """Frozen: the ResNet_0 tensors do not move, the others match JAX; after
    the switch to unfrozen (the optimizer state carried over) all match."""
    jnet, tnet = side["nets"]["delta"]
    jstate, tstate = states(side, "delta")
    init = flat_port(tstate)
    b1, b2 = batches(7, 2)
    txf, jfrozen = side["jax_step"](jnet, PHASE_J, freeze_backbone=True)
    _, jfree = side["jax_step"](jnet, PHASE_J)
    jopt = txf.init(jstate)
    ttx, tfrozen = ttraining.make_wholenet_train_step(tnet, PHASE_T, freeze_backbone=True)
    _, tfree = ttraining.make_wholenet_train_step(tnet, PHASE_T)
    topt = ttx.init(tstate)
    key = jax.random.PRNGKey(0)
    jstate, jopt, _ = jfrozen(jstate, jopt, jnp.asarray(b1), LMBDA, key, LR, 0.3, 0.0)
    tstate, topt, _ = tfrozen(tstate, topt, torch.tensor(b1), LMBDA, None, LR, 0.3, 0.0)
    got = flat_port(tstate)
    resnet = [k for k in got if k.startswith("['h']['ResNet_0']")]
    assert resnet and all(np.array_equal(got[k], init[k]) for k in resnet)
    assert any(not np.array_equal(got[k], init[k]) for k in got if k not in resnet)
    assert_states_close(tstate, jstate, LR, 1)
    jstate, jopt, jloss = jfree(jstate, jopt, jnp.asarray(b2), LMBDA, key, LR, 0.3, 0.0)
    tstate, topt, tloss = tfree(tstate, topt, torch.tensor(b2), LMBDA, None, LR, 0.3, 0.0)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4)
    got = flat_port(tstate)
    assert any(not np.array_equal(got[k], init[k]) for k in resnet)
    assert_states_close(tstate, jstate, LR, 2)
    assert topt.count == 2


def test_grad_accumulation_matches_jax_multisteps(side):
    """k = 2: the first call leaves the parameters as they are, the second
    matches JAX's MultiSteps, and equals one step on the joined batch."""
    jnet, tnet = side["nets"]["no"]
    jstate, tstate = states(side, "no")
    init = flat_port(tstate)
    b1, b2 = batches(8, 2)
    tx, jstep = side["jax_step"](jnet, PHASE_J, grad_accumulation_steps=2)
    jopt = tx.init(jstate)
    ttx, tstep = ttraining.make_wholenet_train_step(tnet, PHASE_T, grad_accumulation_steps=2)
    topt = ttx.init(tstate)
    key = jax.random.PRNGKey(0)
    for n, b in enumerate((b1, b2)):
        jstate, jopt, jloss = jstep(jstate, jopt, jnp.asarray(b), LMBDA, key, LR, 0.3, 0.0)
        tstate, topt, tloss = tstep(tstate, topt, torch.tensor(b), LMBDA, None, LR, 0.3, 0.0)
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4)  # the micro-batch's
        if n == 0:
            got = flat_port(tstate)
            assert all(np.array_equal(got[k], init[k]) for k in got)
    assert topt.count == 1
    assert_states_close(tstate, jstate, LR, 1)
    _, joined = states(side, "no")
    jtx, jstep1 = ttraining.make_wholenet_train_step(tnet, PHASE_T)
    joined, _, _ = jstep1(joined, jtx.init(joined), torch.tensor(np.concatenate([b1, b2])),
                          LMBDA, None, LR, 0.3, 0.0)
    got, want = flat_port(tstate), flat_port(joined)
    assert max(float(np.abs(got[k] - want[k]).max()) for k in got) <= 0.01 * LR


def rate_bound_bpp(tnet, tstate, imgs):
    """The mean over the batch of each image's summed ``rate_tolerance`` (from
    the plain ARM's Laplace scales), in bits per pixel."""
    with torch.no_grad():
        latents, deltas = tnet.predict(tstate, torch.tensor(imgs))
        arm = tnet._nets(tstate, deltas)["arm"]
        y_hat = [torch.round(y * TCFG.encoder_gain) for y in latents]
        log_scale = arm_rate_plain(y_hat, arm, TCFG.dim_arm)[2]
        _, rate = tnet.forward(tstate, torch.tensor(imgs), training=False)
    scale = torch.exp(torch.clamp(log_scale - 4.0, -4.6, 5.0))
    return float(rate_tolerance(rate, scale).sum(-1).mean()) / TCFG.n_pixels


def test_evaluate_wholenet_matches_jax(side):
    jnet, tnet = side["nets"]["delta"]
    jstate, tstate = states(side, "delta")
    imgs = batches(9, batch=3)[0]
    want = jtraining.evaluate_wholenet(jnet, jstate, jnp.asarray(imgs), LMBDA)
    got = ttraining.evaluate_wholenet(tnet, tstate, torch.tensor(imgs), LMBDA)
    for k in ("loss", "psnr_db"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4)
    bound = rate_bound_bpp(tnet, tstate, imgs)
    assert abs(got["rate_latent_bpp"].item() - float(want["rate_latent_bpp"])) <= bound


# --------------------------------------------------------------------------- loop


def run_both(side, name, n_samples, patience, samples_offset=0, start=None, workdir=None):
    """train_wholenet on both sides from the same weights (or checkpoint
    ``start``): validation every 2 steps, the given patience."""
    jnet, tnet = side["nets"][name]
    jstate, tstate = states(side, name)
    if start is not None:
        jstate, _ = jinf.load_checkpoint_meta(start)
        tstate, _ = tinf.load_checkpoint_meta(start, device="cpu")
    phase_j = jp.TrainerPhase(lr=LOOP_LR, max_itr=1, schedule_lr=True, **DET)
    phase_t = TrainerPhase(lr=LOOP_LR, max_itr=1, schedule_lr=True, **DET)
    eval_imgs = batches(11, batch=3)[0]
    kw = dict(lmbda=LMBDA, n_samples=n_samples, batch_size=BATCH, freq_valid_samples=2 * BATCH,
              patience_samples=patience, verbose=False, samples_offset=samples_offset)
    jbest, jlogs = jtraining.train_wholenet(
        jnet, jstate, tdata.synthetic_batches(BATCH, (32, 32), 12), jnp.asarray(eval_imgs),
        phase=phase_j, key=jax.random.PRNGKey(2), **kw)
    tbest, tlogs = ttraining.train_wholenet(
        tnet, tstate, tdata.synthetic_batches(BATCH, (32, 32), 12), eval_imgs, phase=phase_t,
        seed=2, workdir=workdir, checkpointing_freq_samples=4 * BATCH if workdir else None, **kw)
    return (jbest, jlogs), (tbest, tlogs)


def assert_logs_equal(tlogs, jlogs):
    assert [l.samples_seen for l in tlogs] == [l.samples_seen for l in jlogs]
    for t, j in zip(tlogs, jlogs):
        np.testing.assert_allclose(t.loss, j.loss, rtol=1e-4)
        np.testing.assert_allclose(t.eval_loss, j.eval_loss, rtol=1e-4)
        np.testing.assert_allclose(t.eval_psnr_db, j.eval_psnr_db, rtol=1e-4)
    assert int(np.argmin([l.eval_loss for l in tlogs])) == int(np.argmin(
        [l.eval_loss for l in jlogs]))


@pytest.fixture(scope="module")
def loop(side, tmp_path_factory):
    """12 steps of the NO net with patience 1 step (fires whenever a
    validation sets no record), checkpoints every 4 steps from the port."""
    workdir = tmp_path_factory.mktemp("loop")
    jax_run, port_run = run_both(side, "no", n_samples=12 * BATCH, patience=BATCH,
                                 workdir=workdir)
    return {"jax": jax_run, "port": port_run, "workdir": workdir}


def test_train_wholenet_matches_jax(side, loop):
    (jbest, jlogs), (tbest, tlogs) = loop["jax"], loop["port"]
    assert [l.samples_seen for l in tlogs] == [4, 8, 12, 16, 20, 24]
    # The patience fired before the end: a validation without a record, more
    # than one step after the record (JAX's rule, read off JAX's own logs).
    losses = [l.eval_loss for l in jlogs]
    assert any(losses[i] >= min(losses[:i]) for i in range(1, len(losses) - 1))
    assert_logs_equal(tlogs, jlogs)
    assert_states_close(tbest, jbest, LOOP_LR, 12)


def test_resume_from_port_checkpoint_matches_jax(side, loop):
    """Both resume from the port's ``samples_8.pkl`` (4 steps in) to 12 steps:
    the data stream skips 4 batches, the schedules run on the global clock."""
    ckpt = loop["workdir"] / f"samples_{4 * BATCH}.pkl"
    assert sorted(p.name for p in loop["workdir"].iterdir()) == [
        "samples_16.pkl", "samples_24.pkl", "samples_8.pkl"]
    (_, jlogs), (_, tlogs) = run_both(side, "no", n_samples=12 * BATCH, patience=None,
                                      samples_offset=4 * BATCH, start=ckpt)
    assert [l.samples_seen for l in tlogs] == [12, 16, 20, 24]
    assert_logs_equal(tlogs, jlogs)


def test_checkpoints_load_both_ways(side, tmp_path):
    jstate, tstate = states(side, "delta")
    tinf.save_checkpoint(tstate, tmp_path / "port" / "samples_6.pkl", 6)
    got, n = jinf.load_checkpoint_meta(tmp_path / "port")
    assert n == 6
    assert all(np.array_equal(a, b) for a, b in zip(flat_jax(got).values(),
                                                   flat_jax(jstate).values()))
    jinf.save_checkpoint(jstate, tmp_path / "jax" / "samples_10.pkl", 10)
    jinf.save_checkpoint(jstate, tmp_path / "jax" / "samples_4.pkl", 4)
    back, n = tinf.load_checkpoint_meta(tmp_path / "jax", device="cpu")
    assert n == 10  # the __latest rule
    assert all(np.array_equal(a, b) for a, b in zip(flat_port(back).values(),
                                                   flat_port(tstate).values()))


# --------------------------------------------------------------------------- CLI


RUN_CFG = {
    "n_samples": 4,
    "batch_size": 2,
    "lmbda": "2e-3",
    "unfreeze_backbone": 2,
    "recipe": {"preset_name": "hnet_test", "warmup": {"phases": []}, "all_phases": [
        {"lr": "1e-4", "max_itr": 1, "schedule_lr": True, "quantizer_type": "softround",
         "quantizer_noise_type": "gaussian", "softround_temperature": [0.3, 0.2],
         "noise_parameter": [0.25, 0.1]}]},
    "hypernet_cfg": {
        "dec_cfg": {"layers_synthesis": "8-1-linear-relu,X-1-linear-none", "arm": "8,1",
                    "n_ft_per_res": "1,1,1"},
        "synthesis": {"hidden_dim": 32, "n_layers": 1, "only_biases": True},
        "arm": {"hidden_dim": 32, "n_layers": 1},
        "n_hidden_channels": 8, "patch_size": [32, 32]},
}


def test_hypernet_run_config_reads_as_jax(tmp_path):
    path = tmp_path / "hnet.yaml"
    path.write_text(yaml.safe_dump(RUN_CFG))
    got, want = load_config(path, HypernetRunConfig), jax_load_config(path, JaxRunConfig)
    for k in ("n_samples", "batch_size", "lmbda", "unfreeze_backbone", "workdir",
              "disable_wandb"):
        assert getattr(got, k) == getattr(want, k), k
    gh, wh = got.hypernet_cfg, want.hypernet_cfg
    for k in ("backbone_arch", "double_backbone", "n_hidden_channels", "patch_size", "n_latents"):
        assert getattr(gh, k) == getattr(wh, k), k
    for head in ("synthesis", "arm", "upsampling"):
        assert vars(getattr(gh, head)) == getattr(wh, head).model_dump(), head
    assert gh.dec_cfg.to_coolchic_config((32, 32)) == CoolChicConfig(
        **vars(wh.dec_cfg.to_coolchic_config((32, 32))))
    assert got.recipe.all_phases[0] == TrainerPhase(**vars(want.recipe.all_phases[0].to_phase()))
    with pytest.raises(ValueError, match="unknown"):
        HypernetRunConfig.from_dict({**RUN_CFG, "n_itr": 3})


def test_cli_no_then_delta_then_resume(tmp_path, monkeypatch, capsys):
    """``--mode no``, ``--mode delta --init_from`` and ``--resume`` on the
    CPU, through a config: what each run hands ``train_wholenet``."""
    path = tmp_path / "hnet.yaml"
    path.write_text(yaml.safe_dump(RUN_CFG))
    calls = []
    real = ttraining.train_wholenet

    def spy(net, state, *args, **kwargs):
        calls.append((state, kwargs))
        return real(net, state, *args, **kwargs)

    monkeypatch.setattr(thypernet, "train_wholenet", spy)
    base = ["--config", str(path), "--synthetic", "--device", "cpu", "--disable_wandb"]
    wd_no, wd_delta = tmp_path / "no", tmp_path / "delta"
    assert hypernet_train.main(base + ["--mode", "no", "--workdir", str(wd_no),
                                       "--checkpointing_freq", "2"]) == 0
    assert sorted(p.name for p in wd_no.iterdir()) == ["samples_2.pkl", "samples_4.pkl"]
    best_no, n = tinf.load_checkpoint_meta(wd_no, device="cpu")
    assert n == 4
    assert calls[-1][1]["unfreeze_backbone_samples"] == 2 and calls[-1][1]["lmbda"] == 2e-3

    assert hypernet_train.main(base + ["--mode", "delta", "--workdir", str(wd_delta),
                                       "--init_from", str(wd_no)]) == 0
    start = calls[-1][0]
    for k, v in best_no.hypernet.items():
        assert torch.equal(start.hypernet["LatentHyperNet_0." + k], v)
    assert all(torch.equal(a, b) for a, b in zip(ttraining.state_leaves(start)[-3:],
                                                 ttraining.state_leaves(best_no)[-3:]))
    # only_biases reaches the synthesis head (its output is the 8 + 3 biases),
    # the head widths of the config do not (1024 x 3, JAX's defaults).
    assert start.hypernet["MLP_0.Dense_4.bias"].shape == (8 + 3,)
    assert start.hypernet["MLP_0.Dense_3.bias"].shape == (1024,)

    assert hypernet_train.main(base + ["--mode", "delta", "--workdir", str(wd_delta),
                                       "--resume", "--n_samples", "8"]) == 0
    ckpt, n = tinf.load_checkpoint_meta(wd_delta / "samples_4.pkl", device="cpu")
    assert calls[-1][1]["samples_offset"] == n == 4
    assert all(torch.equal(a, b) for a, b in zip(ttraining.state_leaves(calls[-1][0]),
                                                 ttraining.state_leaves(ckpt)))
    assert "resumed from" in capsys.readouterr().out
    assert (wd_delta / "samples_8.pkl").exists()
    # --data_parallel runs (tests/test_torch_parallel.py); a world size that
    # does not divide the config's batch of 2 raises before any rank starts.
    with pytest.raises(ValueError, match="does not divide"):
        hypernet_train.main(base + ["--data_parallel", "3"])


# --------------------------------------------------------------------------- eval


def test_iterations_to_match(side):
    """The one-shot metrics against JAX's; the from-scratch run's keys and
    checkpoints (JAX's loop is the per-image engine's, held elsewhere)."""
    _, tnet = side["nets"]["delta"]
    jstate, tstate = states(side, "delta")
    jnet = JaxDelta(JCFG, backbone_arch="resnet18", n_hidden_channels=8, **HN_KW)
    jnet.predict = jax.jit(jnet.predict)  # eager, a resnet18 compiles op by op
    img = batches(13, batch=1)[0][0]
    want = jax_iterations_to_match(jnet, jstate, jnp.asarray(img), LMBDA,
                                   jax.random.PRNGKey(0), max_itr=0, check_every=1)
    got = iterations_to_match(tnet, tstate, torch.tensor(img), LMBDA, 0, max_itr=4,
                              check_every=2)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["one_shot_loss"], want["one_shot_loss"], rtol=1e-4)
    np.testing.assert_allclose(got["one_shot_psnr_db"], want["one_shot_psnr_db"], rtol=1e-4)
    assert abs(got["one_shot_rate_bpp"] - want["one_shot_rate_bpp"]) <= rate_bound_bpp(
        tnet, tstate, img[None])
    assert got["check_every"] == 2 and len(got["scratch_losses"]) == 2
    assert all(np.isfinite(got["scratch_losses"]))
    assert got["itr_to_match"] in (None, 2, 4)
