"""The whole-net train step as a CUDA graph (``hypernet/training.py``).

On the CPU: the raw quantizer noise drawn outside the forward, from the
step's generator into buffers in grid order, gives bit for bit the loss and
gradients of the draw inside the forward; the quantizer takes its scalars as
0-d tensors; the rule that decides where the step is graphed.

On the card (marked ``cuda``, skipped without one): the graphed step against
the eager one on the same seeds and batches at a small whole-net width
(losses, leaves and moments after 4 steps within 1e-6 relative), a second
``train_wholenet`` call replaying without a new capture, a patience reload
and an unfreeze giving the eager path's states, and a step that cannot be
captured raising. The card tests run in PyTorch's deterministic mode with
cuDNN's deterministic algorithms, in which the graphed and the eager steps
agree bit for bit on an H100: without it the replicate pad's backward (the
upsampling) adds with atomics on the card, and two runs of the same 4
steps, eager or graphed alike, differ by ~1e-7 of the norm of all the
leaves and by up to ~1e-5 in one small leaf's moments. Imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_train_graph.py -q
"""

import math

import numpy as np
import pytest
import torch

from coolchic_tpu_torch.hypernet import DeltaWholeNet, WholeNetState
from coolchic_tpu_torch.hypernet import training
from coolchic_tpu_torch.metalearning import synthetic_batches
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.models.quantizer import kumaraswamy_noise, softround
from coolchic_tpu_torch.params import tree_map
from coolchic_tpu_torch.train.presets import TrainerPhase
from coolchic_tpu_torch.train.step import make_generator
from coolchic_tpu_torch.utils import trace

ARCH = dict(img_size=(32, 32), n_ft_per_res=(1, 1, 1),
            layers_synthesis=("8-1-linear-relu", "X-1-linear-none"), dim_arm=8,
            n_hidden_layers_arm=1)
HN_KW = dict(n_hidden_channels=8, synthesis_hidden_dim=32, synthesis_n_layers=1, arm_hidden_dim=32,
             arm_n_layers=1, ups_hidden_dim=16, ups_n_layers=1)
BATCH = 2
LMBDA = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _net(device, seed=0):
    """The small delta whole net and a state with every leaf perturbed (at
    init the heads output zeros and their hidden layers get no gradient)."""
    net = DeltaWholeNet(CoolChicConfig(**ARCH), backbone_arch="resnet18", **HN_KW)
    state = net.init(seed, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return net, WholeNetState(*[tree_map(
        lambda t: t + 0.01 * torch.randn(t.shape, generator=gen, device=device), tree)
        for tree in state])


def _phase(noise_type="gaussian", lr=1e-3, schedule_lr=True):
    return TrainerPhase(lr=lr, max_itr=1, schedule_lr=schedule_lr, quantizer_type="softround",
                        quantizer_noise_type=noise_type, softround_temperature=(0.3, 0.2),
                        noise_parameter=(0.25, 0.2) if noise_type == "gaussian" else (2.0, 1.5))


def _batches(device, n, seed=3):
    it = synthetic_batches(BATCH, ARCH["img_size"], seed=seed)
    return [torch.tensor(next(it), device=device) for _ in range(n)]


# --------------------------------------------------------------------------- CPU


@pytest.mark.parametrize("noise_type", ["gaussian", "kumaraswamy"])
def test_noise_drawn_outside_the_forward_is_the_same(noise_type):
    """``draw_raw_noise`` from ``make_generator(device, seed, i)``, fresh or
    into buffers, against the draw inside the forward through
    ``generator=``: bit for bit the same loss and gradients."""
    device = torch.device("cpu")
    net, state = _net(device)
    (imgs,) = _batches(device, 1)
    phase = _phase(noise_type)
    temp, noise = (torch.tensor(v) for v in (0.27, phase.noise_parameter[0]))
    leaves = training.state_leaves(state)

    def loss_and_grads(**kw):
        for t in leaves:
            t.requires_grad_(True)
        loss = training._batch_loss(net, state, imgs, LMBDA, noise_type, "softround", temp, noise,
                                    **kw)
        grads = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        return [loss.detach(), *grads]

    inside = loss_and_grads(generator=make_generator(device, 7, 3))
    fresh = training.draw_raw_noise(net.cfg, noise_type, make_generator(device, 7, 3), BATCH, device)
    buffers = [torch.full_like(t, float("nan")) for t in fresh]
    drawn = training.draw_raw_noise(net.cfg, noise_type, make_generator(device, 7, 3), BATCH, device,
                                    out=buffers)
    assert drawn is buffers and len(buffers) == len(net.cfg.latent_shapes)
    assert all(torch.equal(a, b) for a, b in zip(fresh, buffers))
    outside = loss_and_grads(raw_noise=buffers)
    assert all(torch.equal(a, b) for a, b in zip(inside, outside))
    assert training.draw_raw_noise(net.cfg, "none", None, BATCH, device) is None


def test_quantizer_takes_scalars_as_tensors():
    """The softround temperature and the noise parameter as 0-d float32
    tensors: the numbers of the same float32 values given as numbers, to
    f32's rounding of tanh(1 / 2t) (JAX computes it in f32 for a traced t)."""
    x = torch.linspace(-3.0, 3.0, 1001)
    for t in (0.3, 0.2, 0.05):
        t32 = float(np.float32(t))
        np.testing.assert_allclose(softround(x, torch.tensor(t32)), softround(x, t32),
                                   rtol=1e-6, atol=1e-6)
    u = torch.rand(1000, generator=torch.Generator().manual_seed(0))
    for a in (2.0, 1.5):
        np.testing.assert_allclose(kumaraswamy_noise(u, torch.tensor(a)), kumaraswamy_noise(u, a),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("device, mesh, k, graphed", [
    ("cpu", None, 1, False), ("cuda", None, 1, True), ("cuda", "mesh", 1, False),
    ("cuda", None, 2, False)])
def test_graph_only_on_cuda_without_mesh_or_accumulation(device, mesh, k, graphed):
    assert training._graphed(torch.device(device), mesh, k) is graphed


def test_eager_step_counts_its_steps_on_the_cpu():
    device = torch.device("cpu")
    net, state = _net(device)
    tx, step = training.make_wholenet_train_step(net, _phase())
    opt = tx.init(state)
    for i, imgs in enumerate(_batches(device, 2)):
        state, opt, _ = step(state, opt, imgs, LMBDA, make_generator(device, 7, i), 1e-3, 0.3, 0.25)
    assert tx.counts == {"graph_captures": 0, "graph_replays": 0, "eager_steps": 2}
    assert opt.count == 2


# --------------------------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the kernels have no CPU build)")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = flags
    torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])


@pytest.fixture
def eager(monkeypatch):
    """Within the test, a switch to the eager step on the card."""
    def switch(on=True):
        monkeypatch.setattr(training, "_graphed", (lambda *a: False) if on else _GRAPHED)
    return switch


_GRAPHED = training._graphed


def assert_close(got, want, what):
    """The norm of the difference of all of ``got`` and ``want`` (lists of
    tensors) within ``rtol`` of the norm of all of ``want``."""
    gap = math.sqrt(sum(float(torch.linalg.vector_norm((a - b).double())) ** 2
                        for a, b in zip(got, want, strict=True)))
    norm = math.sqrt(sum(float(torch.linalg.vector_norm(b.double())) ** 2 for b in want))
    assert gap <= 1e-6 * norm, f"{what}: {gap} of {norm}"


def _run_steps(net, state, batches, phase, device):
    tx, step = training.make_wholenet_train_step(net, phase)
    state = training.snapshot(state)
    opt = tx.init(state)
    losses = []
    for i, imgs in enumerate(batches):
        state, opt, loss = step(state, opt, imgs, LMBDA, make_generator(device, 11, i),
                                1e-3 * (1 - 0.1 * i), 0.3 - 0.02 * i, phase.noise_parameter[0] - 0.01 * i)
        losses.append(loss)
    return tx, state, opt, torch.stack(losses)


@pytest.mark.cuda
@pytest.mark.parametrize("noise_type", ["gaussian", "kumaraswamy"])
def test_graphed_step_matches_eager(cuda, eager, noise_type):
    """4 steps as a graph (a warm-up, a capture and its replay, a replay)
    and eagerly, from the same state on the same batches, seeds and
    scalars: losses, leaves and Adam's moments within 1e-6 relative."""
    net, state = _net(cuda)
    batches, phase = _batches(cuda, 4), _phase(noise_type)
    tx, got, got_opt, got_losses = _run_steps(net, state, batches, phase, cuda)
    assert tx.counts == {"graph_captures": 1, "graph_replays": 3, "eager_steps": 1}
    eager()
    etx, want, want_opt, want_losses = _run_steps(net, state, batches, phase, cuda)
    assert etx.counts == {"graph_captures": 0, "graph_replays": 0, "eager_steps": 4}
    assert got_opt.count == want_opt.count == 4
    for a, b in zip(got_losses, want_losses):
        assert_close([a], [b], "loss")
    assert_close(training.state_leaves(got), training.state_leaves(want), "leaves")
    assert_close(got_opt.mu, want_opt.mu, "first moments")
    assert_close(got_opt.nu, want_opt.nu, "second moments")
    moved = training.state_leaves(got)
    assert any(not torch.equal(a, b) for a, b in zip(moved, training.state_leaves(state)))


def _train(net, state, n_steps=8):
    """8 steps at lr 3e-3 (the second validation's loss spikes: a reload),
    validations every 2 steps, a patience of one step, the backbone
    unfrozen after 2."""
    eval_imgs = next(synthetic_batches(3, ARCH["img_size"], seed=9))
    best, logs = training.train_wholenet(
        net, state, synthetic_batches(BATCH, ARCH["img_size"], seed=4), eval_imgs, LMBDA,
        _phase(lr=3e-3), 5, n_steps * BATCH, BATCH, freq_valid_samples=2 * BATCH, verbose=False,
        patience_samples=BATCH, unfreeze_backbone_samples=2 * BATCH)
    return best, logs, trace.spans("train")[-1].attrs


@pytest.mark.cuda
def test_train_wholenet_graphed_matches_eager_and_captures_once(cuda, eager):
    """``train_wholenet`` with a patience of one step (the loss spikes, so a
    validation sets no record and the best state is copied back into the
    graphs' leaves) and the backbone unfrozen after 2 steps (a second
    graph): the logs and best states of two calls equal the eager path's.
    The first call captures each graph once; the second captures nothing
    and replays every step. The caller's state is left as it was, and a
    call's best state is its own."""
    net, state = _net(cuda)
    start = [t.clone() for t in training.state_leaves(state)]
    best1, logs1, attrs1 = _train(net, state)
    assert {k: attrs1[k] for k in training.STEP_COUNTS} == {
        "graph_captures": 2, "graph_replays": 6, "eager_steps": 2}
    kept = [t.clone() for t in training.state_leaves(best1)]
    best2, logs2, attrs2 = _train(net, best1)
    assert {k: attrs2[k] for k in training.STEP_COUNTS} == {
        "graph_captures": 0, "graph_replays": 8, "eager_steps": 0}
    assert all(torch.equal(a, b) for a, b in zip(training.state_leaves(state), start))
    assert all(torch.equal(a, b) for a, b in zip(training.state_leaves(best1), kept))

    eager()
    want1, wlogs1, wattrs = _train(net, state)
    want2, wlogs2, _ = _train(net, want1)
    assert wattrs["eager_steps"] == 8 and wattrs["graph_replays"] == 0
    losses = [log.eval_loss for log in wlogs1]
    assert any(losses[i] >= min(losses[:i]) for i in range(1, len(losses))), losses  # a reload
    for got, want in ((logs1, wlogs1), (logs2, wlogs2)):
        assert [g.samples_seen for g in got] == [w.samples_seen for w in want]
        for g, w in zip(got, want):
            for a, b in zip(g[1:], w[1:]):
                assert_close([torch.tensor(a)], [torch.tensor(b)], f"log at {w.samples_seen}")
    assert_close(training.state_leaves(best1), training.state_leaves(want1), "best leaves")
    assert_close(training.state_leaves(best2), training.state_leaves(want2), "best leaves")


@pytest.mark.cuda
def test_uncapturable_step_raises(cuda, monkeypatch):
    """A copy from the host inside the step cannot be captured: the step
    that captures raises, and no step ran eagerly in its place. (Last in the
    file: the card's context has seen a failed capture.)"""
    net, state = _net(cuda, seed=5)
    real = training.loss_function

    def with_a_host_copy(decoded, rate, imgs, lmbda, *a, **k):
        out = real(decoded, rate, imgs, lmbda, *a, **k)
        return out._replace(loss=out.loss + torch.tensor(0.0, device=decoded.device))
    monkeypatch.setattr(training, "loss_function", with_a_host_copy)
    tx, step = training.make_wholenet_train_step(net, _phase())
    opt = tx.init(state)
    batches = _batches(cuda, 2)
    state, opt, _ = step(state, opt, batches[0], LMBDA, make_generator(cuda, 1, 0), 1e-3, 0.3, 0.25)
    with pytest.raises(RuntimeError):
        step(state, opt, batches[1], LMBDA, make_generator(cuda, 1, 1), 1e-3, 0.3, 0.25)
    assert tx.counts == {"graph_captures": 0, "graph_replays": 0, "eager_steps": 1}
