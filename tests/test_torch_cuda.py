"""The port on a GPU: the ARM kernel against its plain version (the video
path's 1080p pyramid included), the eval forward (I, P and B frames, the
fixed-point warp), the bitstream's float decode, the hypernet's batched eval
forward and its delta search on the card against the CPU; the upsampling
filters' weight-gradient kernel against its plain version in float64 and
the library's forward and input gradient. Every test here needs an NVIDIA GPU and skips without one. The file imports no JAX, so it runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The kernel (float64 mma on the tensor cores) is held to two references with
``models.arm.rate_tolerance`` (rtol = atol = 1e-4, plus what f32 resolves
for latents whose Laplace scale is under 1/8 or whose rate is over 12
bits), with no latent beyond 1e-4 that is neither: the plain version in
float64, and the plain version in f32 as the port runs it (cuBLAS, which
sums in another order than the kernel). On latents past TF32's exact
integers the f32 plain version itself misses float64 on some inputs; there
the kernel is held to float64 alone (``tests/torch_kernel_checks.py``).
"""

import numpy as np
import pytest
import torch

from coolchic_tpu_torch.models.arm import init_arm_params
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.models.coolchic import init_coolchic_params
from coolchic_tpu_torch.ops import arm_rate as ops
from coolchic_tpu_torch.params import from_numpy_pytree, stack_params, to_numpy_pytree
from coolchic_tpu_torch.train.step import eval_metrics
from torch_kernel_checks import (
    LARGE_ARMS, LARGE_SEEDS, check_rate, holds, large_latent_case,
)

pytestmark = pytest.mark.cuda

# Ragged planes: one latent, under one 16-latent m-tile, not a multiple of
# 16 or of the 64-latent item, and a plane of many items.
RAGGED = ((1, 1), (5, 3), (17, 33), (37, 130))


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
    for layer in params["layers"][1:-1]:  # hidden layers past the first: small, nonzero
        layer["weight"] = torch.randn(layer["weight"].shape, generator=gen, device=device) * 0.05
    return params, gen


def assert_kernel_close(got, latents, params, dim_arm):
    res = check_rate(got, latents, params, dim_arm)
    assert holds(res["vs_f64"]) and holds(res["vs_f32"]), res


@pytest.mark.parametrize("dim_arm,n_hidden", [(8, 1), (16, 2), (24, 2), (32, 2), (24, 0),
                                              (16, 3), (32, 0), (8, 3)])
def test_kernel_matches_plain(cuda, dim_arm, n_hidden):
    params, gen = _arm_params(dim_arm, n_hidden, dim_arm, cuda)
    latents = [torch.round(torch.randn((1, h, w), generator=gen, device=cuda) * 3.0)
               for h, w in RAGGED]
    count = ops.launch_count
    got = ops.arm_rate_pyramid(latents, params, dim_arm, n_hidden)
    assert ops.launch_count == count + 1
    assert_kernel_close(got, latents, params, dim_arm)


@pytest.mark.parametrize("dim_arm,n_hidden", LARGE_ARMS)
def test_kernel_on_latents_beyond_tf32_integers(cuda, dim_arm, n_hidden):
    """Every seed of LARGE_SEEDS: the kernel within tolerance of float64, and
    of cuBLAS f32 wherever cuBLAS itself is within tolerance of float64."""
    f32_off = []
    for seed in LARGE_SEEDS:
        params, latents = large_latent_case(dim_arm, n_hidden, seed)
        params, latents = from_numpy_pytree(params, cuda), from_numpy_pytree(latents, cuda)
        assert max(y.abs().max().item() for y in latents) > 2048
        res = check_rate(ops.arm_rate_pyramid(latents, params, dim_arm, n_hidden), latents,
                         params, dim_arm)
        assert holds(res["vs_f64"]), (seed, res)
        if res["f32_holds"]:
            assert holds(res["vs_f32"]), (seed, res)
        else:
            f32_off.append(seed)
    assert len(f32_off) < len(LARGE_SEEDS) // 2, f32_off


@pytest.mark.parametrize("dim_arm,n_hidden,shrink", [(32, 32, 0.2), (32, 55, 0.2), (8, 806, 0.02)])
def test_hidden_layers_past_shared_memory(cuda, dim_arm, n_hidden, shrink):
    """Deep ARMs, up to the most hidden layers whose f32 weights fit 227 KB
    (55 at dim_arm 32, 806 at dim_arm 8): the first layers are staged in
    shared memory, the rest read from global memory. Hidden weights past
    the first are shrunk (to 0.01 and 0.001 N(0, 1)) so that the residual
    layers stay bounded."""
    params, gen = _arm_params(dim_arm, n_hidden, 3, cuda)
    for layer in params["layers"][1:-1]:
        layer["weight"] *= shrink
    latents = [torch.round(torch.randn((1, 37, 130), generator=gen, device=cuda) * 3.0)]
    got = ops.arm_rate_pyramid(latents, params, dim_arm, n_hidden)
    assert_kernel_close(got, latents, params, dim_arm)


def test_more_planes_than_one_launch_takes(cuda):
    """70 channels: two launches (64 planes each at most), one flat rate."""
    params, gen = _arm_params(8, 1, 1, cuda)
    latents = [torch.round(torch.randn((70, 6, 11), generator=gen, device=cuda) * 2.0)]
    count = ops.launch_count
    got = ops.arm_rate_pyramid(latents, params, 8, 1)
    assert ops.launch_count == count + 2
    assert_kernel_close(got, latents, params, 8)


@pytest.mark.parametrize("n_images", [1, 2, 5, 8, 300])
@pytest.mark.parametrize("dim_arm,n_hidden", [(24, 2), (8, 1), (32, 40)])
def test_batched_kernel_matches_plain_and_single_launches(cuda, n_images, dim_arm, n_hidden):
    """B images, each with its own ARM and latents, in one launch: every row
    within tolerance of its plain versions, and the batch equal bit for bit
    to B single-image launches. 300 images are more than the blocks the card
    holds at once (a block then takes several images in turn); 40 hidden
    layers of width 32 are not all staged in shared memory."""
    rows, gens = zip(*[_arm_params(dim_arm, n_hidden, 100 + b, cuda) for b in range(n_images)])
    for row in rows:
        for layer in row["layers"][1:-1]:
            layer["weight"] *= 0.2 if n_hidden > 3 else 1.0
    latents = [torch.round(torch.randn((n_images, 1, h, w), generator=gens[0], device=cuda) * 3.0)
               for h, w in RAGGED]
    count = ops.launch_count
    got = ops.arm_rate_pyramid_batch(latents, stack_params(rows), dim_arm, n_hidden)
    assert ops.launch_count == count + 1
    assert got.shape == (n_images, sum(h * w for h, w in RAGGED))
    singles = torch.stack([ops.arm_rate_pyramid([y[b] for y in latents], rows[b], dim_arm, n_hidden)
                           for b in range(n_images)])
    assert torch.equal(got, singles)
    for b in range(0, n_images, max(1, n_images // 8)):
        assert_kernel_close(got[b], [y[b] for y in latents], rows[b], dim_arm)


def test_batched_kernel_more_planes_than_one_launch_takes(cuda):
    """70 channels x 3 images: two launches, each over the whole batch."""
    rows, gens = zip(*[_arm_params(8, 1, 7 + b, cuda) for b in range(3)])
    latents = [torch.round(torch.randn((3, 70, 6, 11), generator=gens[0], device=cuda) * 2.0)]
    count = ops.launch_count
    got = ops.arm_rate_pyramid_batch(latents, stack_params(rows), 8, 1)
    assert ops.launch_count == count + 2
    for b in range(3):
        assert torch.equal(got[b], ops.arm_rate_pyramid([latents[0][b]], rows[b], 8, 1))


def test_batched_wrapper_raises_instead_of_falling_back(cuda):
    rows, _ = zip(*[_arm_params(8, 1, b, cuda) for b in range(2)])
    params = stack_params(rows)
    latents = [torch.zeros(2, 1, 4, 5, device=cuda)]
    with pytest.raises(ValueError):  # unbatched weights
        ops.arm_rate_pyramid_batch(latents, rows[0], 8, 1)
    with pytest.raises(ValueError):  # another batch size
        ops.arm_rate_pyramid_batch([torch.zeros(3, 1, 4, 5, device=cuda)], params, 8, 1)
    params["layers"][0]["weight"] = params["layers"][0]["weight"].mT
    with pytest.raises(ValueError):  # not contiguous
        ops.arm_rate_pyramid_batch(latents, params, 8, 1)


def test_batched_masked_eval_on_the_card_matches_the_cpu(cuda):
    """Three decoders of mixed true sizes in one buffer: the batched, masked
    eval forward on the card (one kernel launch) against the CPU."""
    cfg = CoolChicConfig(img_size=(45, 61), dim_arm=16, n_hidden_layers_arm=2)
    rng = np.random.default_rng(0)
    rows = []
    for b in range(3):
        row = init_coolchic_params(torch.Generator(cuda).manual_seed(b), cfg, cuda)
        row["latents"] = [torch.tensor(rng.standard_normal(s).astype(np.float32) * 0.3,
                                       device=cuda) for s in cfg.latent_shapes]
        rows.append(row)
    params = stack_params(rows)
    targets = torch.tensor(rng.uniform(size=(3, 3, 45, 61)).astype(np.float32))
    valid_hws = torch.tensor([[45, 61], [30, 61], [41, 33]])
    lmbdas = torch.tensor([1e-3, 2e-3, 4e-3])
    count = ops.launch_count
    on_card = eval_metrics(params, cfg, targets.to(cuda), lmbdas.to(cuda), valid_hw=valid_hws.to(cuda))
    assert ops.launch_count == count + 1
    on_cpu = eval_metrics(from_numpy_pytree(to_numpy_pytree(params), "cpu"), cfg, targets, lmbdas,
                          valid_hw=valid_hws)
    np.testing.assert_allclose(on_card.rate_latent_bpp.cpu().numpy(),
                               on_cpu.rate_latent_bpp.numpy(), rtol=1e-5)
    np.testing.assert_allclose(on_card.psnr_db.cpu().numpy(), on_cpu.psnr_db.numpy(), atol=0.01)


def test_wrapper_raises_instead_of_falling_back(cuda):
    params, _ = _arm_params(8, 1, 2, cuda)
    with pytest.raises(TypeError):
        ops.arm_rate(torch.zeros(4, 5, dtype=torch.float64, device=cuda), params, 8, 1)
    with pytest.raises(ValueError):
        ops.arm_rate(torch.zeros(4, 5, device=cuda), from_numpy_pytree(
            to_numpy_pytree(params), "cpu"), 8, 1)
    params["layers"][0]["weight"] = params["layers"][0]["weight"].T
    with pytest.raises(ValueError):
        ops.arm_rate(torch.zeros(4, 5, device=cuda), params, 8, 1)


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


@pytest.mark.parametrize("name", ["arm24_7grids", "arm16_4grids_29x37", "two_ft_fallback"])
def test_float_decode_on_the_card_matches_the_cpu(cuda, name):
    """A stream written from the card's tensors, decoded by the float
    pipeline on the card and on the CPU: at most one level apart, on fewer
    than 0.1 % of the samples; the integer pipeline (host code) within 8/255."""
    from coolchic_tpu_torch.bitstream import decode_bitstream, encode_image_bitstream
    from torch_bitstream_cases import case

    arch, params, q_step, expgol, blk = case(name)
    cfg = CoolChicConfig(**arch)
    data = encode_image_bitstream(from_numpy_pytree(params, cuda), cfg, q_step, expgol,
                                  hls_sig_blksize=blk)
    assert data == encode_image_bitstream(from_numpy_pytree(params, "cpu"), cfg, q_step, expgol,
                                          hls_sig_blksize=blk)
    on_card, _ = decode_bitstream(data)  # the default device
    on_cpu, _ = decode_bitstream(data, device="cpu")
    diff = np.abs(on_card.astype(np.float64) - on_cpu)
    assert diff.max() <= 1.0 / 255.0 + 1e-7 and (diff > 0).mean() < 1e-3
    if name != "two_ft_fallback":
        integer, _ = decode_bitstream(data, integer_pipeline=True)
        assert np.abs(on_card - integer).max() < 8.0 / 255.0


@pytest.mark.parametrize("n_images", [1, 2, 5])
def test_kernel_on_the_1080p_pyramid(cuda, n_images):
    """The video path's shapes: the 7 ragged grids of a 1920x1080 frame
    (1080x1920 down to 17x30), default ARM, at the batch sizes the video
    encode launches (one frame; its warm-up's 5, then 2 candidates)."""
    cfg = CoolChicConfig(img_size=(1080, 1920))
    rows, gens = zip(*[_arm_params(24, 2, 200 + b, cuda) for b in range(n_images)])
    latents = [torch.round(torch.randn((n_images,) + s, generator=gens[0], device=cuda) * 3.0)
               for s in cfg.latent_shapes]
    count = ops.launch_count
    got = ops.arm_rate_pyramid_batch(latents, stack_params(rows), 24, 2)
    assert ops.launch_count == count + 1 and got.shape == (n_images, 2_764_710)
    for b in range(n_images):
        single = ops.arm_rate_pyramid([y[b] for y in latents], rows[b], 24, 2)
        assert torch.equal(got[b], single)
        assert_kernel_close(got[b], [y[b] for y in latents], rows[b], 24)


def _inter_inputs(seed, device):
    """Synthesis output [2, 9, H, W] with large and fractional flows and
    references stored as a decoder stores them."""
    rng = np.random.default_rng(seed)
    raw = (0.2 * rng.standard_normal((2, 9, 37, 53))).astype(np.float32)
    raw[:, [3, 4, 6, 7]] *= 40.0
    refs = [torch.tensor(np.round(rng.uniform(size=(2, 3, 37, 53)) * 255).astype(np.float32) / 255,
                         device=device) for _ in range(2)]
    return torch.tensor(raw, device=device), refs


def test_inter_predict_int_on_the_card_equals_the_cpu(cuda):
    from coolchic_tpu_torch.video.intercoding import inter_predict_int

    rng = np.random.default_rng(3)
    raw = rng.integers(-(1 << 16), 1 << 16, (2, 9, 37, 53)).astype(np.int32)
    raw[:, [3, 4, 6, 7]] = rng.integers(-(1 << 24), 1 << 24, (2, 4, 37, 53))
    raw[:, [3, 4, 6, 7], :5] //= 1 << 10  # inside the frame, negative offsets included
    raw[:, [5, 8]] //= 20
    refs = [rng.integers(0, 4097, (2, 3, 37, 53)).astype(np.int32) for _ in range(2)]
    for n_ch, flow_gain in ((6, 1), (9, 1), (9, 255)):
        r = torch.tensor(raw[:, :n_ch])
        r1 = torch.tensor(refs[1]) if n_ch == 9 else None
        on_cpu = inter_predict_int(r, torch.tensor(refs[0]), r1, flow_gain)
        on_card = inter_predict_int(r.to(cuda), torch.tensor(refs[0], device=cuda),
                                    None if r1 is None else r1.to(cuda), flow_gain)
        assert torch.equal(on_card.cpu(), on_cpu)


@pytest.mark.parametrize("frame_type", ["P", "B"])
def test_inter_eval_on_the_card_matches_the_cpu(cuda, frame_type):
    """The P / B eval forward: on one synthesis output the decoder's levels
    are equal on the card and the CPU; the whole eval (ARM kernel, float
    synthesis, integer warp) within the main path's tolerance."""
    from coolchic_tpu_torch.video.intercoding import inter_levels

    raw, refs = _inter_inputs(4, cuda)
    n_refs = "IPB".index(frame_type)
    raw = raw[:, : 3 * (n_refs + 1)]
    ref1 = refs[1] if n_refs == 2 else None
    on_card = inter_levels(raw, refs[0], ref1, 1)
    on_cpu = inter_levels(raw.cpu(), refs[0].cpu(), None if ref1 is None else ref1.cpu(), 1)
    assert torch.equal(on_card.cpu(), on_cpu)

    cfg = CoolChicConfig(img_size=(37, 53), dim_arm=16, n_hidden_layers_arm=2,
                         frame_type=frame_type, out_channels=3 * (n_refs + 1))
    params = init_coolchic_params(torch.Generator(cuda).manual_seed(1), cfg, cuda)
    rng = np.random.default_rng(5)
    params["latents"] = [torch.tensor(rng.standard_normal(s).astype(np.float32) * 0.4,
                                      device=cuda) for s in cfg.latent_shapes]
    target = torch.cat([torch.tensor(rng.uniform(size=(3, 37, 53)).astype(np.float32),
                                     device=cuda)] + [r[0] for r in refs[:n_refs]])
    count = ops.launch_count
    m_card = eval_metrics(params, cfg, target, 1e-3)
    assert ops.launch_count == count + 1
    m_cpu = eval_metrics(from_numpy_pytree(to_numpy_pytree(params), "cpu"), cfg, target.cpu(), 1e-3)
    np.testing.assert_allclose(m_card.rate_latent_bpp.item(), m_cpu.rate_latent_bpp.item(),
                               rtol=1e-5)
    np.testing.assert_allclose(m_card.psnr_db.item(), m_cpu.psnr_db.item(), atol=0.01)


def _hypernet(seed=0):
    """A DeltaWholeNet (resnet18, 8 hidden channels, narrow heads) of the
    default decoder at 48x64, the port's seeded init on the CPU with every
    leaf perturbed (numpy, ``seed``) so that the deltas are not zero."""
    from coolchic_tpu_torch.hypernet import DeltaWholeNet, WholeNetState

    cfg = CoolChicConfig(img_size=(48, 64))
    net = DeltaWholeNet(cfg, n_hidden_channels=8, synthesis_hidden_dim=64, arm_hidden_dim=64,
                        ups_hidden_dim=32)
    state = net.init(seed, device="cpu")
    rng = np.random.default_rng(seed)
    state = WholeNetState(*[
        from_numpy_pytree(_perturb(to_numpy_pytree(tree), rng), "cpu") for tree in state])
    img = np.random.default_rng(seed + 1).uniform(size=(3, 3, 48, 64)).astype(np.float32)
    return net, state, img


def _perturb(tree, rng, scale=0.01):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, scale) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturb(v, rng, scale) for v in tree]
    return (tree + scale * rng.standard_normal(tree.shape)).astype(np.float32)


@pytest.mark.parametrize("mode", ["delta", "full", "no"])
def test_hypernet_eval_forward_on_the_card_matches_the_cpu(cuda, mode):
    """Three images' eval forward: one kernel launch for the three decoders
    (base + delta; the predicted weights alone; the shared decoder expanded
    to the batch), each row's rate held to the plain versions on the card,
    and the metrics to the CPU's."""
    from coolchic_tpu_torch.hypernet import DeltaWholeNet, NOWholeNet, WholeNetState
    from coolchic_tpu_torch.params import tree_map
    from coolchic_tpu_torch.train.loss import loss_function

    net, state, img = _hypernet()
    if mode == "full":
        net = DeltaWholeNet(net.cfg, mode="full", n_hidden_channels=8, synthesis_hidden_dim=64,
                            arm_hidden_dim=64, ups_hidden_dim=32)
    elif mode == "no":
        prefix = "LatentHyperNet_0."
        net = NOWholeNet(net.cfg, n_hidden_channels=8)
        state = WholeNetState({k[len(prefix):]: v for k, v in state.hypernet.items()
                               if k.startswith(prefix)}, state.decoder)
    on = {d: (tree_map(lambda t: t.to(d), state._asdict()), torch.tensor(img, device=d))
          for d in ("cpu", "cuda")}
    out = {}
    for d, (s, x) in on.items():
        s = type(state)(**s)
        count = ops.launch_count
        with torch.no_grad():
            decoded, rate = net.forward(s, x, training=False)
        if d == "cuda":
            assert ops.launch_count == count + 1
            with torch.no_grad():
                if mode == "no":
                    latents = net.predict_latents(s, x)
                    arm = tree_map(lambda t: t.expand(3, *t.shape), s.decoder["arm"])
                else:
                    latents, deltas = net.predict(s, x)
                    arm = net._nets(s, deltas)["arm"]
            for b in range(3):
                y_hat = [torch.round(y[b] * net.cfg.encoder_gain) for y in latents]
                assert_kernel_close(rate[b], y_hat, tree_map(lambda t: t[b].contiguous(), arm),
                                    net.cfg.dim_arm)
        out[d] = loss_function(decoded, rate, x, 1e-3)
    np.testing.assert_allclose(out["cuda"].rate_latent_bpp.cpu().numpy(),
                               out["cpu"].rate_latent_bpp.numpy(), rtol=1e-4)
    np.testing.assert_allclose(out["cuda"].psnr_db.cpu().numpy(), out["cpu"].psnr_db.numpy(),
                               atol=0.01)


def test_quantize_model_deltas_on_the_card_matches_the_cpu(cuda):
    """The delta search from the same latents and deltas: equal choices."""
    from coolchic_tpu_torch.params import tree_map
    from coolchic_tpu_torch.train.quantize_model import quantize_model_deltas

    net, state, img = _hypernet(1)
    with torch.no_grad():
        latents, deltas = net.predict(state, torch.tensor(img[:1]))
    lat0 = [y[0] for y in latents]
    delta0 = tree_map(lambda d: d[0], deltas)
    infos = {}
    for d in ("cpu", "cuda"):
        _, infos[d] = quantize_model_deltas(
            tree_map(lambda t: t.to(d), state.decoder), tree_map(lambda t: t.to(d), delta0),
            [y.to(d) for y in lat0], torch.tensor(img[0], device=d), 1e-3, net.cfg)
    for m, want in infos["cpu"].items():
        got = infos["cuda"][m]
        assert (got.q_step_w, got.q_step_b, got.expgol_w, got.expgol_b) == (
            want.q_step_w, want.q_step_b, want.expgol_w, want.expgol_b), m
        assert abs(got.rate_bits - want.rate_bits) <= 1e-4 * max(1.0, want.rate_bits)


def _train_step_on(device, net, state, img, lr):
    """One train step of the deterministic quantizer on ``device``: (loss,
    the parameters before and after, as numpy)."""
    from coolchic_tpu_torch.hypernet import WholeNetState
    from coolchic_tpu_torch.hypernet.training import make_wholenet_train_step, state_leaves
    from coolchic_tpu_torch.params import tree_map
    from coolchic_tpu_torch.train.presets import TrainerPhase

    phase = TrainerPhase(lr=lr, max_itr=1, quantizer_type="none", quantizer_noise_type="none")
    state = WholeNetState(*[tree_map(lambda t: t.to(device).clone(), tree) for tree in state])
    before = [t.cpu().numpy().copy() for t in state_leaves(state)]
    tx, step = make_wholenet_train_step(net, phase)
    state, _, loss = step(state, tx.init(state), torch.tensor(img, device=device), 1e-3, None,
                          lr, 0.3, 0.0)
    return loss.item(), before, [t.cpu().numpy().copy() for t in state_leaves(state)]


def test_hypernet_train_step_on_the_card_matches_the_cpu(cuda):
    """One whole-net train step (deterministic quantizer) from the same state
    and images: the loss to 1e-4 relative; the moves of the parameters
    (Adam's first step, g / (|g| + eps) * lr) within 2 lr everywhere (a flip
    where g is near eps), and within 1 % of lr but for at most 1e-4 of the
    parameters outside the resnet and 1 % inside it (its ReLUs and max-pool
    switch at other elements on the two devices: see ``chip_smoke.py::
    hypernet_step_card_vs_cpu``). The training forward runs the plain ARM:
    no kernel launch."""
    net, state, img = _hypernet()
    lr = 1e-4
    count = ops.launch_count
    loss_card, before, after_card = _train_step_on("cuda", net, state, img, lr)
    assert ops.launch_count == count
    loss_cpu, _, after_cpu = _train_step_on("cpu", net, state, img, lr)
    np.testing.assert_allclose(loss_card, loss_cpu, rtol=1e-4)
    n_resnet = sum(k.startswith("ResNet") for k in state.hypernet)
    in_resnet = [k.startswith("ResNet") for k in state.hypernet] + [False] * (
        len(before) - len(state.hypernet))
    assert n_resnet > 0
    for resnet, limit in ((True, 1e-2), (False, 1e-4)):
        diff = np.concatenate([np.abs((a - b0) - (c - b0)).ravel() for a, c, b0, r in zip(
            after_card, after_cpu, before, in_resnet) if r == resnet])
        assert diff.max() <= 2 * lr and float((diff > 0.01 * lr).mean()) <= limit, resnet


def test_evaluate_wholenet_launches_the_kernel_once(cuda):
    """``evaluate_wholenet`` of three images: one launch, and the CPU's
    metrics."""
    from coolchic_tpu_torch.hypernet import WholeNetState
    from coolchic_tpu_torch.hypernet.training import evaluate_wholenet
    from coolchic_tpu_torch.params import tree_map

    net, state, img = _hypernet()
    out = {}
    for d in ("cpu", "cuda"):
        s = WholeNetState(*[tree_map(lambda t: t.to(d), tree) for tree in state])
        count = ops.launch_count
        out[d] = {k: v.item() for k, v in evaluate_wholenet(
            net, s, torch.tensor(img, device=d), 1e-3).items()}
        assert ops.launch_count == count + (d == "cuda")
    np.testing.assert_allclose(out["cuda"]["loss"], out["cpu"]["loss"], rtol=1e-4)
    np.testing.assert_allclose(out["cuda"]["rate_latent_bpp"], out["cpu"]["rate_latent_bpp"],
                               rtol=1e-4)
    np.testing.assert_allclose(out["cuda"]["psnr_db"], out["cpu"]["psnr_db"], atol=0.01)


def _small_batch(device):
    from coolchic_tpu_torch.train.presets import Preset, TrainerPhase, Warmup, WarmupPhase

    cfg = CoolChicConfig(img_size=(32, 48), n_ft_per_res=(1, 1, 1, 1), dim_arm=8,
                         n_hidden_layers_arm=1,
                         layers_synthesis=("8-1-linear-relu", "X-1-linear-none"))
    phase = TrainerPhase(lr=1e-2, max_itr=6, freq_valid=3, patience=100)
    preset = Preset("tiny", all_phases=(phase, TrainerPhase(
        lr=1e-4, max_itr=2, freq_valid=2, quantize_model=True, quantizer_type="ste",
        quantizer_noise_type="none")), warmup=Warmup((WarmupPhase(2, phase),)))
    targets = torch.tensor(np.random.default_rng(0).uniform(size=(2, 3, 32, 48)).astype(
        np.float32))
    return cfg, preset, targets


def test_sharded_encode_at_world_size_1_on_nccl_equals_the_batch(cuda):
    """``launch(encode_batch_sharded, 1, "cuda", ...)`` (a rank on NCCL) against
    ``encode_frame_batch`` in this process on the same images and seeds: the
    same work, so the same metrics (rtol 1e-3: the backward of the
    synthesis' replicate padding sums with atomics, in another order from
    run to run) and the same kernel launches, which the rank counts and
    returns with its result."""
    import torch_parallel_workers as workers

    from coolchic_tpu_torch.parallel import launch
    from coolchic_tpu_torch.train.encode import encode_frame_batch

    cfg, preset, targets = _small_batch(cuda)
    (res, infos), rank_launches = launch(workers.encode_counting_launches, 1, "cuda", targets,
                                         [1e-3, 4e-3], cfg, preset, [0, 1], with_quant_info=True)
    count = ops.launch_count
    want, want_infos = encode_frame_batch(targets.to(cuda), [1e-3, 4e-3], cfg, preset, [0, 1],
                                          with_quant_info=True)
    assert rank_launches == ops.launch_count - count > 0
    assert len(infos) == 2
    for k in ("loss", "psnr_db", "rate_latent_bpp"):
        np.testing.assert_allclose(getattr(res, k).numpy(), getattr(want, k).numpy(),
                                   rtol=1e-3)


def test_detailed_eval_metrics_on_the_card_match_the_cpu(cuda):
    """One eval forward, one kernel launch; the CPU's metrics (rtol 1e-4),
    the per-grid rates within 1e-4 bpp, the nonzero shares within 1e-6
    relative (an f32 mean, summed in another order on the card)."""
    from coolchic_tpu_torch.train.step import detailed_eval_metrics

    cfg = CoolChicConfig(img_size=(64, 96))
    params = init_coolchic_params(torch.Generator().manual_seed(0), cfg, "cpu", "normal")
    params["latents"] = [30.0 * t for t in params["latents"]]
    target = torch.tensor(np.random.default_rng(1).uniform(size=(3, 64, 96)).astype(np.float32))
    out = {}
    for d in ("cpu", "cuda"):
        count = ops.launch_count
        out[d] = {k: v.item() for k, v in detailed_eval_metrics(
            from_numpy_pytree(to_numpy_pytree(params), d), cfg, target.to(d), 1e-3).items()}
        assert ops.launch_count == count + (d == "cuda")
    for k, v in out["cpu"].items():
        if k.endswith("_nonzero_pct"):
            assert out["cuda"][k] == pytest.approx(v, rel=1e-6), k
        elif k.endswith("_bpp") and k.startswith("latent_"):
            assert abs(out["cuda"][k] - v) <= 1e-4, k
        else:
            np.testing.assert_allclose(out["cuda"][k], v, rtol=1e-4, atol=1e-6, err_msg=k)


# --------------------------------------------------------------------------- #
# The upsampling filters' weight-gradient kernel (ops/ups_filter.py)
# --------------------------------------------------------------------------- #
# (image size, images): the main paths' cascades (the batched encode, the
# hypernet trainer, a 1080p frame) and ragged ones.
UPS_SHAPES = [((512, 768), 8), ((256, 256), 8), ((1080, 1920), 1), ((37, 130), 3),
              ((17, 33), 5), ((5, 3), 2), ((1, 1), 1)]


@pytest.mark.parametrize("img_size,n_images", UPS_SHAPES)
def test_ups_wgrad_kernel_matches_plain_in_float64(cuda, img_size, n_images):
    """Every weight gradient of the cascade (24 for 7 grids): the kernel
    within 1e-5 of the plain version in float64, relative to each tap's sum
    of |terms| (``torch_kernel_checks.py::weight_grad_error``), and equal bit for
    bit on a second run."""
    from coolchic_tpu_torch.ops import ups_filter
    from torch_kernel_checks import cascade_weight_grads, weight_grad_error

    count = ups_filter.launch_count
    calls = cascade_weight_grads(img_size, n_images, cuda)
    assert len(calls) == 24 and ups_filter.launch_count == count + 24
    for x, gy, k, transposed, axis in calls:
        got = ups_filter.weight_grad_cuda(x, gy, k, transposed, axis)
        err = weight_grad_error(got, x, gy, k, transposed, axis)
        assert err <= 1e-5, (tuple(x.shape), tuple(gy.shape), k, transposed, axis, err)
        assert torch.equal(ups_filter.weight_grad_cuda(x, gy, k, transposed, axis), got)


# Tap counts a decoder may take beside the default 8 (x2) and 7 (pre-concat):
# fewer taps than the kernel's 8 slots, and 9 to 15 in its 16-slot build. The
# pre-concat filter is odd. Input shapes [C, B, H, W]: ragged ones, one with
# an output gradient that is a strided view, and the finest level of the
# 512x768 cascade at B = 8.
UPS_TAPS = [(True, 4), (True, 6), (True, 9), (True, 15), (False, 3), (False, 9), (False, 15)]
UPS_X_SHAPES = [(1, 1, 1, 1), (2, 3, 5, 7), (3, 2, 17, 33), "strided", "main"]


@pytest.mark.parametrize("axis", [2, 3])
@pytest.mark.parametrize("transposed,k", UPS_TAPS)
@pytest.mark.parametrize("x_shape", UPS_X_SHAPES)
def test_ups_wgrad_kernel_matches_plain_at_other_tap_counts(cuda, x_shape, transposed, k, axis):
    """The kernel at tap counts the default decoder does not use, along both
    axes: within 1e-5 of the plain version in float64 (``weight_grad_error``)
    and equal bit for bit on a second run."""
    from coolchic_tpu_torch.ops import ups_filter
    from torch_kernel_checks import weight_grad_error

    gen = torch.Generator(cuda).manual_seed(k + 16 * axis)
    strided = x_shape == "strided"
    if strided:
        x_shape = (3, 4, 12, 40)
    elif x_shape == "main":
        x_shape = ((6, 8, 264, 384) if axis == 2 else (6, 8, 512, 392)) if transposed \
            else (1, 8, 512, 768)
    gy_shape = list(x_shape)
    if transposed:
        gy_shape[axis] = 2 * (x_shape[axis] - 1) + k
    x = torch.randn(x_shape, generator=gen, device=cuda)
    if strided:  # the output gradient as the channels' slice of a [B, 2C, H, W] tensor
        n_c, n_b = gy_shape[:2]
        gy = torch.randn((n_b, 2 * n_c, *gy_shape[2:]), generator=gen, device=cuda)
        gy = gy[:, 1 : 1 + n_c].transpose(0, 1)
    else:
        gy = torch.randn(gy_shape, generator=gen, device=cuda)
    got = ups_filter.weight_grad_cuda(x, gy, k, transposed, axis)
    err = weight_grad_error(got, x, gy, k, transposed, axis)
    assert got.shape == (x_shape[1], k) and err <= 1e-5, err
    assert torch.equal(ups_filter.weight_grad_cuda(x, gy, k, transposed, axis), got)


@pytest.mark.parametrize("transposed,axis", [(True, 2), (True, 3), (False, 2), (False, 3)])
def test_ups_filter_forward_and_input_gradient_are_the_library_s(cuda, monkeypatch,
                                                                 transposed, axis):
    """At the finest level of the 512x768 cascade at B = 8: the forward and
    the input gradient equal autograd's through the library call bit for
    bit; the weight gradient is the kernel's (one launch), within 1e-5 of
    float64 (``weight_grad_error``), the library's own error printed beside it.
    Compared in cuDNN's deterministic mode, since by default its stride-2
    transposed convolution along W at this shape sums in another order from
    call to call: two library calls on the same inputs differ."""
    import torch.nn.functional as F

    from coolchic_tpu_torch.ops import ups_filter
    from torch_kernel_checks import weight_grad_error

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    gen = torch.Generator(cuda).manual_seed(7)
    k = 8 if transposed else 7
    x_shape = (6, 8, 264, 384) if axis == 2 else (6, 8, 512, 392)
    if not transposed:  # the pre-concat filter's input: grid 0 as a view of [B, C, H, W]
        x_shape = (1, 8, 512, 768)
    x = torch.randn(x_shape, generator=gen, device=cuda)
    if not transposed:
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    w = torch.randn((8, 1, k, 1) if axis == 2 else (8, 1, 1, k), generator=gen, device=cuda)
    stride, padding = ups_filter.conv_args(transposed, axis, k)
    x_lib, w_lib = x.clone().requires_grad_(), w.clone().requires_grad_()
    x_new, w_new = x.clone().requires_grad_(), w.clone().requires_grad_()
    y_lib = (F.conv_transpose2d(x_lib, w_lib, stride=stride, groups=8) if transposed
             else F.conv2d(x_lib, w_lib, padding=padding, groups=8))
    count = ups_filter.launch_count
    y_new = ups_filter.filter_1d(x_new, w_new, transposed, axis)
    assert torch.equal(y_new, y_lib)
    gy = torch.randn(y_lib.shape, generator=gen, device=cuda)
    gx_lib, gw_lib = torch.autograd.grad(y_lib, (x_lib, w_lib), gy)
    gx_new, gw_new = torch.autograd.grad(y_new, (x_new, w_new), gy)
    assert ups_filter.launch_count == count + 1
    assert torch.equal(gx_new, gx_lib)
    err = weight_grad_error(gw_new.reshape(8, k), x, gy, k, transposed, axis)
    err_lib = weight_grad_error(gw_lib.reshape(8, k), x, gy, k, transposed, axis)
    print(f"weight gradient vs float64: kernel {err:.3g}, library {err_lib:.3g}")
    assert err <= 1e-5


def test_train_step_launches_the_ups_kernel_24_times(cuda):
    """One batched training step of the default decoder (7 grids) at B = 2:
    24 launches (4 filters per x2 level); an eval forward: none; a step
    that does not train the upsampling: none."""
    from coolchic_tpu_torch.ops import ups_filter
    from coolchic_tpu_torch.params import tree_leaves
    from coolchic_tpu_torch.train.presets import TrainerPhase
    from coolchic_tpu_torch.train.step import AdamState, train_step, trained_tensors

    cfg = CoolChicConfig(img_size=(64, 96))
    gen = torch.Generator(cuda).manual_seed(0)
    params = stack_params([init_coolchic_params(gen, cfg, cuda, "normal") for _ in range(2)])
    targets = torch.rand(2, 3, 64, 96, generator=gen, device=cuda)
    lmbdas = torch.tensor([1e-3, 4e-3], device=cuda)
    for modules, launches in ((("all",), 24), (("arm", "synthesis", "latents"), 0)):
        phase = TrainerPhase(lr=1e-3, optimized_module=modules)
        tensors = trained_tensors(params, phase.optimized_module)
        for t in tensors:
            t.requires_grad_(True)
        count = ups_filter.launch_count
        train_step(params, tensors, AdamState.zeros(tensors), targets, lmbdas, cfg, phase, 1e-3,
                   0.3, 0.25, gen)
        torch.cuda.synchronize()
        assert ups_filter.launch_count == count + launches, modules
        for t in tree_leaves(params):
            t.requires_grad_(False)
    count = ups_filter.launch_count
    eval_metrics(params, cfg, targets, lmbdas)
    assert ups_filter.launch_count == count


def test_ups_wgrad_wrapper_raises_instead_of_falling_back(cuda, monkeypatch):
    from coolchic_tpu_torch.ops import ups_filter

    x = torch.randn(2, 3, 9, 12, device=cuda)
    gy = torch.randn(2, 3, 9, 12, device=cuda)
    with pytest.raises(TypeError):  # float64
        ups_filter.weight_grad_cuda(x.double(), gy.double(), 7, False, 2)
    with pytest.raises(ValueError):  # more taps than the kernel's slots
        ups_filter.weight_grad_cuda(x, gy, ups_filter.MAX_K + 1, False, 2)
    with pytest.raises(ValueError):  # the output gradient on the host
        ups_filter.weight_grad_cuda(x, gy.cpu(), 7, False, 2)
    # A split the kernel refuses (7 tap slots; no column chunk): the launch
    # fails and the wrapper raises, computing nothing else.
    count = ups_filter.launch_count
    ups_filter._launch_args.cache_clear()
    monkeypatch.setattr(ups_filter, "rows_plan", lambda *a: (7, 1, 9, 1, 12, 1))
    with pytest.raises(RuntimeError):
        ups_filter.weight_grad_cuda(x, gy, 7, False, 2)
    monkeypatch.setattr(ups_filter, "cols_plan", lambda *a: (8, 0, 0, 0, 0, 3))
    with pytest.raises(RuntimeError):
        ups_filter.weight_grad_cuda(x, gy, 7, False, 3)
    ups_filter._launch_args.cache_clear()
    assert ups_filter.launch_count == count
