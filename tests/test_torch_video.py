"""Video encoding of the PyTorch port vs the JAX package: the coding
structure, the warps and inter prediction (float and fixed point), the P / B
frame forward, one training phase and the quantization search on inter
frames, the ``VideoEncoder`` on a 3-frame 4:2:0 ``.yuv`` (stream, checkpoint
and requeue) and the encode CLI on it.

Inputs are made with numpy from a seed; the decoder is small (3 grids, ARM
8-1, an 8-wide synthesis), frames 16x24. Tolerances (both sides f32 on the
CPU):
  * coding structure, lambda per depth: equal;
  * warps and inter prediction: forward rtol = 1e-6, gradient with respect
    to the synthesis output atol = 1e-6 (the same formula, op for op);
  * fixed-point inter prediction: exactly equal to JAX's and to the
    decoder's ``bitstream/inter.py::process_inter_int``;
  * P / B frame forward, batched against ``jax.vmap``: training rtol = atol
    = 1e-5; eval: the rate to ``models.arm.rate_tolerance``, the decoded
    frame in levels, equal except where the float synthesis output rounds
    to the other 12-frac integer (another summation order): at most 3
    samples of a frame differ, by one level;
  * one phase from zero latents (10 steps, patience 0): the tolerances of
    ``test_torch_train.py::test_run_phase_matches_jax`` (logs rtol = 1e-4,
    params atol = 1e-4);
  * quantization search on a P frame: the same q-steps and exp-Golomb
    orders;
  * ``VideoEncoder`` (both packages started from JAX's initialisation, a
    deterministic micro preset with no warm-up): per-frame loss and PSNR
    rtol = 1e-3; the writer fed JAX's params gives JAX's bytes; the port's
    stream decodes, through both packages' decoders, to exactly the port
    encoder's reconstructions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from coolchic_tpu.bitstream import decode as jdec
from coolchic_tpu.bitstream import inter as jinter
from coolchic_tpu.models.config import CoolChicConfig as JaxConfig
from coolchic_tpu.models.coolchic import frame_forward as jax_frame_forward
from coolchic_tpu.models.coolchic import init_coolchic_params as jax_init_params
from coolchic_tpu.train import presets as jp
from coolchic_tpu.train import step as jstep
from coolchic_tpu.train.quantize_model import quantize_model_with_info as jax_quantize_model
from coolchic_tpu.video import codingstructure as jcs
from coolchic_tpu.video import encoder as jenc
from coolchic_tpu.video import intercoding as jic
from coolchic_tpu_torch.bitstream import decode as tdec
from coolchic_tpu_torch.bitstream import inter as tinter
from coolchic_tpu_torch.io.image import write_yuv
from coolchic_tpu_torch.models.arm import rate_tolerance
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.models.coolchic import frame_forward
from coolchic_tpu_torch.params import from_numpy_pytree, stack_params, to_numpy_pytree, tree_map
from coolchic_tpu_torch.train import encode as tencode
from coolchic_tpu_torch.train import step as tstep
from coolchic_tpu_torch.train import presets as tpresets
from coolchic_tpu_torch.train.presets import TrainerPhase
from coolchic_tpu_torch.train.quantize_model import quantize_model_with_info
from coolchic_tpu_torch.video import codingstructure as tcs
from coolchic_tpu_torch.video import encoder as tenc
from coolchic_tpu_torch.video import intercoding as tic

H, W = 16, 24
ARCH = dict(img_size=(H, W), n_ft_per_res=(1, 1, 1), dim_arm=8, n_hidden_layers_arm=1,
            layers_synthesis=("8-1-linear-relu", "X-1-linear-none", "X-3-residual-none"))
OUT_CHANNELS = {"I": 3, "P": 6, "B": 9}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These sizes gain nothing from intra-op threads, and several test
    processes spinning a thread per core slow each other down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(frame_type):
    kw = dict(ARCH, frame_type=frame_type, out_channels=OUT_CHANNELS[frame_type])
    return JaxConfig(**kw), CoolChicConfig(**kw)


# ---- coding structure ------------------------------------------------------- #
@pytest.mark.parametrize("intra_period,p_period", [(0, 0), (1, 1), (2, 2), (4, 2), (8, 1), (8, 8)])
def test_coding_structure_matches_jax(intra_period, p_period):
    want = jcs.CodingStructure(intra_period, p_period, seq_name="s")
    got = tcs.CodingStructure(intra_period, p_period, seq_name="s")
    assert [vars(f) for f in got.frames] == [vars(f) for f in want.frames]
    assert got.get_number_of_frames() == want.get_number_of_frames()
    assert got.get_max_depth() == want.get_max_depth()
    for i in range(got.get_number_of_frames()):
        assert vars(got.get_frame_from_coding_order(i)) == vars(want.get_frame_from_coding_order(i))
        assert vars(got.get_frame_from_display_order(i)) == vars(
            want.get_frame_from_display_order(i))
    for depth in range(5):
        assert tcs.lmbda_from_depth(depth, 1e-3) == jcs.lmbda_from_depth(depth, 1e-3)


# ---- warps and inter prediction -------------------------------------------- #
def flows(kind, rng, shape):
    if kind == "zero":
        return np.zeros(shape, np.float32)
    if kind == "fractional":
        return rng.uniform(-2.5, 2.5, shape).astype(np.float32)
    if kind == "out_of_frame":
        return (rng.choice([-1.0, 1.0], shape) * rng.uniform(30.0, 60.0, shape)).astype(np.float32)
    return rng.integers(-3, 4, shape).astype(np.float32)  # integer


INTER_FUNCS = {  # name: (raw channels, JAX function of (raw, ref0, ref1), port function)
    "warp": (2, lambda r, a, b: jic.warp(a, r), lambda r, a, b: tic.warp(a, r)),
    "bipred": (4, lambda r, a, b: jic.bipred(a, b, r[:2], r[2:], 0.3),
               lambda r, a, b: tic.bipred(a, b, r[:, :2], r[:, 2:], 0.3)),
    "warp_decoder_style": (2, lambda r, a, b: jic.warp_decoder_style(a, r),
                           lambda r, a, b: tic.warp_decoder_style(a, r)),
    "inter_predict_p": (6, lambda r, a, b: jic.inter_predict(r, a, None, 2),
                        lambda r, a, b: tic.inter_predict(r, a, None, 2)),
    "inter_predict_b": (9, lambda r, a, b: jic.inter_predict(r, a, b, 1),
                        lambda r, a, b: tic.inter_predict(r, a, b, 1)),
}
FLOW_CHANNELS = {2: [0, 1], 4: [0, 1, 2, 3], 6: [3, 4], 9: [3, 4, 6, 7]}


@pytest.mark.parametrize("kind", ["zero", "fractional", "out_of_frame", "integer"])
@pytest.mark.parametrize("name", INTER_FUNCS)
def test_inter_prediction_matches_jax(name, kind):
    """A batch of 2 frames against ``jax.vmap``: forward, and the gradient of
    a weighted sum with respect to the synthesis output (flows and gains)."""
    n_ch, jfun, tfun = INTER_FUNCS[name]
    rng = np.random.default_rng(sum(map(ord, name + kind)))
    raw = (0.3 * rng.standard_normal((2, n_ch, H, W))).astype(np.float32)
    flow_ch = FLOW_CHANNELS[n_ch]
    raw[:, flow_ch] = flows(kind, rng, (2, len(flow_ch), H, W))
    ref0, ref1 = (rng.uniform(size=(2, 3, H, W)).astype(np.float32) for _ in range(2))
    weight = rng.standard_normal((2, 3, H, W)).astype(np.float32)

    def jloss(r):
        return jnp.sum(jax.vmap(jfun)(r, jnp.asarray(ref0), jnp.asarray(ref1)) * weight)

    want = jax.vmap(jfun)(jnp.asarray(raw), jnp.asarray(ref0), jnp.asarray(ref1))
    want_grad = jax.grad(jloss)(jnp.asarray(raw))
    raw_t = torch.tensor(raw, requires_grad=True)
    got = tfun(raw_t, torch.tensor(ref0), torch.tensor(ref1))
    (got * torch.tensor(weight)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(raw_t.grad.numpy(), np.asarray(want_grad), rtol=0, atol=1e-6)


def _int_inputs(seed, n_ch):
    rng = np.random.default_rng(seed)
    raw = rng.integers(-(1 << 16), 1 << 16, (2, n_ch, H, W))
    flow_ch = FLOW_CHANNELS[n_ch]
    raw[:, flow_ch] = rng.integers(-(1 << 24), 1 << 24, (2, len(flow_ch), H, W))  # past +-2^22
    raw[:, flow_ch[0], :4] = rng.integers(-(1 << 14), 1 << 14, (2, 4, W))  # inside the frame
    raw[:, flow_ch[0], 4, :6] = -(1 << 12) * np.arange(6)  # exact negative multiples
    raw[:, 5] = rng.integers(-3000, 3000, (2, H, W))  # alpha, partly clipped
    if n_ch == 9:
        raw[:, 8] = rng.integers(-3000, 3000, (2, H, W))  # beta
    refs = [rng.integers(0, 4097, (2, 3, H, W)) for _ in range(2)]
    return raw.astype(np.int32), [r.astype(np.int32) for r in refs]


@pytest.mark.parametrize("n_ch,flow_gain", [(6, 1), (6, 3), (9, 1), (9, 255)])
def test_inter_predict_int_equals_jax_and_the_decoder(n_ch, flow_gain):
    raw, (ref0, ref1) = _int_inputs(n_ch + flow_gain, n_ch)
    r1 = ref1 if n_ch == 9 else None
    got = tic.inter_predict_int(torch.tensor(raw), torch.tensor(ref0),
                                None if r1 is None else torch.tensor(r1), flow_gain)
    assert got.dtype == torch.int32
    want = jax.vmap(lambda r, a, b: jic.inter_predict_int(r, a, b, flow_gain))(
        jnp.asarray(raw), jnp.asarray(ref0), jnp.asarray(ref1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for b in range(2):
        dec = tinter.process_inter_int(raw[b], ref0[b], None if r1 is None else r1[b], flow_gain)
        np.testing.assert_array_equal(got[b].numpy(), dec)
        np.testing.assert_array_equal(
            dec, jinter.process_inter_int(raw[b], ref0[b], None if r1 is None else r1[b],
                                          flow_gain))


# ---- frame forward --------------------------------------------------------- #
def random_params(seed, jcfg):
    """JAX-initialised params with every leaf made non-trivial (numpy)."""
    params = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)

    def perturb(a, s):
        return (a + s * rng.standard_normal(a.shape)).astype(np.float32)

    params["latents"] = [perturb(a, 0.3) for a in params["latents"]]
    params["arm"] = jax.tree.map(lambda a: perturb(a, 0.1), params["arm"])
    params["upsampling"] = jax.tree.map(lambda a: perturb(a, 0.05), params["upsampling"])
    params["synthesis"] = jax.tree.map(lambda a: perturb(a, 0.1), params["synthesis"])
    return params


def decoded_refs(rng, n, shape=(3, H, W)):
    """References as a decoder stores them: multiples of 1/255."""
    return [np.round(rng.uniform(size=shape) * 255).astype(np.float32) / np.float32(255)
            for _ in range(n)]


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("frame_type", ["P", "B"])
def test_inter_frame_forward_matches_jax(frame_type, training):
    jcfg, cfg = configs(frame_type)
    rows = [random_params(10 + b, jcfg) for b in range(2)]
    rng = np.random.default_rng(11)
    n_refs = "IPB".index(frame_type)
    refs = [np.stack(r) for r in zip(*[decoded_refs(rng, n_refs) for _ in range(2)])]
    kw = dict(quantizer_noise_type="none", quantizer_type="ste", soft_round_temperature=0.3,
              training=training)

    def jfwd(p, *r):
        return jax_frame_forward(p, jcfg, refs=r, **kw)

    dec_j, rate_j, extras_j = jax.vmap(jfwd)(
        jax.tree.map(lambda *a: jnp.asarray(np.stack(a)), *rows), *map(jnp.asarray, refs))
    params = stack_params([from_numpy_pytree(r, "cpu") for r in rows])
    dec_t, rate_t, _ = frame_forward(params, cfg, refs=tuple(map(torch.tensor, refs)), **kw)
    assert dec_t.shape == (2, 3, H, W)
    dec_t, dec_j = dec_t.detach().numpy(), np.asarray(dec_j)
    if training:
        np.testing.assert_allclose(dec_t, dec_j, rtol=1e-5, atol=1e-5)
        scale = np.exp(np.clip(np.asarray(extras_j["log_scale"]) - 4.0, -4.6, 5.0))
    else:
        levels_t, levels_j = np.round(dec_t * 255), np.round(dec_j * 255)
        np.testing.assert_allclose(dec_t, levels_t / 255, rtol=0, atol=1e-7)
        diff = np.abs(levels_t - levels_j)
        assert diff.max() <= 1 and all(np.count_nonzero(diff[b]) <= 3 for b in range(2))
        _, _, extras_train = jax.vmap(lambda p, *r: jax_frame_forward(
            p, jcfg, refs=r, **{**kw, "training": True}))(
            jax.tree.map(lambda *a: jnp.asarray(np.stack(a)), *rows), *map(jnp.asarray, refs))
        scale = np.exp(np.clip(np.asarray(extras_train["log_scale"]) - 4.0, -4.6, 5.0))
    rate_t, rate_j = rate_t.detach(), torch.tensor(np.asarray(rate_j))
    assert torch.all((rate_t - rate_j).abs() <= rate_tolerance(rate_j, torch.tensor(scale)))


def test_inter_levels_round_the_synthesis_output_as_the_decoder():
    """The eval forward's integer part on a given synthesis output: equal to
    the decoder's fixed-point path on the same 12-frac integers."""
    rng = np.random.default_rng(12)
    raw = (0.2 * rng.standard_normal((1, 9, H, W))).astype(np.float32)
    raw[:, [3, 4, 6, 7]] *= 20.0
    ref0, ref1 = decoded_refs(rng, 2)
    got = tic.inter_levels(torch.tensor(raw), torch.tensor(ref0[None]), torch.tensor(ref1[None]), 1)

    def store(r):
        return (np.round(r.astype(np.float64) * 255).astype(np.int64) << 12) // 255

    raw12 = np.round(raw[0].astype(np.float64) * 4096).astype(np.int64)
    f444 = tinter.process_inter_int(raw12, store(ref0), store(ref1), 1)
    want = np.clip((f444 * 255 + 2048) >> 12, 0, 255)
    np.testing.assert_array_equal(got[0].numpy(), want)


# ---- training and quantization on inter frames ----------------------------- #
@pytest.mark.parametrize("frame_type", ["P", "B"])
def test_run_phase_from_zero_latents_matches_jax(frame_type):
    """ste / no noise, 2 blocks of 5 steps, patience 0, from JAX's own init
    (zero latents: every border sample starts on a clip bound)."""
    kw = dict(lr=1e-2, max_itr=10, freq_valid=5, patience=0, schedule_lr=True,
              quantizer_type="ste", quantizer_noise_type="none",
              softround_temperature=(0.3, 0.2))
    jcfg, cfg = configs(frame_type)
    params = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(13)
    target = np.concatenate(decoded_refs(rng, 1 + "IPB".index(frame_type)))
    want_params, want_logs = jstep.run_phase(
        jax.tree.map(jnp.asarray, params), jnp.asarray(target), 1e-3, jax.random.PRNGKey(0),
        jcfg, jp.TrainerPhase(**kw))
    got_params, got_logs = tstep.run_phase(
        from_numpy_pytree(params, "cpu"), torch.tensor(target), 1e-3, cfg, TrainerPhase(**kw))
    np.testing.assert_allclose(
        [got_logs.loss, got_logs.psnr_db, got_logs.rate_latent_bpp],
        [float(want_logs.loss), float(want_logs.psnr_db), float(want_logs.rate_latent_bpp)],
        rtol=1e-4)
    assert got_logs.n_train_steps == 10
    for g, w in zip(jax.tree.leaves(to_numpy_pytree(got_params)), jax.tree.leaves(want_params)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-4)
    moved = [np.abs(g - p).max() for g, p in zip(jax.tree.leaves(to_numpy_pytree(got_params)),
                                                 jax.tree.leaves(params))]
    assert max(moved) > 1e-3


def test_quantize_model_on_a_p_frame_matches_jax():
    jcfg, cfg = configs("P")
    params = random_params(14, jcfg)
    target = np.concatenate(decoded_refs(np.random.default_rng(14), 2))
    want_params, want_infos = jax_quantize_model(
        jax.tree.map(jnp.asarray, params), jnp.asarray(target), 1e-3, jcfg)
    got_params, got_infos, _ = quantize_model_with_info(
        from_numpy_pytree(params, "cpu"), torch.tensor(target), 1e-3, cfg)
    for module, want in want_infos.items():
        got = got_infos[module]
        assert (got.q_step_w, got.q_step_b) == (float(want.q_step_w), float(want.q_step_b))
        assert (got.expgol_w, got.expgol_b) == (int(want.expgol_w), int(want.expgol_b))
    for g, w in zip(jax.tree.leaves(to_numpy_pytree(got_params)), jax.tree.leaves(want_params)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)


# ---- the video encoder ----------------------------------------------------- #
SEQ = f"seq_{W}x{H}_25fps_420_8b.yuv"
N_FRAMES = 3


def write_sequence(path):
    """A smooth texture moving one pixel right and half a pixel down per
    frame, plus noise; 4:2:0, 8 bit."""
    rng = np.random.default_rng(15)
    for t in range(N_FRAMES):
        y, x = np.mgrid[0:H, 0:W].astype(np.float32)
        x, y = x - t, y - 0.5 * t
        img = np.stack([0.5 + 0.3 * np.sin(x / 3.0) * np.cos(y / 4.0), 0.4 + 0.2 * np.sin(y / 5.0),
                        0.6 + 0.2 * np.cos((x + y) / 6.0)])
        img = np.clip(img + 0.02 * rng.standard_normal(img.shape), 0, 1).astype(np.float32)
        write_yuv({"y": img[:1], "u": img[1:2, ::2, ::2], "v": img[2:3, ::2, ::2]}, 8, "yuv420",
                  str(path))


@pytest.mark.parametrize("name", [SEQ, f"seq_{W}x{H}_25fps_444.yuv"])
def test_yuv_frame_loader_matches_jax(tmp_path, name):
    """Bitdepth from the "_8b" tag (else 10), 4:2:0 from a "420" tag."""
    from coolchic_tpu.io import image as jimage
    from coolchic_tpu_torch.io import image as timage

    path = str(tmp_path / name)
    if "420" in name:
        write_sequence(path)
    else:
        rng = np.random.default_rng(16)
        for _ in range(N_FRAMES):
            write_yuv(rng.uniform(size=(3, H, W)).astype(np.float32), 10, "yuv444", path)
    for idx in range(N_FRAMES):
        got = timage.load_frame_data_from_file(path, idx)
        want = jimage.load_frame_data_from_file(path, idx)
        assert (got.bitdepth, got.frame_data_type, got.img_size) == (
            want.bitdepth, want.frame_data_type, want.img_size) == (
            8 if "_8b" in name else 10, "yuv420" if "420" in name else "yuv444", (H, W))
        for k in ("y", "u", "v") if "420" in name else (None,):
            g, w = (got.data, want.data) if k is None else (got.data[k], want.data[k])
            np.testing.assert_array_equal(g, w)


def micro_phases(module):
    """A deterministic recipe (ste, no noise) of ``module``'s presets: one
    phase that ends with the quantization search, no warm-up."""
    phase = module.TrainerPhase(lr=1e-2, max_itr=12, freq_valid=6, patience=1000,
                                schedule_lr=True, quantize_model=True, quantizer_type="ste",
                                quantizer_noise_type="none", softround_temperature=(0.3, 0.2))
    return module.Preset(preset_name="micro", all_phases=(phase,), warmup=module.Warmup())


def jax_warmup(targets, lmbdas, cfg, warmup_cfg, seeds, valid_hws=None, stats=None):
    """The port's warm-up replaced by JAX's initialisation for the same seed
    (the JAX encoder's key is PRNGKey(seed + 7919 * coding order + loop))."""
    jcfg = JaxConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(JaxConfig)})
    params = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(seeds[0]), jcfg))
    return tree_map(lambda t: t[None], from_numpy_pytree(params, targets.device))


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """The sequence, and both packages' encoders run on it (intra 2, p 2: I,
    then P at display 2, then B at display 1)."""
    tmp = tmp_path_factory.mktemp("video")
    path = tmp / SEQ
    write_sequence(path)
    cfg = dict(ARCH, frame_data_type="yuv420")
    want = jenc.VideoEncoder(jcs.CodingStructure(2, 2), JaxConfig(**cfg), micro_phases(jp),
                             lmbda=2e-3)
    assert want.encode(str(path), seed=5, verbose=False) == jenc.TrainingExitCode.END
    mp = pytest.MonkeyPatch()
    mp.setattr(tencode, "warmup", jax_warmup)
    got = tenc.VideoEncoder(tcs.CodingStructure(2, 2), CoolChicConfig(**cfg),
                            micro_phases(tpresets), lmbda=2e-3, device="cpu")
    assert got.encode(str(path), seed=5, verbose=False) == tenc.TrainingExitCode.END
    mp.undo()
    return path, want, got


def test_video_encoder_matches_jax_frame_by_frame(videos):
    _, want, got = videos
    assert set(got.all_frame_encoders) == set(want.all_frame_encoders) == {"0", "1", "2"}
    for k, w in want.all_frame_encoders.items():
        g = got.all_frame_encoders[k]
        assert g.manager.lmbda == w.manager.lmbda
        np.testing.assert_allclose([g.manager.best_loss, g.psnr_db],
                                   [w.manager.best_loss, w.psnr_db], rtol=1e-3)
        np.testing.assert_allclose(g.rate_latent_bpp, w.rate_latent_bpp, rtol=1e-2, atol=1e-3)
        assert g.decoded.shape == (3, H, W) and g.decoded.dtype == np.float32
    assert (got.bitdepth, got.frame_data_type) == (want.bitdepth, want.frame_data_type)


def test_video_writer_fed_jax_params_gives_jax_bytes(videos):
    _, want, got = videos
    twin = tenc.VideoEncoder(got.coding_structure, got.cfg, got.preset, device="cpu")
    twin.bitdepth, twin.frame_data_type = want.bitdepth, want.frame_data_type
    for k, w in want.all_frame_encoders.items():
        twin.all_frame_encoders[k] = tenc.EncodedFrame(
            params=w.params, infos=w.infos, manager=w.manager, psnr_db=w.psnr_db,
            rate_latent_bpp=w.rate_latent_bpp, decoded=w.decoded)
    assert twin.to_bitstream() == bytes(want.to_bitstream())
    assert twin.to_bitstream(8) == bytes(want.to_bitstream(8))


def test_video_stream_decodes_to_the_encoders_references(videos):
    """The drift-free property: both decoders give, frame by frame and
    exactly, the reconstructions the encoder trained the next frames on."""
    _, _, got = videos
    data = got.to_bitstream()
    by_display = {got.coding_structure.get_frame_from_coding_order(int(k)).display_order: e
                  for k, e in got.all_frame_encoders.items()}
    for decode in (tdec.decode_video_bitstream, jdec.decode_video_bitstream):
        frames, info = decode(data)
        assert info["gop_header"].frame_data_type == "yuv420"
        assert len(frames) == N_FRAMES
        for disp, frame in enumerate(frames):
            np.testing.assert_array_equal(frame, by_display[disp].decoded)
    frames_py, _ = tdec.decode_video_bitstream(data, full_info=True)
    for disp, frame in enumerate(frames_py):
        np.testing.assert_array_equal(frame, by_display[disp].decoded)


def test_reused_frame_bytes_equal_a_fresh_write(videos):
    _, _, got = videos
    for k, e in got.all_frame_encoders.items():
        frame = got.coding_structure.get_frame_from_coding_order(int(k))
        assert e.frame_bytes == got._write_frame(to_numpy_pytree(e.params), e.infos, frame, 16)
    assert set(e.stats.stage_seconds) >= {"write", "integer_decode"}
    fresh = tenc.VideoEncoder(got.coding_structure, got.cfg, got.preset, device="cpu")
    fresh.bitdepth, fresh.frame_data_type = got.bitdepth, got.frame_data_type
    fresh.all_frame_encoders = {k: dataclasses.replace(e, frame_bytes=None)
                                for k, e in got.all_frame_encoders.items()}
    assert fresh.to_bitstream() == got.to_bitstream()
    assert fresh.to_bitstream(8) == got.to_bitstream(8) != got.to_bitstream()


def test_checkpoint_requeue_and_resume(videos, tmp_path, monkeypatch):
    """A budget of 0 minutes stops after the first frame with REQUEUE; the
    checkpoint resumes on the CPU and the final stream equals the
    uninterrupted run's."""
    path, _, got = videos
    monkeypatch.setattr(tencode, "warmup", jax_warmup)
    enc = tenc.VideoEncoder(got.coding_structure, got.cfg, got.preset, lmbda=2e-3, device="cpu")
    code = enc.encode(str(path), seed=5, job_duration_min=0, workdir=tmp_path, verbose=False)
    assert code == tenc.TrainingExitCode.REQUEUE and list(enc.all_frame_encoders) == ["0"]
    resumed = tenc.load_video_encoder(tmp_path / "video_encoder.pkl", device="cpu")
    assert list(resumed.all_frame_encoders) == ["0"]
    assert isinstance(resumed.all_frame_encoders["0"].params["latents"][0], np.ndarray)
    assert resumed.encode(str(path), seed=5, workdir=tmp_path, verbose=False) == (
        tenc.TrainingExitCode.END)
    assert resumed.to_bitstream() == got.to_bitstream()
    assert tenc.is_job_over(0.0, 10) and not tenc.is_job_over(0.0, -1)


def test_encode_cli_on_a_yuv(tmp_path, capsys):
    """``--config`` with the GOP, ``--device cpu``: one stream that both
    packages' decoders decode alike, and the JAX encoder's video columns."""
    from coolchic_tpu_torch.encode import main

    write_sequence(tmp_path / SEQ)
    (tmp_path / "run.yaml").write_text(yaml.safe_dump({
        "input": str(tmp_path / SEQ), "output": str(tmp_path / "seq.cool"),
        "workdir": str(tmp_path / "wd"), "lmbda": 1e-3,
        "enc_cfg": {"std_recipe_name": "debug", "n_itr": 20, "intra_period": 2, "p_period": 2},
        "dec_cfg": {"arm": "8,1", "layers_synthesis": "8-1-linear-relu,X-1-linear-none",
                    "n_ft_per_res": "1,1,1"},
    }))
    assert main(["--config", str(tmp_path / "run.yaml"), "--device", "cpu"]) == 0
    assert "seq_24x16_25fps_420_8b:" in capsys.readouterr().out
    data = (tmp_path / "seq.cool").read_bytes()
    got, info = tdec.decode_video_bitstream(data)
    want, _ = jdec.decode_video_bitstream(data)
    assert len(got) == len(want) == N_FRAMES and info["gop_header"].intra_period == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    header, row = (tmp_path / "wd" / "results_best.tsv").read_text().splitlines()
    assert header.split("\t") == ["seq_name", "lmbda", "rate_bpp", "n_pixels", "psnr_db",
                                  "rate_latent_bpp", "loss", "encoding_time_sec"]
    row = dict(zip(header.split("\t"), row.split("\t")))
    assert float(row["rate_bpp"]) == 8 * len(data) / (H * W * N_FRAMES)
    assert float(row["psnr_db"]) > 15.0 and row["loss"] == "nan"
    assert (tmp_path / "wd" / "video_encoder.pkl").exists()
