"""Hypernet inference of the PyTorch port against the JAX package, on the
tiny decoder of ``tests/test_hypernet_quant.py`` (32x32, 3 grids, dim_arm 8,
a resnet18 backbone, 8 hidden channels in the latent encoder, the default
1024-wide heads): the batched eval forward of the three whole nets against
JAX's ``vmap``, ``image_to_coolchic``, ``LatentDecoder``, the delta
quantization search, the delta-subset searches, the one-shot encode to a
``.cool`` stream (byte for byte), checkpoints in both directions, the
dataset sweep and its CSV, and finetuning.

Weights: flax's init and the decoder's, every leaf then perturbed with a
seeded numpy draw (at init the delta heads output exact zeros, every q-step
pair of the delta search would tie, and its test would prove nothing), and
bridged to the port. Images: numpy, from seeds. The JAX side is built once,
in a module fixture.

Tolerances (f32 on the CPU): decoded images and losses rtol = atol = 1e-4;
rates by ``models.arm.rate_tolerance``; the delta search's q-steps and
exp-Golomb orders, the selected delta subset and the stream's bytes equal.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coolchic_tpu.hypernet import inference as jinf
from coolchic_tpu.hypernet.finetune import finetune_coolchic as jax_finetune
from coolchic_tpu.hypernet.latent_decoder import LatentDecoder as JaxLatentDecoder
from coolchic_tpu.hypernet.wholenet import DeltaWholeNet as JaxDelta
from coolchic_tpu.hypernet.wholenet import NOWholeNet as JaxNO
from coolchic_tpu.hypernet.wholenet import SmallDeltaWholeNet as JaxSmall
from coolchic_tpu.hypernet.wholenet import WholeNetState as JaxState
from coolchic_tpu.models.config import CoolChicConfig as JaxConfig
from coolchic_tpu.models.coolchic import init_coolchic_params as jax_init_params
from coolchic_tpu.train import presets as jp
from coolchic_tpu.train.quantize_model import quantize_delta_module as jax_quantize_delta_module
from coolchic_tpu_torch.bitstream import decode_bitstream
from coolchic_tpu_torch.hypernet import DeltaWholeNet, NOWholeNet, SmallDeltaWholeNet, WholeNetState
from coolchic_tpu_torch.hypernet import inference as tinf
from coolchic_tpu_torch.hypernet.blocks import init_params
from coolchic_tpu_torch.hypernet.bridge import flax_to_state_dict, state_dict_to_flax
from coolchic_tpu_torch.hypernet.finetune import finetune_coolchic
from coolchic_tpu_torch.hypernet.latent_decoder import LatentDecoder
from coolchic_tpu_torch.models.arm import arm_rate_plain, rate_tolerance
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.models.coolchic import coolchic_forward
from coolchic_tpu_torch.params import from_numpy_pytree, to_numpy_pytree, tree_map
from coolchic_tpu_torch.train.presets import TrainerPhase
from coolchic_tpu_torch.train.quantize_model import Q_STEPS, quantize_delta_module

ARCH = dict(img_size=(32, 32), n_ft_per_res=(1, 1, 1),
            layers_synthesis=("8-1-linear-relu", "X-1-linear-none"), dim_arm=8,
            n_hidden_layers_arm=1)
JCFG, TCFG = JaxConfig(**ARCH), CoolChicConfig(**ARCH)
LMBDA = 1e-3
TOL = dict(rtol=1e-4, atol=1e-4)


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


def images(n=3):
    """A gradient image and noisy variants, [n, 3, 32, 32] in [0, 1]."""
    y, x = np.mgrid[0:32, 0:32] / 31.0
    base = np.stack([x, y, 0.5 * (x + y)])
    rng = np.random.default_rng(0)
    return np.clip(np.stack([base + 0.05 * i * rng.standard_normal(base.shape)
                             for i in range(n)]), 0, 1).astype(np.float32)


def jitted(net):
    """The JAX net with its prediction and forward jitted (the same
    functions: eager, a resnet18 forward compiles op by op for ~30 s)."""
    for name in ("predict", "predict_latents"):
        if hasattr(net, name):
            setattr(net, name, jax.jit(getattr(net, name)))
    net.forward = jax.jit(net.forward, static_argnames=("training",))
    return net


@pytest.fixture(scope="module")
def side():
    """The JAX nets and states, and the port's with the same weights."""
    jd = jitted(JaxDelta(JCFG, backbone_arch="resnet18", n_hidden_channels=8))
    hyper = jax.jit(jd.module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    dec = {k: v for k, v in jax_init_params(jax.random.PRNGKey(1), JCFG).items() if k != "latents"}
    hyper, dec = perturb(hyper, 0), perturb(dec, 1)
    js = JaxState(hypernet=hyper, decoder=dec)
    td = DeltaWholeNet(TCFG, backbone_arch="resnet18", n_hidden_channels=8)
    ts = WholeNetState(hypernet=flax_to_state_dict(hyper), decoder=from_numpy_pytree(dec, "cpu"))

    small_t = SmallDeltaWholeNet(TCFG, n_hidden_channels=8)
    small_h = perturb(state_dict_to_flax(
        init_params(small_t.module, torch.Generator().manual_seed(2), "cpu")), 2)
    nets = {
        "delta": (jd, js, td, ts),
        "full": (jitted(JaxDelta(JCFG, backbone_arch="resnet18", mode="full",
                                 n_hidden_channels=8)), js,
                 DeltaWholeNet(TCFG, backbone_arch="resnet18", mode="full", n_hidden_channels=8),
                 ts),
        "no": (jitted(JaxNO(JCFG, n_hidden_channels=8)), js._replace(hypernet=hyper["LatentHyperNet_0"]),
               NOWholeNet(TCFG, n_hidden_channels=8),
               ts._replace(hypernet=flax_to_state_dict(hyper["LatentHyperNet_0"]))),
        "small": (jitted(JaxSmall(JCFG, n_hidden_channels=8)), js._replace(hypernet=small_h),
                  small_t, ts._replace(hypernet=flax_to_state_dict(small_h))),
    }
    imgs = images()
    # The zero-delta trap: the perturbed heads predict deltas away from zero.
    _, deltas = td.predict(ts, torch.tensor(imgs))
    assert min(float(t.abs().max()) for t in jax.tree.leaves(
        tree_map(lambda t: t.detach(), deltas))) > 1e-3
    return {"nets": nets, "imgs": imgs,
            "jax_qdeltas": jinf.quantize_image_deltas(jd, js, jnp.asarray(imgs[0]), LMBDA)}


def assert_rate_close(got, want, nets_arm, latents):
    """Rates [B, n] against the JAX ones, with the Laplace scale of the plain
    ARM on the quantized latents (B decoders, each with its own ARM)."""
    y_hat = [torch.round(y * TCFG.encoder_gain) for y in latents]
    log_scale = arm_rate_plain(y_hat, nets_arm, TCFG.dim_arm)[2]
    scale = torch.exp(torch.clamp(log_scale - 4.0, -4.6, 5.0))
    want = torch.tensor(np.asarray(want))
    assert torch.all((got - want).abs() <= rate_tolerance(want, scale))


@pytest.mark.parametrize("name", ["no", "delta", "full", "small", "delta_without_deltas"])
def test_wholenet_eval_forward_matches_jax_vmap(side, name):
    jnet, jstate, tnet, tstate = side["nets"]["delta" if name == "delta_without_deltas" else name]
    if name == "delta_without_deltas":
        jnet = jitted(JaxDelta(JCFG, n_hidden_channels=8))
        tnet = DeltaWholeNet(TCFG, n_hidden_channels=8)
        jnet.use_delta = tnet.use_delta = False
    imgs = side["imgs"]
    want_out, want_rate = jnet.forward(jstate, jnp.asarray(imgs), training=False)
    with torch.no_grad():
        got_out, got_rate = tnet.forward(tstate, torch.tensor(imgs), training=False)
        if name == "no":
            latents, arm = tnet.predict_latents(tstate, torch.tensor(imgs)), tree_map(
                lambda t: t.expand(3, *t.shape), tstate.decoder["arm"])
        else:
            latents, deltas = tnet.predict(tstate, torch.tensor(imgs))
            arm = tnet._nets(tstate, deltas)["arm"]
    assert got_out.shape == (3, 3, 32, 32) and got_rate.shape == (3, TCFG.n_latents)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), **TOL)
    assert_rate_close(got_rate, want_rate, arm, latents)


@pytest.mark.parametrize("name", ["no", "delta", "full"])
def test_image_to_coolchic_matches_jax(side, name):
    jnet, jstate, tnet, tstate = side["nets"][name]
    img = side["imgs"][1]
    want = jnet.image_to_coolchic(jstate, jnp.asarray(img))
    got = to_numpy_pytree(tnet.image_to_coolchic(tstate, torch.tensor(img)))
    assert jax.tree.structure(got) == jax.tree.structure(jax.tree.map(np.asarray, want))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("bias_only", [False, True])
def test_latent_decoder_matches_jax(side, bias_only):
    _, jstate, _, tstate = side["nets"]["delta"]
    rng = np.random.default_rng(3)
    latents = [(0.3 * rng.standard_normal(s)).astype(np.float32) for s in TCFG.latent_shapes]
    key = "bias" if bias_only else "weight"
    syn_d = [0.05 * rng.standard_normal(l[key].shape).astype(np.float32)
             for l in jstate.decoder["synthesis"]["layers"]]
    arm_d = [0.05 * rng.standard_normal(l[key].shape).astype(np.float32)
             for l in jstate.decoder["arm"]["layers"]]
    jdec, tdec = JaxLatentDecoder(JCFG, bias_only), LatentDecoder(TCFG, bias_only)
    want_out, want_rate, _ = jdec.forward(jstate.decoder, [jnp.asarray(y) for y in latents],
                                          syn_d, arm_d, training=False)
    t_lat = [torch.tensor(y) for y in latents]
    t_syn, t_arm = [torch.tensor(d) for d in syn_d], [torch.tensor(d) for d in arm_d]
    got_out, got_rate, _ = tdec.forward(tstate.decoder, t_lat, t_syn, t_arm, training=False)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), **TOL)
    folded = tdec.as_coolchic(tstate.decoder, t_lat, t_syn, t_arm)
    assert_rate_close(got_rate[None], np.asarray(want_rate)[None],
                      tree_map(lambda t: t[None], folded["arm"]), [y[None] for y in t_lat])
    want_params = jdec.as_coolchic(jstate.decoder, [jnp.asarray(y) for y in latents], syn_d, arm_d)
    for a, b in zip(jax.tree.leaves(to_numpy_pytree(folded)), jax.tree.leaves(want_params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-7)
    # the folded params through the stored-latent forward: the same decoder
    again, rate_again, _ = coolchic_forward(folded, TCFG, training=False)
    np.testing.assert_array_equal(again.numpy(), got_out.numpy())
    np.testing.assert_array_equal(rate_again.numpy(), got_rate.numpy())


def assert_infos_equal(got, want):
    assert set(got) == set(want)
    for m in want:
        g, w = got[m], want[m]
        assert (g.q_step_w, g.q_step_b) == (float(w.q_step_w), float(w.q_step_b)), m
        assert (g.expgol_w, g.expgol_b) == (int(w.expgol_w), int(w.expgol_b)), m
        assert abs(g.rate_bits - float(w.rate_bits)) <= 1e-4 * max(1.0, float(w.rate_bits)), m


def test_quantize_delta_module_upsampling_matches_jax(side):
    """The 13-pair search of one module, from the same deltas and latents."""
    jnet, jstate, _, tstate = side["nets"]["delta"]
    img = side["imgs"][0]
    lat, deltas = jnet.predict(jstate, jnp.asarray(img)[None])
    lat0 = [np.asarray(y[0]) for y in lat]
    delta0 = jax.tree.map(lambda d: np.asarray(d[0]), deltas)
    want_d, want_i = jax.jit(jax_quantize_delta_module, static_argnames=("module", "cfg"))(
        jstate.decoder, delta0, module="upsampling", latents=[jnp.asarray(y) for y in lat0],
        target=jnp.asarray(img), lmbda=LMBDA, cfg=JCFG, other_nn_rate_bits=jnp.float32(0.0))
    got_d, got_i = quantize_delta_module(
        tstate.decoder, from_numpy_pytree(delta0, "cpu"), "upsampling",
        [torch.tensor(y) for y in lat0], torch.tensor(img), LMBDA, TCFG, 0.0)
    assert_infos_equal({"upsampling": got_i}, {"upsampling": want_i})
    for a, b in zip(jax.tree.leaves(to_numpy_pytree(got_d)), jax.tree.leaves(want_d)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_quantize_model_deltas_matches_jax(side):
    _, _, tnet, tstate = side["nets"]["delta"]
    want_lat, want_q, want_infos = side["jax_qdeltas"]
    got_lat, got_q, got_infos = tinf.quantize_image_deltas(
        tnet, tstate, torch.tensor(side["imgs"][0]), LMBDA)
    assert_infos_equal(got_infos, want_infos)
    # Zero deltas make every pair tie and the first pair win in every module;
    # these deltas do not.
    assert any((i.q_step_w, i.q_step_b) != (Q_STEPS[m]["weight"][0], Q_STEPS[m]["bias"][0])
               for m, i in got_infos.items())
    for a, b in zip(jax.tree.leaves(to_numpy_pytree(got_q)), jax.tree.leaves(want_q)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    for a, b in zip(got_lat, want_lat):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("rated", [False, True])
def test_delta_subset_search_matches_jax(side, rated):
    jnet, jstate, tnet, tstate = side["nets"]["delta"]
    img = side["imgs"][2]
    fn = "eval_image_delta_subsets_rated" if rated else "eval_image_delta_subsets"
    want = getattr(jinf, fn)(jnet, jstate, jnp.asarray(img), LMBDA)
    got = getattr(tinf, fn)(tnet, tstate, torch.tensor(img), LMBDA)
    assert got["option_selected"] == want["option_selected"]
    assert set(got) == set(want)
    for k in set(want) - {"option_selected"}:
        np.testing.assert_allclose(got[k], want[k], **TOL)


def test_hypernet_to_bitstream_gives_jax_bytes(side):
    jnet, jstate, tnet, tstate = side["nets"]["delta"]
    img = side["imgs"][0]
    want, want_info = jinf.hypernet_to_bitstream(jnet, jstate, jnp.asarray(img), LMBDA)
    got, got_info = tinf.hypernet_to_bitstream(tnet, tstate, torch.tensor(img), LMBDA)
    assert_infos_equal(got_info["delta_infos"], want_info["delta_infos"])
    assert_infos_equal(got_info["nn_infos"], want_info["nn_infos"])
    assert got == want
    decoded, _ = decode_bitstream(got, integer_pipeline=True)
    assert decoded.shape == (3, 32, 32) and np.isfinite(decoded).all()


def test_checkpoints_cross_between_packages(side, tmp_path):
    """A JAX checkpoint loads into the port and a port checkpoint into JAX,
    with equal weights and outputs; a directory loads its highest
    samples_N.pkl (the __latest rule) with its sample counter."""
    jnet, jstate, tnet, tstate = side["nets"]["delta"]
    imgs = jnp.asarray(side["imgs"][:2])
    jinf.save_checkpoint(jstate, tmp_path / "jax" / "samples_100.pkl", 100)
    loaded = tinf.load_checkpoint(tmp_path / "jax", device="cpu")
    assert set(loaded.hypernet) == set(tstate.hypernet)
    for k, v in tstate.hypernet.items():
        assert torch.equal(loaded.hypernet[k], v), k
    with torch.no_grad():
        a = tnet.forward(loaded, torch.tensor(np.asarray(imgs)), training=False)
        b = tnet.forward(tstate, torch.tensor(np.asarray(imgs)), training=False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))

    tinf.save_checkpoint(tstate, tmp_path / "port" / "samples_100.pkl", 100)
    later = tstate._replace(decoder=tree_map(lambda t: t + 1.0, tstate.decoder))
    tinf.save_checkpoint(later, tmp_path / "port" / "samples_500.pkl", 500)
    back, seen = jinf.load_checkpoint_meta(tmp_path / "port")
    assert seen == 500
    for x, y in zip(jax.tree.leaves(back.decoder), jax.tree.leaves(to_numpy_pytree(later.decoder))):
        np.testing.assert_array_equal(np.asarray(x), y)
    first = jinf.load_checkpoint(tmp_path / "port" / "samples_100.pkl")
    assert jax.tree.structure(first.hypernet) == jax.tree.structure(jstate.hypernet)
    for x, y in zip(jax.tree.leaves(first.hypernet), jax.tree.leaves(jstate.hypernet)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    out_first, _ = jnet.forward(first, imgs, training=False)
    out_orig, _ = jnet.forward(jstate, imgs, training=False)
    np.testing.assert_array_equal(np.asarray(out_first), np.asarray(out_orig))
    port_latest, port_seen = tinf.load_checkpoint_meta(tmp_path / "port", device="cpu")
    assert port_seen == 500 and torch.equal(port_latest.decoder["arm"]["layers"][0]["bias"],
                                            later.decoder["arm"]["layers"][0]["bias"])


@pytest.mark.parametrize("name,search", [("no", False), ("delta", False), ("delta", True)])
def test_eval_dataset_csv_matches_jax(side, name, search, tmp_path):
    jnet, jstate, tnet, tstate = side["nets"][name]
    named = [(f"img{i}", img) for i, img in enumerate(side["imgs"])]
    want = jinf.eval_dataset(jnet, jstate, named, LMBDA, tmp_path / "jax.csv",
                             delta_subset_search=search)
    got = tinf.eval_dataset(tnet, tstate, named, LMBDA, tmp_path / "port.csv",
                            delta_subset_search=search)
    assert len(got) == len(want) == 3
    with open(tmp_path / "jax.csv") as f:
        want_rows = list(csv.DictReader(f))
    with open(tmp_path / "port.csv") as f:
        got_rows = list(csv.DictReader(f))
    assert list(got_rows[0]) == list(want_rows[0])
    for g, w in zip(got_rows, want_rows):
        for k in w:
            if k in ("seq_name", "option_selected"):
                assert g[k] == w[k]
            else:
                np.testing.assert_allclose(float(g[k]), float(w[k]), **TOL)


def test_finetune_matches_jax_without_noise(side):
    """One STE phase without noise (nothing random): the one-shot metrics,
    the finetuned metrics and the params."""
    jnet, jstate, tnet, tstate = side["nets"]["delta"]
    img = side["imgs"][1]
    kw = dict(lr=1e-3, max_itr=20, freq_valid=10, quantizer_type="ste",
              quantizer_noise_type="none", softround_temperature=(1e-4, 1e-4))
    jm0, jparams, jlogs = jax_finetune(jnet, jstate, jnp.asarray(img), LMBDA,
                                       jax.random.PRNGKey(0), (jp.TrainerPhase(**kw),))
    tm0, tparams, tlogs = finetune_coolchic(tnet, tstate, torch.tensor(img), LMBDA, 0,
                                            (TrainerPhase(**kw),))
    for k in ("loss", "psnr_db", "rate_latent_bpp"):
        np.testing.assert_allclose(float(getattr(tm0, k)), float(getattr(jm0, k)), **TOL)
        np.testing.assert_allclose(getattr(tlogs, k), float(getattr(jlogs, k)), **TOL)
    assert tlogs.loss < float(tm0.loss)
    for a, b in zip(jax.tree.leaves(to_numpy_pytree(tparams)), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)
