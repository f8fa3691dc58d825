"""The port's small modules against their JAX counterparts on the same
inputs, as ``tests/test_misc_tools.py`` and ``tests/test_eval.py`` hold the
JAX package: ``macs_per_pixel`` and the console reports, ``rgb2yuv`` /
``yuv2rgb``, ``detailed_eval_metrics``, the BD-rate functions on the repo's
``results/`` files, the RD plots, the named presets, ``encode_simpler``,
``retrain_latents`` and the encode CLI's ``--disable_wandb``.

Tolerances (f32 on the CPU): strings, presets, colour transforms and BD-rate
numbers equal; eval metrics rtol = atol = 1e-4 and the rate by
``models/arm.py::rate_tolerance``.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coolchic_tpu import encode as jax_encode_cli
from coolchic_tpu.bitstream import decode_bitstream as jax_decode_bitstream
from coolchic_tpu.eval import plotting as jplot
from coolchic_tpu.io import image as jimage
from coolchic_tpu.models.config import CoolChicConfig as JaxConfig
from coolchic_tpu.models.coolchic import init_coolchic_params as jax_init_params
from coolchic_tpu.models.coolchic import macs_per_pixel as jax_macs_per_pixel
from coolchic_tpu.train import presets as jp
from coolchic_tpu.train.step import detailed_eval_metrics as jax_detailed_eval_metrics
from coolchic_tpu.train.step import eval_metrics as jax_eval_metrics
from coolchic_tpu.utils import console as jconsole
from coolchic_tpu_torch import encode as port_encode_cli
from coolchic_tpu_torch import encode_simpler, retrain_latents
from coolchic_tpu_torch.bitstream import decode_bitstream
from coolchic_tpu_torch.eval import plotting as tplot
from coolchic_tpu_torch.io import image as timage
from coolchic_tpu_torch.models.arm import arm_rate_plain, rate_tolerance
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.models.coolchic import frame_forward, macs_per_pixel
from coolchic_tpu_torch.params import from_numpy_pytree, to_numpy_pytree
from coolchic_tpu_torch.train import presets as tp
from coolchic_tpu_torch.train.step import detailed_eval_metrics, eval_metrics
from coolchic_tpu_torch.utils import console as tconsole
from coolchic_tpu_torch.utils.paths import COOLCHIC_REPO_ROOT, RESULTS_DIR
from coolchic_tpu_torch.utils.types import DecoderConfig
from coolchic_tpu_torch.video import CodingStructure, VideoEncoder, load_video_encoder

# The packages' eval/__init__ export a function named bd_rate over the module's name.
jbd = importlib.import_module("coolchic_tpu.eval.bd_rate")
tbd = importlib.import_module("coolchic_tpu_torch.eval.bd_rate")
# Jitted once (eager JAX runs these op by op for ~15 s).
jax_detailed_eval_metrics = jax.jit(jax_detailed_eval_metrics, static_argnums=1)
jax_eval_metrics = jax.jit(jax_eval_metrics, static_argnums=1)

SMALL = dict(n_ft_per_res=(1, 1, 1), layers_synthesis=("8-1-linear-relu", "X-1-linear-none"),
             dim_arm=8, n_hidden_layers_arm=1)
ARCHS = {
    "small_16x24": dict(img_size=(16, 24), **SMALL),
    "default_512x768": {f.name: getattr(DecoderConfig().to_coolchic_config((512, 768)), f.name)
                        for f in dataclasses.fields(CoolChicConfig)},
    "odd_29x37": dict(img_size=(29, 37), n_ft_per_res=(1, 1, 1, 1), dim_arm=16,
                      n_hidden_layers_arm=2, layers_synthesis=(
                          "16-1-linear-relu", "X-1-linear-none", "X-3-residual-relu")),
}


def configs(name):
    return CoolChicConfig(**ARCHS[name]), JaxConfig(**ARCHS[name])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(h, w, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x / w, y / h, 0.5 + 0.2 * np.sin(x / 3.0)])
    return np.clip(img + 0.03 * rng.standard_normal(img.shape), 0, 1).astype(np.float32)


def _png(path, h, w, seed=0):
    jimage.write_png(_image(h, w, seed), str(path))
    return np.asarray(jimage.read_png(str(path))[0])


# --------------------------------------------------------------------------- complexity, console


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_macs_and_console_strings_equal_jax(name):
    cfg, jcfg = configs(name)
    assert macs_per_pixel(cfg) == jax_macs_per_pixel(jcfg)
    assert tconsole.pretty_string_coolchic(cfg) == jconsole.pretty_string_coolchic(jcfg)
    assert tconsole.pretty_string_latents(cfg) == jconsole.pretty_string_latents(jcfg)


def test_repo_paths():
    assert (COOLCHIC_REPO_ROOT / "coolchic_tpu_torch").is_dir()
    assert (RESULTS_DIR / "image" / "kodak" / "results.tsv").is_file()
    assert tp.PRESET_CFG_DIR == COOLCHIC_REPO_ROOT / "preset_cfg"


def test_colour_transforms_equal_jax():
    rgb = np.random.default_rng(0).uniform(0, 255, (3, 7, 9))
    np.testing.assert_array_equal(timage.rgb2yuv(rgb), jimage.rgb2yuv(rgb))
    yuv = timage.rgb2yuv(rgb)
    np.testing.assert_array_equal(timage.yuv2rgb(yuv), jimage.yuv2rgb(yuv))
    np.testing.assert_allclose(timage.yuv2rgb(yuv), rgb, atol=2.0)  # rounded YUV


# --------------------------------------------------------------------------- detailed eval


@pytest.mark.parametrize("name", ["small_16x24", "odd_29x37"])
def test_detailed_eval_metrics_match_jax(name):
    cfg, jcfg = configs(name)
    params = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg,
                                                     latent_init="normal"))
    # Latents large enough that every grid has nonzero quantized values.
    params["latents"] = [30.0 * latent for latent in params["latents"]]
    target = np.random.default_rng(1).uniform(size=(3, *cfg.img_size)).astype(np.float32)
    want = jax_detailed_eval_metrics(params, jcfg, jnp.asarray(target), 1e-3, 123.0)
    tparams = from_numpy_pytree(params, "cpu")
    got = detailed_eval_metrics(tparams, cfg, torch.tensor(target), 1e-3, 123.0)
    assert set(got) == set(want)
    m = eval_metrics(tparams, cfg, torch.tensor(target), 1e-3, 123.0)
    for k in ("loss", "psnr_db", "mse", "rate_latent_bpp", "rate_nn_bpp", "total_rate_bpp"):
        assert got[k].item() == getattr(m, k).item(), k  # the same one forward
    for k in ("loss", "psnr_db", "mse", "rate_nn_bpp"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4, atol=1e-4)

    # Per grid: the rate within the summed rate_tolerance of its latents.
    with torch.no_grad():
        _, rate, extras = frame_forward(tparams, cfg, training=False)
        y_hat = [torch.round(y * cfg.encoder_gain) for y in tparams["latents"]]
        log_scale = arm_rate_plain(y_hat, tparams["arm"], cfg.dim_arm)[2]
    tol = rate_tolerance(rate, torch.exp(torch.clamp(log_scale - 4.0, -4.6, 5.0)))
    start = 0
    for i, (c, h, w) in enumerate(cfg.latent_shapes):
        n = c * h * w
        bound = float(tol[start:start + n].sum()) / cfg.n_pixels
        assert abs(got[f"latent_{i}_bpp"].item() - float(want[f"latent_{i}_bpp"])) <= bound, i
        pct = got[f"latent_{i}_nonzero_pct"].item()
        assert pct == pytest.approx(float(want[f"latent_{i}_nonzero_pct"]), rel=1e-6)
        assert 0.0 < pct <= 100.0
        start += n
    total = sum(got[f"latent_{i}_bpp"].item() for i in range(cfg.latent_n_grids))
    assert total == pytest.approx(got["rate_latent_bpp"].item(), rel=1e-5)
    assert abs(got["total_rate_bpp"].item() - float(want["total_rate_bpp"])) <= (
        float(tol.sum()) / cfg.n_pixels)


# --------------------------------------------------------------------------- BD-rate, plots


def test_bd_rate_functions_equal_jax():
    r, p = [0.1, 0.3, 0.7, 1.5], [30.0, 33.0, 36.0, 39.0]
    r2, p2 = [0.12, 0.28, 0.75, 1.4], [30.5, 33.2, 35.9, 39.4]
    for piecewise in (False, True):
        assert tbd.bd_rate(r, p, r2, p2, piecewise) == jbd.bd_rate(r, p, r2, p2, piecewise)
    assert tbd.bd_psnr(r, p, r2, p2) == jbd.bd_psnr(r, p, r2, p2)
    assert tbd.bd_rate(r, p, np.array(r) / 2, p) == pytest.approx(-50.0, abs=1e-6)


def _anchors():
    return sorted((d.name, f.stem) for d in (RESULTS_DIR / "image").iterdir() if d.is_dir()
                  for f in d.glob("*.tsv"))


def test_result_parsing_and_bd_rate_vs_anchor_equal_jax():
    anchors = _anchors()
    assert ("kodak", "hm") in anchors and ("clic20-pro-valid", "vtm") in anchors
    for dataset, anchor in anchors:
        path = tbd.anchor_path(dataset, anchor)
        assert path == jbd.anchor_path(dataset, anchor)
        assert tbd.parse_result_summary(path) == jbd.parse_result_summary(path), path
    for dataset, anchor in anchors:
        summary = tbd.parse_result_summary(tbd.anchor_path(dataset, "results"))
        got = tbd.bd_rate_vs_anchor(summary, dataset, anchor)
        want = jbd.bd_rate_vs_anchor(summary, dataset, anchor)
        np.testing.assert_equal(got, want)
        np.testing.assert_equal(tbd.avg_bd_rate_vs_anchor(summary, dataset, anchor),
                                jbd.avg_bd_rate_vs_anchor(summary, dataset, anchor))
    kodak = tbd.parse_result_summary(tbd.anchor_path("kodak", "results"))
    assert tbd.avg_bd_rate_vs_anchor(kodak, "kodak", "hm") == pytest.approx(-16.5, abs=1.0)


def test_write_results_tsv_round_trips(tmp_path):
    rows = [{"seq_name": "a", "lmbda": 1e-3, "rate_bpp": 0.5, "psnr_db": 31.0},
            {"seq_name": "a", "lmbda": 4e-3, "rate_bpp": 0.2, "psnr_db": 28.0}]
    tbd.write_results_tsv(rows, tmp_path / "port.tsv")
    jbd.write_results_tsv(rows, tmp_path / "jax.tsv")
    assert (tmp_path / "port.tsv").read_text() == (tmp_path / "jax.tsv").read_text()
    assert tbd.parse_result_summary(tmp_path / "port.tsv")["a"][0]["rate_bpp"] == 0.5


def _lines(fig):
    return [(line.get_label(), line.get_xydata().tolist()) for ax in fig.axes for line in ax.lines]


def test_plots_equal_jax(tmp_path):
    import matplotlib.pyplot as plt

    summaries = {a: jbd.parse_result_summary(jbd.anchor_path("kodak", a))
                 for a in ("results", "hm")}
    runs = {a: [r for rows in s.values() for r in rows] for a, s in summaries.items()}
    pairs = [
        (tplot.gen_rd_plot(runs, "kodim01"), jplot.gen_rd_plot(runs, "kodim01")),
        (tplot.gen_rd_plot(runs), jplot.gen_rd_plot(runs)),
        (tplot.plot_rd_curves(summaries, "kodim05"), jplot.plot_rd_curves(summaries, "kodim05")),
    ]
    points = [{"n_itr": n, "avg_bd_rate": b, "n_train_loops": k}
              for n, b, k in ((1000, 9.0, 1), (3000, 4.0, 1), (1000, 7.0, 2))]
    pairs.append((tplot.plot_bd_rate_vs_iterations(points, "hm", 2.0),
                  jplot.plot_bd_rate_vs_iterations(points, "hm", 2.0)))
    for got, want in pairs:
        assert _lines(got) and _lines(got) == _lines(want)
        plt.close(got)
        plt.close(want)
    out = tmp_path / "rd.png"
    tplot.plot_dataset_rd("kodak", ["results", "hm"], "kodim01", out)
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and out.stat().st_size > 1000
    assert tplot.print_md_table({"b": 1.0, "a": -2.5}) == jplot.print_md_table({"b": 1.0, "a": -2.5})


# --------------------------------------------------------------------------- presets


def test_named_presets():
    asdict = dataclasses.asdict
    assert asdict(tp.preset_c3x(n_itr_per_phase=10600)) == asdict(tp.load_preset("c3x"))
    assert asdict(tp.preset_c3x(n_itr_per_phase=10600)) == asdict(jp.preset_c3x(n_itr_per_phase=10600))
    assert asdict(tp.preset_c3x(2e-3, 500)) == asdict(jp.preset_c3x(2e-3, 500))
    assert asdict(tp.preset_debug()) == asdict(tp.load_preset("debug"))
    # JAX's preset_debug warms up with other values than its debug.yaml (noise
    # 1.0 against 2.0, patience and freq_valid); the port's follows the YAML,
    # which both encode CLIs read. The training phases are equal.
    assert asdict(tp.preset_debug(3e-3))["all_phases"] == asdict(jp.preset_debug(3e-3))["all_phases"]
    assert asdict(tp.preset_measure_speed(5e-3, 700)) == asdict(jp.preset_measure_speed(5e-3, 700))
    assert set(tp.AVAILABLE_PRESETS) == set(jp.AVAILABLE_PRESETS)


# --------------------------------------------------------------------------- CLIs

SIMPLE_ARCH = ["--n_ft_per_res", "1,1,1", "--layers_synthesis", "8-1-linear-relu,X-1-linear-none",
               "--dim_arm", "8", "--n_hidden_layers_arm", "1"]


def test_encode_simpler_stream_decodes_alike_in_jax(tmp_path, capsys):
    img = _png(tmp_path / "img.png", 32, 48)
    out = encode_simpler.encode(encode_simpler._build_argparser().parse_args(
        ["-i", str(tmp_path / "img.png"), "-o", str(tmp_path / "img.cool"), "--budget", "debug",
         "--device", "cpu", *SIMPLE_ARCH]))
    assert "bitstream:" in capsys.readouterr().out
    stream = (tmp_path / "img.cool").read_bytes()
    assert out["bytes"] == len(stream) and out["rate_bpp"] == len(stream) * 8 / (32 * 48)
    ours, _ = decode_bitstream(stream, integer_pipeline=True)
    theirs, _ = jax_decode_bitstream(stream, integer_pipeline=True)
    np.testing.assert_array_equal(np.asarray(theirs), ours)
    psnr = -10 * np.log10(np.mean((ours - img) ** 2))
    assert out["psnr_db"] == pytest.approx(psnr, rel=1e-6) and psnr > 15.0
    assert abs(out["psnr_db"] - out["psnr_db_estimate"]) < 0.1


@pytest.fixture(scope="module")
def video_checkpoint(tmp_path_factory):
    """A port ``video_encoder.pkl`` of one 24x32 intra frame."""
    root = tmp_path_factory.mktemp("retrain")
    img = _png(root / "img.png", 24, 32, seed=3)
    cfg = CoolChicConfig(img_size=(24, 32), **SMALL)
    phase = tp.TrainerPhase(lr=1e-2, max_itr=30, freq_valid=10, schedule_lr=True,
                            quantizer_type="softround", quantizer_noise_type="gaussian",
                            softround_temperature=(0.3, 0.1), noise_parameter=(0.25, 0.1),
                            quantize_model=True)
    enc = VideoEncoder(CodingStructure(0, 0), cfg, tp.Preset("micro", all_phases=(phase,)),
                       lmbda=1e-3, device="cpu")
    enc.encode(str(root / "img.png"), workdir=root, verbose=False)
    return root, img, cfg


def test_retrain_latents_starts_from_jax_loss_and_learns(video_checkpoint, capsys):
    root, img, cfg = video_checkpoint
    ckpt = root / "video_encoder.pkl"
    before = load_video_encoder(ckpt, device="cpu").all_frame_encoders["0"]
    assert before.frame_bytes is not None
    out = retrain_latents.retrain(retrain_latents._build_argparser().parse_args(
        ["--checkpoint", str(ckpt), "--input", str(root / "img.png"), "--init", "zeros",
         "--n_itr", "40", "--device", "cpu"]))
    assert "updated" in capsys.readouterr().out
    # JAX's eval of the checkpoint's params with zeroed latents.
    params = {**before.params, "latents": [np.zeros_like(l) for l in before.params["latents"]]}
    want = jax_eval_metrics(params, JaxConfig(img_size=(24, 32), **SMALL), jnp.asarray(img),
                            before.manager.lmbda)
    np.testing.assert_allclose(out["loss_before"], float(want.loss), rtol=1e-4)
    assert out["loss_after"] < out["loss_before"]
    after = load_video_encoder(ckpt, device="cpu").all_frame_encoders["0"]
    assert after.frame_bytes is None  # written anew by to_bitstream
    for a, b in zip(after.params["arm"]["layers"], before.params["arm"]["layers"]):
        np.testing.assert_array_equal(a["weight"], b["weight"])  # latents only
    m = eval_metrics(from_numpy_pytree(after.params, "cpu"), cfg, torch.tensor(img), 1e-3)
    assert m.loss.item() == pytest.approx(out["loss_after"], rel=1e-5)


def test_encode_cli_takes_disable_wandb(tmp_path, monkeypatch):
    argv = ["--input", "img.png", "--lmbda", "2e-3", "--enc_preset", "debug", "--n_itr", "7",
            "--disable_wandb"]
    got = vars(port_encode_cli._build_argparser().parse_args(argv))
    want = vars(jax_encode_cli._build_argparser().parse_args(argv))
    assert {k: v for k, v in got.items() if k != "device"} == want
    assert got["disable_wandb"] is True

    # One logging run per encode run, disabled, holding the run's row.
    from coolchic_tpu_torch.utils import logging as cclog

    calls = []
    monkeypatch.setattr(cclog, "init", lambda **kw: calls.append(("init", kw["disable"])))
    monkeypatch.setattr(cclog, "log", lambda row, step: calls.append(("log", row["lmbda"], step)))
    monkeypatch.setattr(cclog, "finish", lambda: calls.append(("finish",)))
    row = {"seq_name": "img", "lmbda": 2e-3, "psnr_db": 30.0, "rate_bpp": 0.5,
           "rate_latent_bpp": 0.4, "encoding_time_sec": 1.0}
    monkeypatch.setattr(port_encode_cli, "encode_one_run",
                        lambda *a: port_encode_cli.EncodeRun(row, None, None))
    assert port_encode_cli.main(argv) == 0
    assert calls == [("init", True), ("log", 2e-3, 0), ("finish",)]
