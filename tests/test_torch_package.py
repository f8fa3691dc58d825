"""Guards of the PyTorch port: no JAX import, the params bridge, the device
default of the entry points, the presets and decoder configs read from the
repo's YAML files, the expansion of a multi-valued ``UserConfig``, and the
encode CLI on the CPU (one run, and the runs of a ``--config`` file)."""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from coolchic_tpu.models.coolchic import init_coolchic_params as jax_init_params
from coolchic_tpu.models.config import CoolChicConfig as JaxConfig
from coolchic_tpu.utils.types import DecoderConfig as JaxDecoderConfig
from coolchic_tpu.utils.types import EncoderConfig as JaxEncoderConfig
from coolchic_tpu.utils.types import UserConfig as JaxUserConfig
from coolchic_tpu_torch.params import flatten_with_paths, from_numpy_pytree, to_numpy_pytree
from coolchic_tpu_torch.train.presets import load_preset
from coolchic_tpu_torch.utils.types import DecoderConfig, UserConfig, resolve_device

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "coolchic_tpu")


# The test helpers that run without JAX: in a rank, and beside chip_smoke.py.
TEST_HELPERS = sorted((REPO / "tests").glob("torch_*.py"))


def _package_files():
    return sorted((REPO / "coolchic_tpu_torch").rglob("*.py"))


def _port_files():
    return _package_files() + [REPO / "chip_smoke.py"] + TEST_HELPERS


def _imports(path):
    """The modules ``path`` imports, anywhere in it, relative ones resolved."""
    package = ".".join(path.relative_to(REPO).with_suffix("").parts[:-1])
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package.rsplit(".", node.level - 1)[0] if node.level else ""
            yield ".".join(p for p in (base, node.module or "") if p)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    for name in _imports(path):
        assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_process_launcher_imports_no_kernel_wrapper():
    """``parallel/`` starts ranks and runs the engine on them; what the
    kernels launched is for a caller to count and return from its rank."""
    for path in sorted((REPO / "coolchic_tpu_torch" / "parallel").glob("*.py")):
        for name in _imports(path):
            assert not (name + ".").startswith("coolchic_tpu_torch.ops."), \
                f"{path}: imports {name}"


def test_package_imports_nothing_from_the_tests():
    helpers = {"tests", "conftest"} | {p.stem for p in TEST_HELPERS}
    for path in _package_files():
        for name in _imports(path):
            assert name.split(".")[0] not in helpers, f"{path}: imports {name}"


def test_importing_the_encoder_loads_no_jax():
    code = ("import sys, coolchic_tpu_torch.encode, coolchic_tpu_torch.train.encode, "
            "coolchic_tpu_torch.decode, coolchic_tpu_torch.bitstream, coolchic_tpu_torch.video, "
            "coolchic_tpu_torch.video.encoder, coolchic_tpu_torch.video.intercoding, "
            "coolchic_tpu_torch.bitstream.decode, coolchic_tpu_torch.bitstream.inter, "
            "coolchic_tpu_torch.utils.sanity_check, coolchic_tpu_torch.hypernet.inference, "
            "coolchic_tpu_torch.hypernet.finetune, coolchic_tpu_torch.hypernet.training, "
            "coolchic_tpu_torch.hypernet_train, coolchic_tpu_torch.eval.hypernet, "
            "coolchic_tpu_torch.metalearning, coolchic_tpu_torch.utils.logging, "
            "coolchic_tpu_torch.parallel, coolchic_tpu_torch.parallel.mesh, "
            "coolchic_tpu_torch.encode_simpler, coolchic_tpu_torch.retrain_latents, "
            "coolchic_tpu_torch.eval, coolchic_tpu_torch.eval.bd_rate, "
            "coolchic_tpu_torch.eval.plotting, coolchic_tpu_torch.utils.console, "
            "coolchic_tpu_torch.utils.paths; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'coolchic_tpu', 'matplotlib')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_params_round_trip_is_bit_identical():
    params = jax_init_params(jax.random.PRNGKey(0), JaxConfig(img_size=(13, 21)),
                             latent_init="normal")
    np_params = jax.tree.map(np.asarray, params)
    back = to_numpy_pytree(from_numpy_pytree(np_params, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    flat = flatten_with_paths(back)
    assert "arm/layers/0/weight" in flat and "upsampling/preconcat/5" in flat
    assert len(flat) == len(jax.tree.leaves(np_params))


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("name", ["c3x", "debug"])
def test_presets_match_jax(name):
    want = JaxEncoderConfig(std_recipe_name=name, n_itr=1234).recipe.to_preset()
    got = load_preset(name, n_itr=1234)
    assert got.preset_name == want.preset_name
    assert len(got.all_phases) == len(want.all_phases)
    for g, w in zip(got.all_phases, want.all_phases):
        assert vars(g) == vars(w)
    for g, w in zip(got.warmup.phases, want.warmup.phases):
        assert g.candidates == w.candidates and vars(g.training_phase) == vars(w.training_phase)
    assert got.all_phases[0].max_itr == 1234


@pytest.mark.parametrize("name", ["hop", "lop", "mop", "vlop", None])
def test_decoder_configs_match_jax(name):
    import yaml

    if name is None:
        got, want = DecoderConfig(), JaxDecoderConfig()
    else:
        path = REPO / "cfg" / "dec" / f"{name}.yaml"
        got = DecoderConfig.from_yaml(path)
        want = JaxDecoderConfig(**yaml.safe_load(open(path)))
    g, w = got.to_coolchic_config((32, 48)), want.to_coolchic_config((32, 48))
    for field in ("layers_synthesis", "n_ft_per_res", "dim_arm", "n_hidden_layers_arm",
                  "encoder_gain", "ups_k_size", "ups_preconcat_k_size", "latent_shapes"):
        assert getattr(g, field) == getattr(w, field), field


def _png(path, h=24, w=32):
    from PIL import Image

    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x / w, y / h, 0.5 + 0.2 * np.sin(x / 3.0)], -1)
    img = np.clip(img + 0.03 * rng.standard_normal(img.shape), 0, 1)
    Image.fromarray((img * 255).astype(np.uint8)).save(path)


@pytest.fixture
def one_torch_thread():
    """A 24x32 encode gains nothing from intra-op threads, and several test
    processes spinning a thread per core slow each other down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_encodes_a_png_on_the_cpu(tmp_path, one_torch_thread):
    from coolchic_tpu_torch.encode import main

    _png(tmp_path / "img.png")
    workdir = tmp_path / "wd"
    assert main(["--input", str(tmp_path / "img.png"), "--enc_preset", "debug",
                 "--dec_cfg", str(REPO / "cfg" / "dec" / "vlop.yaml"),
                 "--workdir", str(workdir), "--device", "cpu"]) == 0
    header, row = (workdir / "results_best.tsv").read_text().splitlines()
    row = dict(zip(header.split("\t"), row.split("\t")))
    assert header.split("\t")[:9] == ["seq_name", "lmbda", "rate_bpp", "n_pixels", "psnr_db",
                                      "psnr_db_estimate", "rate_latent_bpp", "loss",
                                      "encoding_time_sec"]
    assert row["n_pixels"] == str(24 * 32)
    assert np.isfinite(float(row["rate_bpp"])) and float(row["rate_bpp"]) > float(row["rate_nn_bpp"])
    assert np.isfinite(float(row["psnr_db"])) and float(row["psnr_db"]) > 15.0
    assert float(row["psnr_db_estimate"]) > 15.0 and float(row["rate_nn_bpp"]) > 0.0
    saved = np.load(workdir / "params_quantized.npz")
    assert saved["latents/0"].shape == (1, 24, 32)
    q = float(saved["q_step/arm/weight"])
    w = saved["arm/layers/0/weight"]
    np.testing.assert_allclose(w / q, np.round(w / q), atol=1e-4)
    assert int(saved["expgol/synthesis/bias"]) in range(13)


USER_CONFIGS = {
    "lists": """
input: [a.png, b.ppm]
lmbda: [1e-3, 4e-3, 2e-2]
workdir: out
output: out/stream.cool
enc_cfg: {std_recipe_name: debug, n_itr: 120, n_train_loops: 2, start_lr: 1e-2, intra_period: 0, p_period: 0}
dec_cfg:
  - {arm: "8,1", layers_synthesis: "8-1-linear-relu,X-1-linear-none", n_ft_per_res: "1,1,1"}
  - {config_name: wide, arm: "24,2", ups_k_size: 4}
""",
    "single_values": """
input: a.png
lmbda: 0.002
enc_cfg: {std_recipe_name: c3x}
dec_cfg: {arm: "16,2"}
""",
    "default_lmbda": """
input: [a.png, b.png]
enc_cfg: {std_recipe_name: debug}
dec_cfg: {}
""",
    # An inline recipe, its first phase cut by n_itr, the latent module named
    # as the reference names it.
    "inline_recipe": """
input: a.png
lmbda: [1e-3, 2e-3]
enc_cfg:
  n_itr: 77
  recipe:
    preset_name: my_recipe
    warmup:
      phases:
        - candidates: 3
          training_phase: {lr: 1e-2, max_itr: 40, freq_valid: 20}
        - candidates: 1
          training_phase: {max_itr: 20, freq_valid: 10, quantizer_noise_type: gaussian, noise_parameter: [0.25, 0.1]}
    all_phases:
      - {lr: 1e-2, max_itr: 500, freq_valid: 50, patience: 200, schedule_lr: true, softround_temperature: [0.3, 0.1], noise_parameter: [2.0, 1.0]}
      - {lr: 1e-4, max_itr: 30, freq_valid: 10, quantize_model: true, quantizer_type: ste, quantizer_noise_type: none, optimized_module: [latent, arm]}
dec_cfg: {arm: "8,1"}
""",
    # A hypernet recipe ("hnet" in its name) may have no quantization phase.
    "inline_hnet_recipe": """
input: a.png
enc_cfg:
  recipe:
    preset_name: hnet_finetune
    warmup: {phases: []}
    all_phases:
      - {lr: 1e-3, max_itr: 100, freq_valid: 100, quantizer_type: softround, quantizer_noise_type: gaussian}
dec_cfg: {}
""",
    # Fields of the JAX package's config that its CLI reads and ignores.
    "ignored_fields": """
input: a.png
job_duration_min: 30
disable_wandb: true
load_models: false
user_tag: nightly
enc_cfg: {std_recipe_name: debug, n_itr: 50}
dec_cfg: {}
""",
}


@pytest.mark.parametrize("name", sorted(USER_CONFIGS))
def test_user_config_expansion_matches_jax(name, tmp_path):
    """inputs x lambdas x decoder configs, in the JAX package's order."""
    import yaml

    path = tmp_path / "runs.yaml"
    path.write_text(USER_CONFIGS[name])
    want = JaxUserConfig(**yaml.safe_load(path.read_text())).get_run_configs()
    user = UserConfig.from_yaml(path)
    got = user.get_run_configs()
    assert len(got) == len(want) == len(user.input) * len(user.lmbda) * len(user.dec_cfg)
    for g, w in zip(got, want):
        assert (g.input, g.lmbda, g.workdir, g.output) == (w.input, w.lmbda, w.workdir, w.output)
        for field in ("config_name", "layers_synthesis", "arm", "ups_k_size",
                      "ups_preconcat_k_size", "n_ft_per_res", "encoder_gain"):
            assert getattr(g.dec_cfg, field) == getattr(w.dec_cfg, field), field
        for field in ("std_recipe_name", "n_itr", "n_train_loops"):
            assert getattr(g.enc_cfg, field) == getattr(w.enc_cfg, field), field
        want_preset = w.enc_cfg.recipe.to_preset()
        assert g.enc_cfg.recipe.preset_name == want_preset.preset_name
        assert [vars(p) for p in g.enc_cfg.recipe.all_phases] == [
            vars(p) for p in want_preset.all_phases]
        assert [(p.candidates, vars(p.training_phase)) for p in g.enc_cfg.recipe.warmup.phases] \
            == [(p.candidates, vars(p.training_phase)) for p in want_preset.warmup.phases]


@pytest.mark.parametrize("text,match", [
    ("input: a.png\nenc_cfg: {std_recipe_name: debug}\ndec_cfg: {}\nwandb: true", "wandb"),
    ("input: a.png\nenc_cfg: {std_recipe_name: debug}\ndec_cfg: {arms: '8,1'}", "arms"),
    ("input: a.png\nenc_cfg: {std_recipe_name: debug, lr: 1}\ndec_cfg: {}", "lr"),
    ("lmbda: 1e-3\nenc_cfg: {std_recipe_name: debug}\ndec_cfg: {}", "input"),
    ("input: a.png\nenc_cfg: {n_itr: 10}\ndec_cfg: {}", "One of"),
    ("input: a.png\nenc_cfg: {std_recipe_name: debug, recipe: {preset_name: x, warmup: {}, "
     "all_phases: [{quantize_model: true}]}}\ndec_cfg: {}", "Only one"),
    ("input: a.png\nenc_cfg: {recipe: {preset_name: x, warmup: {}, all_phases: [{lrr: 1, "
     "quantize_model: true}]}}\ndec_cfg: {}", "lrr"),
])
def test_user_config_rejects_unknown_and_missing_fields(text, match, tmp_path):
    path = tmp_path / "runs.yaml"
    path.write_text(text)
    with pytest.raises(ValueError, match=match):
        UserConfig.from_yaml(path)


def test_cli_config_writes_one_result_per_run(tmp_path, one_torch_thread, capsys):
    """Two lambdas x two decoder configs on one image: four runs, each with
    its own results_best.tsv and stream, in the expansion's order."""
    from coolchic_tpu_torch.encode import main

    _png(tmp_path / "img.png", 16, 24)
    cfg = tmp_path / "runs.yaml"
    cfg.write_text(f"""
input: {tmp_path / 'img.png'}
lmbda: [1e-3, 2e-2]
workdir: {tmp_path / 'wd'}
output: {tmp_path / 'wd' / 'img.cool'}
enc_cfg: {{std_recipe_name: debug, n_itr: 20}}
dec_cfg:
  - {{arm: "8,1", layers_synthesis: "8-1-linear-relu,X-1-linear-none", n_ft_per_res: "1,1,1"}}
  - {{arm: "8,1", layers_synthesis: "8-1-linear-relu,X-1-linear-none,X-3-residual-none", n_ft_per_res: "1,1"}}
""")
    assert main(["--config", str(cfg), "--device", "cpu"]) == 0
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("img:")]
    assert len(lines) == 4
    rows = []
    for i in range(4):
        header, row = (tmp_path / "wd" / f"run_{i:03d}" / "results_best.tsv").read_text().splitlines()
        rows.append(dict(zip(header.split("\t"), row.split("\t"))))
        saved = np.load(tmp_path / "wd" / f"run_{i:03d}" / "params_quantized.npz")
        assert ("latents/2" in saved) == (i % 2 == 0)  # the decoder configs alternate
        assert (tmp_path / "wd" / f"img_{i:03d}.cool").stat().st_size * 8 == pytest.approx(
            float(rows[-1]["rate_bpp"]) * 16 * 24)
    assert [float(r["lmbda"]) for r in rows] == [1e-3, 1e-3, 2e-2, 2e-2]
    assert all(np.isfinite(float(r["psnr_db"])) for r in rows)


def test_cli_needs_an_input_or_a_config():
    from coolchic_tpu_torch.encode import main

    with pytest.raises(SystemExit):
        main(["--device", "cpu"])


def test_ppm_round_trip(tmp_path):
    from coolchic_tpu_torch.io.image import load_frame_data_from_file, write_ppm

    img = np.random.default_rng(1).uniform(size=(3, 5, 7)).astype(np.float32)
    write_ppm(img, 8, str(tmp_path / "a.ppm"))
    fd = load_frame_data_from_file(str(tmp_path / "a.ppm"))
    assert fd.img_size == (5, 7) and fd.bitdepth == 8
    np.testing.assert_allclose(fd.data, np.round(img * 255) / 255, atol=1e-6)
