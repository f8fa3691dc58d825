"""Bitstream writer of the PyTorch port vs the JAX package: headers, CABAC
context tables, the integer ARM, the ctypes entropy backend and the writer.

Everything here is integer or byte exact: the same numpy inputs (made from a
seed) go through both packages and the results must be equal, not close.
The quantized decoders come from ``torch_bitstream_cases.py`` (random
parameters rounded to fixed q-steps; nothing is trained). The port receives
them as tensors through ``params.from_numpy_pytree``.

The port builds its own copy of the C++ library from ``cpp/`` into
``coolchic_tpu_torch/_build/``; the JAX package builds into ``cpp/`` itself
(untracked files that ``.gitignore`` lists).
"""

import subprocess
from pathlib import Path

import numpy as np
import pytest

from coolchic_tpu.bitstream import armint as jarmint
from coolchic_tpu.bitstream import contexts as jctx
from coolchic_tpu.bitstream import encode as jenc
from coolchic_tpu.bitstream import entropy as jent
from coolchic_tpu.bitstream import header as jhdr
from coolchic_tpu.models.config import CoolChicConfig as JaxConfig
from coolchic_tpu_torch.bitstream import armint as tarmint
from coolchic_tpu_torch.bitstream import contexts as tctx
from coolchic_tpu_torch.bitstream import encode as tenc
from coolchic_tpu_torch.bitstream import entropy as tent
from coolchic_tpu_torch.bitstream import header as thdr
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.params import from_numpy_pytree
from torch_bitstream_cases import CASES, case, rounded_case

REPO = Path(__file__).resolve().parents[1]

GOP_HEADERS = {
    "rgb8": dict(img_size=(512, 768)),
    "yuv420_10b": dict(img_size=(1080, 1920), frame_data_type="yuv420", bitdepth=10,
                       intra_period=8, p_period=4),
    "yuv444_16b": dict(img_size=(29, 37), frame_data_type="yuv444", bitdepth=16,
                       intra_period=2, p_period=2),
}


def _frame_header_fields(seed, display_index, dim_arm, n_hidden, n_grids, layers):
    rng = np.random.default_rng(seed)
    nets = ("arm", "upsampling", "synthesis")
    return dict(
        display_index=display_index, dim_arm=dim_arm, n_hidden_layers_arm=n_hidden,
        latent_n_grids=n_grids, ups_k_size=8, ups_preconcat_k_size=7,
        layers_synthesis=list(layers), flow_gain=int(rng.integers(0, 2)),
        ac_max_val_nn=int(rng.integers(2, 65535)), ac_max_val_latent=int(rng.integers(2, 65535)),
        hls_sig_blksize=int(rng.choice([-1, 8, 16])),
        q_step_index_nn={m: {p: int(rng.integers(0, 9)) for p in ("weight", "bias")} for m in nets},
        scale_index_nn={m: {p: int(rng.integers(0, 13)) for p in ("weight", "bias")} for m in nets},
        n_bytes_nn={m: {p: int(rng.integers(0, 65535)) for p in ("weight", "bias")} for m in nets},
        n_ft_per_latent=[1] * n_grids,
        n_bytes_per_latent=[int(rng.integers(0, 2**24)) for _ in range(n_grids)],
    )


FRAME_HEADERS = {
    "intra_default": (0, 0, 24, 2, 7, ["40-1-linear-relu", "3-1-linear-none",
                                       "3-3-residual-relu", "3-3-residual-none"]),
    "p_frame_display3": (1, 3, 8, 1, 3, ["16-1-linear-relu", "6-1-linear-none",
                                         "6-3-residual-relu"]),
    "b_frame_arm32": (2, 5, 32, 3, 4, ["8-1-linear-relu", "9-3-residual-none"]),
}


@pytest.mark.parametrize("name", GOP_HEADERS)
def test_gop_header_bytes_and_fields(name):
    fields = GOP_HEADERS[name]
    data = thdr.write_gop_header(thdr.GopHeader(**fields))
    assert data == jhdr.write_gop_header(jhdr.GopHeader(**fields))
    assert vars(thdr.read_gop_header(data)) == vars(jhdr.read_gop_header(data))
    got = thdr.read_gop_header(data)
    assert got.img_size == fields["img_size"] and got.bitdepth == fields.get("bitdepth", 8)


@pytest.mark.parametrize("name", FRAME_HEADERS)
def test_frame_header_bytes_and_fields(name):
    fields = _frame_header_fields(*FRAME_HEADERS[name])
    data = thdr.write_frame_header(thdr.FrameHeader(**fields))
    assert data == jhdr.write_frame_header(jhdr.FrameHeader(**fields))
    got, want = thdr.read_frame_header(data + b"tail"), jhdr.read_frame_header(data + b"tail")
    assert vars(got) == vars(want)
    assert got.display_index == fields["display_index"] and got.n_bytes_header == len(data)


def test_frame_header_with_a_wrong_size_field_raises():
    data = thdr.write_frame_header(thdr.FrameHeader(**_frame_header_fields(
        *FRAME_HEADERS["intra_default"])))
    wrong = (len(data) + 1).to_bytes(2, "big") + data[2:]
    with pytest.raises(ValueError, match="header size"):
        thdr.read_frame_header(wrong)


def test_context_states_equal():
    got, want = tctx.generate_context_states(), jctx.generate_context_states()
    assert got.dtype == want.dtype and got.shape == (17, 50, 5)
    np.testing.assert_array_equal(got, want)


def test_emit_inc_file_writes_the_tracked_table(tmp_path):
    tctx.emit_inc_file(str(tmp_path / "port.inc"))
    jctx.emit_inc_file(str(tmp_path / "jax.inc"))
    text = (tmp_path / "port.inc").read_text()
    assert text == (tmp_path / "jax.inc").read_text()
    assert text == (REPO / "cpp" / "gen_contexts.inc").read_text()


def test_val_mu_indices_equal():
    rng = np.random.default_rng(0)
    for mu, ls in zip(rng.integers(-4000, 4000, 300), rng.integers(-600, 2600, 300)):
        assert tctx.get_val_mu_indices(int(mu), int(ls)) == jctx.get_val_mu_indices(int(mu), int(ls))


def _arm_params(dim_arm, n_hidden, seed):
    rng = np.random.default_rng(seed)
    return {"layers": [
        {"weight": np.round(rng.standard_normal((out_d, dim_arm)) * 0.3 * 256) / 256,
         "bias": np.round(rng.standard_normal(out_d) * 65536) / 65536}
        for out_d in [dim_arm] * n_hidden + [2]]}


@pytest.mark.parametrize("dim_arm,n_hidden", [(8, 1), (16, 2), (24, 2), (32, 3)])
def test_integer_arm_is_exact(dim_arm, n_hidden):
    """Latents up to a few thousand: the int32 products of the hidden layers
    wrap, and both packages must wrap alike."""
    rng = np.random.default_rng(dim_arm)
    arm = _arm_params(dim_arm, n_hidden, dim_arm + 1)
    got, want = tarmint.integerize_arm_params(arm), jarmint.integerize_arm_params(arm)
    for g, w in zip(got, want):
        assert g["weight"].dtype == np.int32 and g["bias"].dtype == np.int32
        np.testing.assert_array_equal(g["weight"], w["weight"])
        np.testing.assert_array_equal(g["bias"], w["bias"])
    # Half-way values round away from zero.
    half = {"layers": [{"weight": np.array([[0.5 / 256, -0.5 / 256, 1.5 / 256, -2.5 / 256]]),
                        "bias": np.array([0.5 / 65536, -1.5 / 65536])}]}
    np.testing.assert_array_equal(tarmint.integerize_arm_params(half)[0]["weight"],
                                  [[1, -1, 2, -3]])
    np.testing.assert_array_equal(tarmint.integerize_arm_params(half)[0]["bias"], [1, -2])

    grid = rng.integers(-3000, 3000, (2, 19, 23)).astype(np.int32)
    ctx_t, ctx_j = tarmint.context_int(grid, dim_arm), jarmint.context_int(grid, dim_arm)
    assert ctx_t.dtype == np.int32 and ctx_t.shape == (2 * 19 * 23, dim_arm)
    np.testing.assert_array_equal(ctx_t, ctx_j)
    np.testing.assert_array_equal(tarmint.context_int(grid[0], dim_arm),
                                  jarmint.context_int(grid[0], dim_arm))
    with np.errstate(over="ignore"):
        mu_t, ls_t = tarmint.armint_forward(got, ctx_t)
        mu_j, ls_j = jarmint.armint_forward(want, ctx_j)
    np.testing.assert_array_equal(mu_t, mu_j)
    np.testing.assert_array_equal(ls_t, ls_j)
    assert np.abs(mu_t).max() > 2**16  # the inputs did reach large values


def test_port_library_is_built_outside_cpp():
    path = Path(tent.build_library())
    assert path.exists() and path.name == "libccz.so"
    assert (REPO / "coolchic_tpu_torch" / "_build") in path.parents
    tent.probe_bitstream(b"\x00" * 16)  # loads the library
    status = subprocess.run(["git", "status", "--porcelain", "cpp/"], cwd=REPO,
                            capture_output=True, text=True, timeout=60)
    assert status.returncode == 0 and status.stdout == ""


@pytest.mark.parametrize("use_count", [-1, 0, 3, 12])
def test_code_wb_bytes_and_order(use_count):
    rng = np.random.default_rng(3)
    values = np.round(rng.laplace(0, 12, 700)).astype(np.int64)
    got, want = tent.code_wb(values, use_count), jent.code_wb(values, use_count)
    assert got == want
    data, count = got
    assert count == (use_count if use_count >= 0 else count) and 0 <= count <= 12
    with tent.WbDecoder(data) as dec:
        back = np.concatenate([dec.decode_continue(300, count), dec.decode_continue(400, count)])
    np.testing.assert_array_equal(back, values)
    jdec = jent.WbDecoder(data)
    np.testing.assert_array_equal(jdec.decode_continue(700, count), values)
    jdec.close()


@pytest.mark.parametrize("blk", [8, 16, -1])
def test_latent_layer_coder_bytes_and_round_trip(blk):
    rng = np.random.default_rng(blk + 2)
    h, w = 21, 34
    xs = np.round(rng.laplace(0, 2.0, (h, w))).astype(np.int32)
    xs[:8, :16] = 0  # an all-zero significance block
    mus = rng.integers(-512, 512, (h, w)).astype(np.int32)
    log_scales = rng.integers(-300, 900, (h, w)).astype(np.int32)
    data = tent.code_latent_layer(xs, mus, log_scales, h, w, blk)
    assert data == jent.code_latent_layer(xs, mus, log_scales, h, w, blk)
    got = tent.decode_latent_layer(data, mus, log_scales, h, w, blk)
    np.testing.assert_array_equal(got, xs)
    np.testing.assert_array_equal(got, jent.decode_latent_layer(data, mus, log_scales, h, w, blk))
    with pytest.raises(ValueError, match="latent layer"):
        tent.code_latent_layer(xs, mus[:-1], log_scales, h, w, blk)


@pytest.mark.parametrize("dim_arm,n_hidden", [(8, 1), (16, 2), (24, 2), (32, 2)])
def test_arm_latent_layer_decode_equal(dim_arm, n_hidden):
    """Code one grid with the integer ARM's (mu, log sigma), then decode it
    sequentially with the C++ ARM through both bindings."""
    rng = np.random.default_rng(dim_arm)
    h, w = 17, 26
    arm = tarmint.integerize_arm_params(_arm_params(dim_arm, n_hidden, 5))
    y = np.round(rng.laplace(0, 2.5, (1, h, w))).astype(np.int32)
    mu, ls = tarmint.armint_forward(arm, tarmint.context_int(y, dim_arm))
    data = tent.code_latent_layer(y[0], mu, ls, h, w, 16)
    got = tent.decode_arm_latent_layer(data, arm, dim_arm, n_hidden, h, w, 16)
    np.testing.assert_array_equal(got, y[0])
    np.testing.assert_array_equal(
        got, jent.decode_arm_latent_layer(data, arm, dim_arm, n_hidden, h, w, 16))


def test_ups_syn_int_equal():
    rng = np.random.default_rng(11)
    heights, widths = [29, 15, 8], [37, 19, 10]
    latents = [rng.integers(-20, 20, (1, h, w)) for h, w in zip(heights, widths)]
    ups = rng.integers(-3000, 3000, 2 * 8)
    pre = rng.integers(-500, 500, 2 * 7)
    desc = np.array([[8, 1, 0, 1], [3, 1, 0, 0], [3, 3, 1, 0]])
    syn_w = rng.integers(-2000, 2000, 8 * 3 + 3 * 8 + 3 * 3 * 9)
    syn_b = rng.integers(-2**22, 2**22, 8 + 3 + 3)
    args = (latents, heights, widths, 8, 7, ups, pre, syn_w, syn_b, desc)
    got = tent.ups_syn_int(*args)
    assert got.shape == (3, 29, 37) and got.dtype == np.int32
    np.testing.assert_array_equal(got, jent.ups_syn_int(*args))


@pytest.mark.parametrize("name", CASES)
def test_module_symbols_exact(name):
    arch, params, _q, _eg, _blk = case(name)
    tparams = from_numpy_pytree(params, "cpu")
    for module, (iw, ib) in {"arm": (0, 0), "upsampling": (0, 0), "synthesis": (2, 8)}.items():
        got = tenc.module_symbols(tparams, module, iw, ib)
        want = jenc.module_symbols(params, module, iw, ib)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    # Coarser ARM q-steps shift toward zero.
    got = tenc.module_symbols(tparams, "arm", 3, 5)
    want = jenc.module_symbols(params, "arm", 3, 5)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("name", CASES)
def test_image_bitstream_is_byte_identical(name):
    arch, params, q, eg, blk = case(name)
    want = jenc.encode_image_bitstream(params, JaxConfig(**arch), q, eg, hls_sig_blksize=blk)
    timings = {}
    got = tenc.encode_image_bitstream(from_numpy_pytree(params, "cpu"), CoolChicConfig(**arch),
                                      q, eg, hls_sig_blksize=blk, timings=timings)
    assert got == want
    assert timings["armint_s"] > 0 and timings["entropy_s"] > 0
    if name == "all_zero_grid":
        assert thdr.read_frame_header(got[9:]).n_bytes_per_latent[1] == 0  # empty substream
    if name == "frozen_grid0":
        assert thdr.read_frame_header(got[9:]).n_bytes_per_latent[0] == 0
    if name == "blk8":
        assert thdr.read_frame_header(got[9:]).hls_sig_blksize == 8


@pytest.mark.parametrize("name,bitdepth,fdt", [("arm8_3grids", 10, "yuv444"),
                                                ("arm16_4grids_29x37", 16, "rgb")])
def test_image_bitstream_other_bitdepths(name, bitdepth, fdt):
    arch, params, q, eg, blk = case(name, seed=2)
    want = jenc.encode_image_bitstream(params, JaxConfig(**arch), q, eg, bitdepth, fdt, blk)
    got = tenc.encode_image_bitstream(from_numpy_pytree(params, "cpu"), CoolChicConfig(**arch),
                                      q, eg, bitdepth, fdt, blk)
    assert got == want


@pytest.mark.parametrize("name,out_channels,display_index,flow_gain",
                         [("arm8_3grids", 3, 0, 0), ("arm8_3grids", 6, 1, 1),
                          ("arm16_4grids_29x37", 9, 2, 1)])
def test_frame_bitstream_is_byte_identical(name, out_channels, display_index, flow_gain):
    """Frame payloads (also of P / B frames, 6 / 9 synthesis outputs), with
    the decoder-matched params and the integer latents that the writer
    returns beside the bytes."""
    arch, params, q, eg, blk = rounded_case(7, **dict(CASES[name], out_channels=out_channels))
    want = jenc.encode_frame_bitstream(params, JaxConfig(**arch), q, eg, display_index, blk,
                                       flow_gain)
    got = tenc.encode_frame_bitstream(from_numpy_pytree(params, "cpu"), CoolChicConfig(**arch),
                                      q, eg, display_index, blk, flow_gain)
    assert got[0] == want[0]
    for module in ("arm", "synthesis"):
        for g, w in zip(got[1][module]["layers"], want[1][module]["layers"]):
            np.testing.assert_array_equal(g["weight"], w["weight"])
            np.testing.assert_array_equal(g["bias"], w["bias"])
    for key in ("ups", "preconcat"):
        for g, w in zip(got[1]["upsampling"][key], want[1]["upsampling"][key]):
            np.testing.assert_array_equal(g, w)
    for g, w, lat in zip(got[2], want[2], params["latents"]):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, np.round(lat.astype(np.float64) * 16))
    fh = thdr.read_frame_header(got[0])
    assert fh.display_index == display_index and fh.flow_gain == flow_gain

