"""Decoder of the PyTorch port vs the JAX package, and the whole path:
encode to a ``.cool`` stream with the port, decode it with both packages.

Streams are written by the JAX package from the quantized decoders of
``torch_bitstream_cases.py`` (numpy, from a seed; nothing is trained) and
decoded by both packages. Tolerances:
  * integer pipeline (one-call C route and python-orchestrated route):
    images, parsed params and latents **exactly equal**;
  * float pipeline on the CPU: both packages run the same f32 convolutions
    on the same decoded weights, then ``round(raw * max_dyn) / max_dyn``; a
    sample whose value sits at .5 within the convolutions' rounding error
    may flip by one level, so: max abs difference <= 1/255, and fewer than
    0.1 % of the samples differing;
  * video streams (handcrafted I / P / B payloads): frames exactly equal on
    both routes;
  * the port's own encode (debug preset, a 24x32 PNG, CPU): the written
    stream decodes to the same image with the JAX package's integer decoder
    as with the port's, and ``results_best.tsv`` carries that image's PSNR
    and the file's size.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from coolchic_tpu import decode as jax_decode_cli
from coolchic_tpu.bitstream import decode as jdec
from coolchic_tpu.bitstream import inter as jinter
from coolchic_tpu.bitstream.encode import encode_frame_bitstream as jax_encode_frame
from coolchic_tpu.bitstream.encode import encode_image_bitstream as jax_encode_image
from coolchic_tpu.bitstream.header import GopHeader as JaxGopHeader
from coolchic_tpu.bitstream.header import write_gop_header as jax_write_gop_header
from coolchic_tpu.io import image as jimage
from coolchic_tpu.models.config import CoolChicConfig as JaxConfig
from coolchic_tpu_torch import decode as decode_cli
from coolchic_tpu_torch.bitstream import decode as tdec
from coolchic_tpu_torch.bitstream import entropy as tent
from coolchic_tpu_torch.bitstream import inter as tinter
from coolchic_tpu_torch.io import image as timage
from torch_bitstream_cases import CASES, SYN_SMALL, case, rounded_case

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These sizes gain nothing from intra-op threads, and several test
    processes spinning a thread per core slow each other down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


C_ROUTE_CASES = [n for n in CASES if n != "two_ft_fallback"]


def _stream(name, seed=0, bitdepth=8):
    arch, params, q, eg, blk = case(name, seed)
    return jax_encode_image(params, JaxConfig(**arch), q, eg, bitdepth=bitdepth,
                            hls_sig_blksize=blk), params


def _assert_float_close(got, want, max_dyn=255.0):
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert diff.max() <= 1.0 / max_dyn + 1e-7
    assert (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("name", CASES)
def test_integer_decode_equals_jax_on_both_routes(name):
    data, params = _stream(name)
    want, want_info = jdec.decode_bitstream(data, integer_pipeline=True)
    got, info = tdec.decode_bitstream(data, integer_pipeline=True)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # The one-call C route reports its timings; a stream it rejects went the
    # python route in both packages.
    assert ("timings" in info) == ("timings" in want_info) == (name in C_ROUTE_CASES)
    assert vars(info["gop_header"]) == vars(want_info["gop_header"])

    want_py, want_info = jdec.decode_bitstream(data, integer_pipeline=True, full_info=True)
    got_py, info = tdec.decode_bitstream(data, integer_pipeline=True, full_info=True)
    np.testing.assert_array_equal(got_py, want_py)
    if name in C_ROUTE_CASES:
        np.testing.assert_array_equal(got_py.astype(np.float32), got)
    for g, w, lat in zip(info["latents"], want_info["latents"], params["latents"]):
        np.testing.assert_array_equal(g, w)
        if name != "frozen_grid0":
            np.testing.assert_array_equal(g, np.round(lat.astype(np.float64) * 16))
    for module in ("arm", "synthesis"):
        for g, w, p in zip(info["params"][module]["layers"], want_info["params"][module]["layers"],
                           params[module]["layers"]):
            np.testing.assert_array_equal(g["weight"], w["weight"])
            np.testing.assert_array_equal(g["bias"], w["bias"])
            np.testing.assert_allclose(g["weight"], p["weight"], rtol=0, atol=1e-12)
            np.testing.assert_allclose(g["bias"], p["bias"], rtol=0, atol=1e-12)
    for key in ("ups", "preconcat"):
        for g, w in zip(info["params"]["upsampling"][key], want_info["params"]["upsampling"][key]):
            np.testing.assert_array_equal(g, w)
    assert vars(info["frame_header"]) == vars(want_info["frame_header"])
    assert info["cfg"].latent_shapes == want_info["cfg"].latent_shapes


@pytest.mark.parametrize("name", CASES)
def test_float_decode_on_the_cpu_close_to_jax(name):
    data, _ = _stream(name)
    want, _ = jdec.decode_bitstream(data)
    got, info = tdec.decode_bitstream(data, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    assert "frame_header" in info
    _assert_float_close(got, want)


def test_float_decode_of_a_10_bit_stream():
    data, _ = _stream("arm8_3grids", seed=3, bitdepth=10)
    want, _ = jdec.decode_bitstream(data)
    got, _ = tdec.decode_bitstream(data, device="cpu")
    _assert_float_close(got, want, max_dyn=1023.0)
    got_i, _ = tdec.decode_bitstream(data, integer_pipeline=True)
    np.testing.assert_array_equal(got_i, jdec.decode_bitstream(data, integer_pipeline=True)[0])


def test_float_decode_defaults_to_cuda_and_integer_needs_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    data, _ = _stream("frozen_grid0")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdec.decode_bitstream(data)
    img, _ = tdec.decode_bitstream(data, integer_pipeline=True)
    assert np.isfinite(img).all()


def test_float_decode_restores_the_tf32_switch():
    data, _ = _stream("frozen_grid0")
    before = torch.backends.cudnn.allow_tf32
    tdec.decode_bitstream(data, device="cpu")
    assert torch.backends.cudnn.allow_tf32 == before


def test_parallel_decode_equals_serial():
    names = ["arm8_3grids", "two_ft_fallback", "arm16_4grids_29x37", "blk8"]
    datas = [_stream(n, seed=i)[0] for i, n in enumerate(names)]
    got = tdec.decode_bitstreams(datas, n_threads=3)
    want = jdec.decode_bitstreams(datas, n_threads=3)
    assert len(got) == 4
    for data, (img, info), (jimg, jinfo) in zip(datas, got, want):
        assert info["kind"] == jinfo["kind"] == "image"
        assert info["bitdepth"] == 8 and info["img_size"] == img.shape[1:]
        np.testing.assert_array_equal(img, tdec.decode_bitstream(data, integer_pipeline=True)[0])
        np.testing.assert_array_equal(img, jimg)
    assert tdec.decode_bitstreams([]) == []


def test_probe_and_one_call_decode_match_jax():
    data, _ = _stream("arm24_7grids")
    assert tent.probe_bitstream(data) == {
        "img_size": (32, 48), "c_out": 3, "bitdepth": 8, "frame_data_type": "rgb", "n_frames": 1}
    assert tent.probe_bitstream(b"\x00" * 4) is None
    img, info = tent.decode_image_cc(data)
    assert set(info["timings"]) == {"nn_sec", "arm_sec", "ups_syn_sec", "total_sec"}
    np.testing.assert_array_equal(img, jdec.decode_bitstream(data, integer_pipeline=True)[0])
    fallback, _ = _stream("two_ft_fallback")
    assert tent.decode_image_cc(fallback) is None


# ---- video streams: handcrafted I / P / B payloads ------------------------ #
H, W = 32, 48


def _video_stream(frame_specs, intra_period, fdt="yuv444", bitdepth=8):
    """frame_specs: (seed, out_channels, display_index) in coding order."""
    out = jax_write_gop_header(JaxGopHeader(img_size=(H, W), frame_data_type=fdt,
                                            bitdepth=bitdepth, intra_period=intra_period,
                                            p_period=intra_period))
    for seed, c, disp in frame_specs:
        arch, params, q, eg, blk = rounded_case(seed, (H, W), 3, (8, 1), SYN_SMALL, out_channels=c)
        out += jax_encode_frame(params, JaxConfig(**arch), q, eg, display_index=disp,
                                flow_gain=1)[0]
    return out


VIDEO_STREAMS = {
    "i_p": ([(0, 3, 0), (1, 6, 1)], 1, "yuv444", 8),
    "i_p_b": ([(0, 3, 0), (1, 6, 2), (2, 9, 1)], 2, "yuv444", 8),
    "i_p_b_420_10b": ([(3, 3, 0), (4, 6, 2), (5, 9, 1)], 2, "yuv420", 10),
}


@pytest.mark.parametrize("name", VIDEO_STREAMS)
def test_video_decode_equals_jax_on_both_routes(name):
    specs, ip, fdt, bitdepth = VIDEO_STREAMS[name]
    data = _video_stream(specs, ip, fdt, bitdepth)
    want, want_info = jdec.decode_video_bitstream(data)
    got, info = tdec.decode_video_bitstream(data)
    assert "timings" in info and "timings" in want_info  # the one-call C route
    want_py, _ = jdec.decode_video_bitstream(data, full_info=True)
    got_py, info_py = tdec.decode_video_bitstream(data, full_info=True)
    assert "last_frame_info" in info_py
    assert len(got) == len(want) == len(got_py) == len(specs)
    for g, w, gp, wp in zip(got, want, got_py, want_py):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(g, gp)
    # The threaded entry point hands such a stream to the video decoder.
    (frames, kind_info), = tdec.decode_bitstreams([data])
    assert kind_info["kind"] == "video"
    for g, w in zip(frames, got):
        np.testing.assert_array_equal(g, w)


def test_inter_prediction_equals_jax():
    rng = np.random.default_rng(5)
    ref0 = rng.integers(0, 4096, (3, 9, 11))
    ref1 = rng.integers(0, 4096, (3, 9, 11))
    raw = rng.integers(-6000, 6000, (9, 9, 11))
    np.testing.assert_array_equal(tinter.process_inter_int(raw[:6], ref0, None, 1),
                                  jinter.process_inter_int(raw[:6], ref0, None, 1))
    np.testing.assert_array_equal(tinter.process_inter_int(raw, ref0, ref1, 1),
                                  jinter.process_inter_int(raw, ref0, ref1, 1))
    np.testing.assert_array_equal(
        tinter.warp_int(ref0, raw, 3, 5, 0, True), jinter.warp_int(ref0, raw, 3, 5, 0, True))
    p0, p1 = ref0.astype(np.int64), ref1.astype(np.int64)
    np.testing.assert_array_equal(tinter.bpred_int(p0, p1, raw, 5), jinter.bpred_int(p0, p1, raw, 5))
    with pytest.raises(ValueError, match="without a reference"):
        tinter.process_inter_int(raw[:6], None, None, 1)
    with pytest.raises(ValueError, match="6 or 9"):
        tinter.process_inter_int(raw[:7], ref0, ref1, 1)


# ---- image files ----------------------------------------------------------- #
@pytest.mark.parametrize("fdt,bitdepth", [("yuv420", 8), ("yuv444", 10)])
def test_yuv_files_equal_jax(tmp_path, fdt, bitdepth):
    rng = np.random.default_rng(9)
    max_val = 2**bitdepth - 1
    frames = [np.round(rng.uniform(size=(3, 8, 12)) * max_val).astype(np.float32) / max_val
              for _ in range(2)]
    ours, theirs = tmp_path / "a_12x8_25fps.yuv", tmp_path / "b_12x8_25fps.yuv"
    for f in frames:
        f420_t, f420_j = timage.convert_444_to_420(f), jimage.convert_444_to_420(f)
        for k in "yuv":
            np.testing.assert_array_equal(f420_t[k], f420_j[k])
        np.testing.assert_array_equal(timage.convert_420_to_444(f420_t),
                                      jimage.convert_420_to_444(f420_j))
        timage.write_yuv(f420_t if fdt == "yuv420" else f, bitdepth, fdt, str(ours))
        jimage.write_yuv(f420_j if fdt == "yuv420" else f, bitdepth, fdt, str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    assert timage.parse_yuv_size(str(ours)) == jimage.parse_yuv_size(str(ours)) == (12, 8)
    got, want = timage.read_yuv(str(ours), 1, fdt, bitdepth), jimage.read_yuv(str(ours), 1, fdt,
                                                                             bitdepth)
    if fdt == "yuv420":
        for k in "yuv":
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got["y"][0], frames[1][0])
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, frames[1])


def test_png_files_equal_jax(tmp_path):
    img = np.random.default_rng(4).uniform(-0.1, 1.1, (3, 7, 9)).astype(np.float32)
    timage.write_png(img, str(tmp_path / "a.png"))
    jimage.write_png(img, str(tmp_path / "b.png"))
    got, want = timage.read_png(str(tmp_path / "a.png")), jimage.read_png(str(tmp_path / "b.png"))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], np.round(np.clip(img, 0, 1) * 255) / np.float32(255))


# ---- the decode CLI --------------------------------------------------------- #
def test_decode_cli_integer_ppm_and_float_png(tmp_path):
    data, _ = _stream("arm16_4grids_29x37")
    (tmp_path / "x.cool").write_bytes(data)
    assert decode_cli.main(["-i", str(tmp_path / "x.cool"), "-o", str(tmp_path / "x.ppm"),
                            "--int"]) == 0
    img, bitdepth = timage.read_ppm(str(tmp_path / "x.ppm"))
    assert bitdepth == 8
    np.testing.assert_array_equal(img, jdec.decode_bitstream(data, integer_pipeline=True)[0])
    assert jax_decode_cli.main(["-i", str(tmp_path / "x.cool"), "-o", str(tmp_path / "j.ppm"),
                                "--int"]) == 0
    assert (tmp_path / "x.ppm").read_bytes() == (tmp_path / "j.ppm").read_bytes()

    assert decode_cli.main(["-i", str(tmp_path / "x.cool"), "-o", str(tmp_path / "x.png"),
                            "--device", "cpu", "--verbosity", "1"]) == 0
    _assert_float_close(timage.read_png(str(tmp_path / "x.png"))[0],
                        jdec.decode_bitstream(data)[0])
    with pytest.raises(ValueError, match="Unsupported output format"):
        decode_cli.main(["-i", str(tmp_path / "x.cool"), "-o", str(tmp_path / "x.bmp"), "--int"])


def test_decode_cli_device_default(tmp_path):
    """Run as a user would (``python -m``): without a GPU the float route
    raises unless given ``--device cpu``; the integer route needs none."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    data, _ = _stream("frozen_grid0")
    (tmp_path / "x.cool").write_bytes(data)
    base = [sys.executable, "-m", "coolchic_tpu_torch.decode", "-i", str(tmp_path / "x.cool")]
    floating = subprocess.run(base + ["-o", str(tmp_path / "f.ppm")], cwd=REPO,
                              capture_output=True, text=True, timeout=300)
    assert floating.returncode != 0 and "device='cpu'" in floating.stderr
    assert not (tmp_path / "f.ppm").exists()
    integer = subprocess.run(base + ["-o", str(tmp_path / "i.ppm"), "--int"], cwd=REPO,
                             capture_output=True, text=True, timeout=300)
    assert integer.returncode == 0, integer.stderr
    np.testing.assert_array_equal(timage.read_ppm(str(tmp_path / "i.ppm"))[0],
                                  jdec.decode_bitstream(data, integer_pipeline=True)[0])


@pytest.mark.parametrize("ext", ["ppm", "png"])
def test_decode_cli_directory_mode(tmp_path, ext):
    src, out = tmp_path / "streams", tmp_path / "out"
    src.mkdir()
    streams = {"a": _stream("arm8_3grids")[0], "b": _stream("blk8", seed=1)[0],
               "c": _stream("two_ft_fallback")[0],  # decoded by the python route
               "v": _video_stream(*VIDEO_STREAMS["i_p"][:2])}
    for name, data in streams.items():
        (src / f"{name}.cool").write_bytes(data)
    assert decode_cli.main(["-i", str(src), "-o", str(out), "--threads", "2", "--ext", ext,
                            "--verbosity", "1"]) == 0
    read = timage.read_ppm if ext == "ppm" else timage.read_png
    for name in ("a", "b", "c"):  # in levels: the python route's image is float64
        np.testing.assert_array_equal(
            np.round(read(str(out / f"{name}.{ext}"))[0] * 255.0),
            np.round(jdec.decode_bitstream(streams[name], integer_pipeline=True)[0] * 255.0))
    frames, _ = jdec.decode_video_bitstream(streams["v"])
    want = np.concatenate([np.round(f * 255).astype(np.uint8).reshape(-1) for f in frames])
    np.testing.assert_array_equal(np.frombuffer((out / "v.yuv").read_bytes(), np.uint8), want)
    assert decode_cli.main(["-i", str(tmp_path / "out"), "-o", str(tmp_path / "none")]) == 1


@pytest.mark.parametrize("name", ["i_p_b", "i_p_b_420_10b"])
def test_decode_cli_writes_the_yuv_the_jax_cli_writes(tmp_path, name):
    specs, ip, fdt, bitdepth = VIDEO_STREAMS[name]
    (tmp_path / "v.cool").write_bytes(_video_stream(specs, ip, fdt, bitdepth))
    assert decode_cli.main(["-i", str(tmp_path / "v.cool"), "-o", str(tmp_path / "t.yuv"),
                            "--verbosity", "1"]) == 0
    assert jax_decode_cli.main(["-i", str(tmp_path / "v.cool"), "-o", str(tmp_path / "j.yuv")]) == 0
    got = (tmp_path / "t.yuv").read_bytes()
    assert got == (tmp_path / "j.yuv").read_bytes()
    n_samples = H * W * 3 // (2 if fdt == "yuv420" else 1) * len(specs)
    assert len(got) == n_samples * (2 if bitdepth > 8 else 1)


def test_standalone_decoder_binary(tmp_path):
    """``build_decoder_binary`` builds ``ccdec`` beside the port's library;
    it writes the samples of the integer pipeline (PPM for an image, YUV for
    a video stream)."""
    binary = Path(tent.build_decoder_binary())
    assert binary.name == "ccdec" and (REPO / "coolchic_tpu_torch" / "_build") in binary.parents
    data, _ = _stream("arm16_4grids_29x37")
    (tmp_path / "x.cool").write_bytes(data)
    run = subprocess.run([str(binary), "-i", str(tmp_path / "x.cool"), "-o", str(tmp_path / "x.ppm")],
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    np.testing.assert_array_equal(timage.read_ppm(str(tmp_path / "x.ppm"))[0],
                                  tdec.decode_bitstream(data, integer_pipeline=True)[0])
    specs, ip, fdt, bitdepth = VIDEO_STREAMS["i_p_b"]
    (tmp_path / "v.cool").write_bytes(_video_stream(specs, ip, fdt, bitdepth))
    run = subprocess.run([str(binary), "-i", str(tmp_path / "v.cool"), "-o", str(tmp_path / "v.yuv")],
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert decode_cli.main(["-i", str(tmp_path / "v.cool"), "-o", str(tmp_path / "t.yuv")]) == 0
    assert (tmp_path / "v.yuv").read_bytes() == (tmp_path / "t.yuv").read_bytes()


# ---- the whole path: encode, write, decode ------------------------------- #
def _png(path, h=24, w=32):
    from PIL import Image

    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x / w, y / h, 0.5 + 0.2 * np.sin(x / 3.0)], -1)
    img = np.clip(img + 0.03 * rng.standard_normal(img.shape), 0, 1)
    Image.fromarray((img * 255).astype(np.uint8)).save(path)


@pytest.fixture(scope="module")
def cli_encode(tmp_path_factory):
    """One run of the port's encode CLI on the CPU (debug preset, vlop
    decoder, a 24x32 PNG, significance blocks of 8): the paths it wrote."""
    from coolchic_tpu_torch.encode import main

    tmp = tmp_path_factory.mktemp("cli_encode")
    _png(tmp / "img.png")
    assert main(["--input", str(tmp / "img.png"), "--output", str(tmp / "img.cool"),
                 "--enc_preset", "debug", "--dec_cfg", str(REPO / "cfg" / "dec" / "vlop.yaml"),
                 "--workdir", str(tmp / "wd"), "--device", "cpu", "--hls_sig_blksize", "8"]) == 0
    return tmp


def test_encode_cli_writes_a_stream_both_packages_decode_alike(cli_encode):
    data = (cli_encode / "img.cool").read_bytes()
    want, _ = jdec.decode_bitstream(data, integer_pipeline=True)
    got, _ = tdec.decode_bitstream(data, integer_pipeline=True)
    np.testing.assert_array_equal(got, want)
    got_py, info = tdec.decode_bitstream(data, integer_pipeline=True, full_info=True)
    np.testing.assert_array_equal(got_py.astype(np.float32), want)
    assert info["frame_header"].hls_sig_blksize == 8
    _assert_float_close(tdec.decode_bitstream(data, device="cpu")[0],
                        jdec.decode_bitstream(data)[0])


def test_encode_cli_reports_the_stream_it_wrote(cli_encode):
    """``rate_bpp`` is the file's size and ``psnr_db`` the PSNR of the file
    decoded by the JAX package's integer pipeline."""
    data = (cli_encode / "img.cool").read_bytes()
    header, row = (cli_encode / "wd" / "results_best.tsv").read_text().splitlines()
    row = dict(zip(header.split("\t"), row.split("\t")))
    decoded, _ = jdec.decode_bitstream(data, integer_pipeline=True)
    target = timage.read_png(str(cli_encode / "img.png"))[0]
    psnr = -10.0 * np.log10(float(np.mean((decoded - target) ** 2)) + 1e-12)
    assert float(row["psnr_db"]) == pytest.approx(psnr, abs=1e-9)
    assert float(row["rate_bpp"]) == 8 * len(data) / (24 * 32)
    assert abs(float(row["psnr_db"]) - float(row["psnr_db_estimate"])) < 0.1


def test_encode_cli_stream_holds_the_saved_params(cli_encode):
    """The quantized networks and the rounded latents of
    ``params_quantized.npz`` are what the stream decodes to."""
    data = (cli_encode / "img.cool").read_bytes()
    _, info = tdec.decode_bitstream(data, integer_pipeline=True, full_info=True)
    saved = np.load(cli_encode / "wd" / "params_quantized.npz")
    for i, lat in enumerate(info["latents"]):
        np.testing.assert_array_equal(lat, np.round(saved[f"latents/{i}"].astype(np.float64) * 16))
    for module in ("arm", "synthesis"):
        for i, layer in enumerate(info["params"][module]["layers"]):
            for k in ("weight", "bias"):
                np.testing.assert_allclose(layer[k], saved[f"{module}/layers/{i}/{k}"],
                                           rtol=0, atol=1e-12)
    for key in ("ups", "preconcat"):
        for i, half in enumerate(info["params"]["upsampling"][key]):
            np.testing.assert_allclose(half, saved[f"upsampling/{key}/{i}"], rtol=0, atol=1e-12)


def test_sanity_check_passes_on_the_cpu(capsys):
    from coolchic_tpu_torch.utils.sanity_check import main

    assert main(["--device", "cpu"]) == 0
    assert "Sanity check PASSED" in capsys.readouterr().out
