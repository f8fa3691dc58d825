"""GOP and frame headers — byte-layout identical to the reference
(reference: coolchic/enc/bitstream/header.py:10-467). Counterpart of
``coolchic_tpu/bitstream/header.py`` (pure python, the port's own copy)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

FRAME_DATA_TYPES = ["rgb", "yuv420", "yuv444"]
BITDEPTHS = [8, 9, 10, 11, 12, 13, 14, 15, 16]
SYNTHESIS_MODES = ["linear", "residual"]
SYNTHESIS_NON_LINEARITIES = ["none", "relu"]

MAX_AC_MAX_VAL = 65535


def _u(v: int, n: int) -> bytes:
    return int(v).to_bytes(n, "big", signed=False)


def _s(v: int, n: int) -> bytes:
    return int(v).to_bytes(n, "big", signed=True)


# --------------------------------------------------------------------------- #
# GOP header (reference: header.py:114-219)
# --------------------------------------------------------------------------- #
@dataclass
class GopHeader:
    img_size: Tuple[int, int]
    frame_data_type: str = "rgb"
    bitdepth: int = 8
    intra_period: int = 0
    p_period: int = 0
    n_bytes_header: int = 9


def write_gop_header(h: GopHeader) -> bytes:
    out = b""
    out += _u(9, 2)
    out += _u(h.img_size[0], 2)
    out += _u(h.img_size[1], 2)
    out += _u(
        BITDEPTHS.index(h.bitdepth) * 2**4 + FRAME_DATA_TYPES.index(h.frame_data_type),
        1,
    )
    out += _u(h.intra_period, 1)
    out += _u(h.p_period, 1)
    return out


def read_gop_header(data: bytes) -> GopHeader:
    n_bytes = int.from_bytes(data[0:2], "big")
    img_h = int.from_bytes(data[2:4], "big")
    img_w = int.from_bytes(data[4:6], "big")
    raw = data[6]
    return GopHeader(
        img_size=(img_h, img_w),
        frame_data_type=FRAME_DATA_TYPES[raw % 2**4],
        bitdepth=BITDEPTHS[raw // 2**4],
        intra_period=data[7],
        p_period=data[8],
        n_bytes_header=n_bytes,
    )


# --------------------------------------------------------------------------- #
# Frame header (reference: header.py:255-467)
# --------------------------------------------------------------------------- #
@dataclass
class FrameHeader:
    display_index: int
    dim_arm: int
    n_hidden_layers_arm: int
    latent_n_grids: int
    ups_k_size: int
    ups_preconcat_k_size: int
    layers_synthesis: List[str]  # specs with numeric out_ft
    flow_gain: int
    ac_max_val_nn: int
    ac_max_val_latent: int
    hls_sig_blksize: int
    q_step_index_nn: Dict[str, Dict[str, int]]
    scale_index_nn: Dict[str, Dict[str, int]]
    n_bytes_nn: Dict[str, Dict[str, int]]
    n_ft_per_latent: List[int]
    n_bytes_per_latent: List[int]
    n_bytes_header: int = 0


_NN_ORDER = ["arm", "upsampling", "synthesis"]


def write_frame_header(h: FrameHeader) -> bytes:
    n_bytes_header = (
        2 + 1 + 1 + 1 + 1 + 1 + 1
        + 3 * len(h.layers_synthesis)
        + 1  # flow gain
        + 2 + 2 + 1  # ac_max_val nn / latent, hls_sig_blksize
        + 6 + 6 + 12  # q-step idx, scale idx, n_bytes (2 each)
        + 1 + 1
        + len(h.n_ft_per_latent)
        + 3 * len(h.n_bytes_per_latent)
    )
    out = b""
    out += _u(n_bytes_header, 2)
    out += _u(h.display_index, 1)
    assert h.dim_arm // 8 < 2**4 and h.n_hidden_layers_arm < 2**4
    out += _u((h.dim_arm // 8) * 2**4 + h.n_hidden_layers_arm, 1)
    out += _u(((h.latent_n_grids - 1) << 4) | h.ups_k_size, 1)
    out += _u(((h.latent_n_grids - 1) << 4) | h.ups_preconcat_k_size, 1)
    out += _u(1, 1)  # legacy n_synth_branch
    out += _u(len(h.layers_synthesis), 1)
    for spec in h.layers_synthesis:
        out_ft, k_size, mode, non_linearity = spec.split("-")
        out += _u(int(out_ft), 1)
        out += _u(int(k_size), 1)
        out += _u(
            SYNTHESIS_MODES.index(mode) * 16
            + SYNTHESIS_NON_LINEARITIES.index(non_linearity),
            1,
        )
    out += _u(h.flow_gain, 1)
    assert h.ac_max_val_nn <= MAX_AC_MAX_VAL
    assert h.ac_max_val_latent <= MAX_AC_MAX_VAL
    out += _u(h.ac_max_val_nn, 2)
    out += _u(h.ac_max_val_latent, 2)
    out += _s(h.hls_sig_blksize, 1)
    for nn in _NN_ORDER:
        for p in ("weight", "bias"):
            out += _u(h.q_step_index_nn[nn][p], 1)
    for nn in _NN_ORDER:
        for p in ("weight", "bias"):
            out += _u(h.scale_index_nn[nn][p], 1)
    for nn in _NN_ORDER:
        for p in ("weight", "bias"):
            assert h.n_bytes_nn[nn][p] <= MAX_AC_MAX_VAL
            out += _u(h.n_bytes_nn[nn][p], 2)
    out += _u(h.latent_n_grids, 1)
    out += _u(len(h.n_bytes_per_latent), 1)
    for n_ft in h.n_ft_per_latent:
        out += _u(n_ft, 1)
    for v in h.n_bytes_per_latent:
        assert v < 2**24
        out += _u(v, 3)
    assert len(out) == n_bytes_header
    return out


def read_frame_header(data: bytes) -> FrameHeader:
    p = 0

    def u(n):
        nonlocal p
        v = int.from_bytes(data[p : p + n], "big")
        p += n
        return v

    n_bytes_header = u(2)
    display_index = u(1)
    raw = u(1)
    dim_arm, n_hidden = (raw >> 4) * 8, raw & 0xF
    raw = u(1)
    latent_n_grids, ups_k_size = (raw >> 4) + 1, raw & 0xF
    raw = u(1)
    ups_preconcat_k_size = raw & 0xF
    u(1)  # legacy n_synth_branch
    n_layers = u(1)
    layers = []
    for _ in range(n_layers):
        out_ft = u(1)
        k_size = u(1)
        raw = u(1)
        layers.append(
            f"{out_ft}-{k_size}-{SYNTHESIS_MODES[raw // 16]}-"
            f"{SYNTHESIS_NON_LINEARITIES[raw % 16]}"
        )
    flow_gain = u(1)
    ac_max_val_nn = u(2)
    ac_max_val_latent = u(2)
    hls_sig_blksize = int.from_bytes(data[p : p + 1], "big", signed=True)
    p += 1

    q_step_index_nn = {nn: {} for nn in _NN_ORDER}
    scale_index_nn = {nn: {} for nn in _NN_ORDER}
    n_bytes_nn = {nn: {} for nn in _NN_ORDER}
    for nn in _NN_ORDER:
        for prm in ("weight", "bias"):
            q_step_index_nn[nn][prm] = u(1)
    for nn in _NN_ORDER:
        for prm in ("weight", "bias"):
            scale_index_nn[nn][prm] = u(1)
    for nn in _NN_ORDER:
        for prm in ("weight", "bias"):
            n_bytes_nn[nn][prm] = u(2)

    n_res = u(1)
    n_2d = u(1)
    n_ft = [u(1) for _ in range(n_res)]
    n_bytes_latent = [u(3) for _ in range(n_2d)]
    if p != n_bytes_header:
        raise ValueError(f"frame header size mismatch {p} != {n_bytes_header}")

    return FrameHeader(
        display_index=display_index,
        dim_arm=dim_arm,
        n_hidden_layers_arm=n_hidden,
        latent_n_grids=n_res,
        ups_k_size=ups_k_size,
        ups_preconcat_k_size=ups_preconcat_k_size,
        layers_synthesis=layers,
        flow_gain=flow_gain,
        ac_max_val_nn=ac_max_val_nn,
        ac_max_val_latent=ac_max_val_latent,
        hls_sig_blksize=hls_sig_blksize,
        q_step_index_nn=q_step_index_nn,
        scale_index_nn=scale_index_nn,
        n_bytes_nn=n_bytes_nn,
        n_ft_per_latent=n_ft,
        n_bytes_per_latent=n_bytes_latent,
        n_bytes_header=n_bytes_header,
    )
