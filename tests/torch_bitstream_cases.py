"""Quantized decoders made with numpy from a seed, for the bitstream tests of
the PyTorch port (``test_torch_bitstream.py``, ``test_torch_decode.py``).

Nothing is trained: random parameters are rounded to fixed q-steps, which is
all a writer or a decoder needs (the way ``tests/test_inter_decode.py``
builds its streams). Each case gives the same numpy arrays to the JAX
package and, through ``params.from_numpy_pytree``, to the port.
"""

from typing import Dict, Optional, Tuple

import numpy as np

SYN_SMALL = ("16-1-linear-relu", "X-1-linear-none", "X-3-residual-relu")
SYN_NARROW = ("8-1-linear-relu", "X-1-linear-none", "X-3-residual-none")
SYN_DEFAULT = ("40-1-linear-relu", "X-1-linear-none", "X-3-residual-relu", "X-3-residual-none")

Q = {
    "arm": {"weight": 2.0**-8, "bias": 2.0**-16},
    "upsampling": {"weight": 2.0**-12, "bias": 1.0},
    "synthesis": {"weight": 2.0**-10, "bias": 2.0**-16},
}

# name -> keyword arguments of ``rounded_case``.
CASES: Dict[str, dict] = {
    "arm8_3grids": dict(img_size=(32, 48), n_grids=3, arm=(8, 1), layers=SYN_SMALL),
    "arm16_4grids_29x37": dict(img_size=(29, 37), n_grids=4, arm=(16, 2), layers=SYN_NARROW,
                               expgol=None),
    "arm24_7grids": dict(img_size=(32, 48), n_grids=7, arm=(24, 2), layers=SYN_DEFAULT),
    "arm32_3grids": dict(img_size=(29, 37), n_grids=3, arm=(32, 1), layers=SYN_NARROW),
    "frozen_grid0": dict(img_size=(32, 48), n_grids=3, arm=(8, 1), layers=SYN_SMALL,
                         frozen_zero_grids=(0,)),
    "all_zero_grid": dict(img_size=(32, 48), n_grids=4, arm=(16, 2), layers=SYN_NARROW,
                          zero_grid=1),
    "blk8": dict(img_size=(29, 37), n_grids=3, arm=(8, 1), layers=SYN_SMALL, hls_sig_blksize=8,
                 expgol=None),
    # Two features on grid 0: the one-call C decoder rejects it, so the
    # decoders fall back to their python-orchestrated route.
    "two_ft_fallback": dict(img_size=(32, 48), n_grids=3, arm=(8, 1), layers=SYN_SMALL,
                            n_ft_per_res=(2, 1, 1)),
}


def _round_to(x: np.ndarray, q: float) -> np.ndarray:
    return np.round(np.asarray(x, np.float64) / q) * q


def rounded_case(
    seed: int,
    img_size: Tuple[int, int],
    n_grids: int,
    arm: Tuple[int, int],
    layers: Tuple[str, ...],
    out_channels: int = 3,
    n_ft_per_res: Optional[Tuple[int, ...]] = None,
    frozen_zero_grids: Tuple[int, ...] = (),
    zero_grid: Optional[int] = None,
    hls_sig_blksize: int = 16,
    expgol: Optional[int] = 0,
    latent_scale: float = 0.4,
):
    """(arch, params, nn_q_step, nn_expgol, hls_sig_blksize).

    ``arch`` holds the keyword arguments of either package's
    ``CoolChicConfig``; ``params`` is the JAX layout in numpy (f32 latents,
    float64 networks that are multiples of the q-steps of ``Q``).
    ``expgol=None`` leaves the exp-Golomb order to the coder's search.
    """
    rng = np.random.default_rng(seed)
    dim_arm, n_hidden = arm
    arch = dict(
        img_size=img_size,
        n_ft_per_res=n_ft_per_res or (1,) * n_grids,
        dim_arm=dim_arm,
        n_hidden_layers_arm=n_hidden,
        layers_synthesis=layers,
        out_channels=out_channels,
        frozen_zero_grids=frozen_zero_grids,
    )
    h, w = img_size
    latents = []
    for i, c in enumerate(arch["n_ft_per_res"]):
        shape = (c, -(-h // 2**i), -(-w // 2**i))
        lat = (latent_scale * rng.standard_normal(shape)).astype(np.float32)
        if i == zero_grid:
            lat[:] = 0.0
        latents.append(lat)

    arm_layers = []
    for out_d in [dim_arm] * n_hidden + [2]:
        arm_layers.append({
            "weight": _round_to(0.15 * rng.standard_normal((out_d, dim_arm)), Q["arm"]["weight"]),
            "bias": _round_to(0.2 * rng.standard_normal(out_d), Q["arm"]["bias"]),
        })

    ups_half = np.array([0.0351562, 0.1054687, -0.2617187, -0.8789063])
    pre_half = np.array([0.0, 0.0, 0.0, 1.0])
    qu = Q["upsampling"]["weight"]
    upsampling = {
        "ups": [_round_to(ups_half + 0.02 * rng.standard_normal(4), qu)
                for _ in range(n_grids - 1)],
        "preconcat": [_round_to(pre_half + 0.02 * rng.standard_normal(4), qu)
                      for _ in range(n_grids - 1)],
    }

    syn_layers = []
    in_ft = sum(arch["n_ft_per_res"])
    for spec in layers:
        out_ft, k, _mode, _act = spec.split("-")
        out_ft, k = (out_channels if out_ft == "X" else int(out_ft)), int(k)
        scale = 0.6 / np.sqrt(in_ft * k * k)
        syn_layers.append({
            "weight": _round_to(scale * rng.standard_normal((out_ft, in_ft, k, k)),
                                Q["synthesis"]["weight"]),
            "bias": _round_to(0.1 * rng.standard_normal(out_ft) + (0.4 if out_ft <= 9 else 0.0),
                              Q["synthesis"]["bias"]),
        })
        in_ft = out_ft

    params = {
        "latents": latents,
        "arm": {"layers": arm_layers},
        "upsampling": upsampling,
        "synthesis": {"layers": syn_layers},
    }
    nn_q_step = {m: dict(q) for m, q in Q.items()}
    nn_expgol = {m: {"weight": expgol, "bias": expgol} for m in Q}
    return arch, params, nn_q_step, nn_expgol, hls_sig_blksize


def case(name: str, seed: int = 0):
    return rounded_case(seed, **CASES[name])
