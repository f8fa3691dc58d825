"""Hypernet checkpoints, per-image evaluation and delta-subset search, and the
one-shot encode to a ``.cool`` stream.

Counterpart of ``coolchic_tpu/hypernet/inference.py``. Checkpoints keep the
JAX package's format, a pickle of numpy trees with the hypernet in flax's
names and layouts (``hypernet/bridge.py``): a JAX checkpoint loads here
unchanged and a checkpoint written here loads in JAX.
"""

from __future__ import annotations

import csv
import itertools
import pickle
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from coolchic_tpu_torch.bitstream import encode_image_bitstream
from coolchic_tpu_torch.hypernet.bridge import flax_to_state_dict, state_dict_to_flax
from coolchic_tpu_torch.hypernet.wholenet import DeltaWholeNet, WholeNetState
from coolchic_tpu_torch.models.coolchic import coolchic_forward_latents
from coolchic_tpu_torch.params import from_numpy_pytree, to_numpy_pytree, tree_leaves, tree_map
from coolchic_tpu_torch.train.loss import loss_function
from coolchic_tpu_torch.train.quantize_model import (
    ModuleQuantInfo, _combine_nets, quantize_model_deltas, quantize_model_with_info,
)
from coolchic_tpu_torch.utils.trace import span
from coolchic_tpu_torch.utils.types import resolve_device

MODULE_NAMES = ("arm", "synthesis", "upsampling")


def save_checkpoint(state: WholeNetState, path: Path, samples_seen: int = 0) -> None:
    """``samples_{N}.pkl``: the JAX package's checkpoint format."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(
            {
                "hypernet": state_dict_to_flax(state.hypernet),
                "decoder": to_numpy_pytree(state.decoder),
                "samples_seen": samples_seen,
            },
            f,
        )


def load_checkpoint(path: Path, device: str | torch.device = "cuda") -> WholeNetState:
    """Load a checkpoint onto ``device``; ``path`` may be a directory, where
    the highest ``samples_N.pkl`` wins (the ``__latest`` rule)."""
    return load_checkpoint_meta(path, device)[0]


def load_checkpoint_meta(
    path: Path, device: str | torch.device = "cuda"
) -> Tuple[WholeNetState, int]:
    """(state, samples_seen) of a checkpoint; directories follow the
    ``__latest`` rule."""
    device = resolve_device(device)
    path = Path(path)
    if path.is_dir():
        candidates = sorted(path.glob("samples_*.pkl"), key=lambda p: int(p.stem.split("_")[1]))
        if not candidates:
            raise FileNotFoundError(f"No samples_*.pkl checkpoint in {path}")
        path = candidates[-1]
    with open(path, "rb") as f:
        raw = pickle.load(f)
    state = WholeNetState(hypernet=flax_to_state_dict(raw["hypernet"], device),
                          decoder=from_numpy_pytree(raw["decoder"], device))
    return state, int(raw.get("samples_seen", 0))


def _option(on: Dict[str, bool]) -> str:
    return f"arm={int(on['arm'])},syn={int(on['synthesis'])},ups={int(on['upsampling'])}"


@torch.no_grad()
def eval_image_delta_subsets(
    net: DeltaWholeNet, state: WholeNetState, img: torch.Tensor, lmbda: float
) -> Dict:
    """Try the 8 on/off combinations of the (arm, synthesis, upsampling)
    deltas of one [3, H, W] image and keep the best RD cost (the first, in
    the JAX package's order, on a tie)."""
    latents, deltas = net.predict(state, img[None])
    lat0 = [y[0] for y in latents]
    best = None
    for use in itertools.product([False, True], repeat=3):
        on = dict(zip(MODULE_NAMES, use))
        nets = {
            m: tree_map(lambda base, d, s=1.0 if on[m] else 0.0: base + s * d[0],
                        state.decoder[m], deltas[m])
            for m in MODULE_NAMES
        }
        decoded, rate, _ = coolchic_forward_latents(nets, lat0, net.cfg, training=False)
        out = loss_function(decoded, rate, img, lmbda)
        row = {
            "loss": float(out.loss),
            "psnr_db": float(out.psnr_db),
            "rate_latent_bpp": float(out.rate_latent_bpp),
            "option_selected": _option(on),
        }
        if best is None or row["loss"] < best["loss"]:
            best = row
    return best


@torch.no_grad()
def eval_image_delta_subsets_rated(
    net: DeltaWholeNet, state: WholeNetState, img: torch.Tensor, lmbda: float,
    all_options: Optional[List[Dict]] = None,
) -> Dict:
    """The delta-subset search with the deltas' transmission rate counted:
    each enabled module pays the exp-Golomb rate of its RD-quantized delta
    (``rate_nn_bpp``). The deltas are quantized once, every module enabled,
    and the options reuse that quantization. ``all_options``, when given, is
    filled with the row of every option."""
    lat0, qdeltas, infos = quantize_image_deltas(net, state, img, lmbda)
    n_pix = img.shape[-2] * img.shape[-1]
    best = None
    for use in itertools.product([False, True], repeat=3):
        on = dict(zip(MODULE_NAMES, use))
        nets = {
            m: tree_map(torch.add, state.decoder[m], qdeltas[m]) if on[m] else state.decoder[m]
            for m in MODULE_NAMES
        }
        decoded, rate, _ = coolchic_forward_latents(nets, lat0, net.cfg, training=False)
        out = loss_function(decoded, rate, img, lmbda)
        rate_nn_bpp = sum(float(infos[m].rate_bits) for m in MODULE_NAMES if on[m]) / n_pix
        row = {
            "loss": float(out.loss) + lmbda * rate_nn_bpp,
            "psnr_db": float(out.psnr_db),
            "rate_latent_bpp": float(out.rate_latent_bpp),
            "rate_nn_bpp": rate_nn_bpp,
            "option_selected": _option(on),
        }
        if all_options is not None:
            all_options.append(row)
        if best is None or row["loss"] < best["loss"]:
            best = row
    return best


@torch.no_grad()
def quantize_image_deltas(
    net: DeltaWholeNet, state: WholeNetState, img: torch.Tensor, lmbda: float
) -> Tuple[List[torch.Tensor], Dict, Dict[str, ModuleQuantInfo]]:
    """Predict the latents and deltas of one [3, H, W] image and RD-quantize
    the deltas: the transmissible form of a hypernet output.

    Returns (latents, list of [1, h, w]; quantized deltas; per-module
    ModuleQuantInfo of the delta symbols)."""
    latents, deltas = net.predict(state, img[None])
    lat0 = [y[0] for y in latents]
    qdeltas, infos = quantize_model_deltas(
        state.decoder, tree_map(lambda d: d[0], deltas), lat0, img, lmbda, net.cfg)
    return lat0, qdeltas, infos


@torch.no_grad()
def hypernet_to_bitstream(
    net: DeltaWholeNet,
    state: WholeNetState,
    img: torch.Tensor,
    lmbda: float,
    bitdepth: int = 8,
    timings: Optional[Dict[str, float]] = None,
) -> Tuple[bytes, Dict]:
    """One-forward encode: hypernet prediction -> quantized deltas ->
    decoder (base + quantized delta) -> standard decodable stream.

    The stream carries absolute weights, so after the delta search the
    decoder is quantized again through the standard module grid; the delta
    infos report the delta-domain rate (what a receiver holding the base
    would pay). Spans (``utils/trace.py``): ``oneshot.delta_search``,
    ``oneshot.quantize`` and ``oneshot.write``, one after another.
    ``timings``, when given, receives their seconds
    (``delta_search_s``, ``quantize_s``, ``write_s``), the first two then
    ending with a synchronise of the device (only then).

    Returns (bitstream bytes, {"delta_infos", "nn_infos"})."""
    sync = timings is not None and img.device.type == "cuda"
    if sync:
        torch.cuda.synchronize(img.device)
    with span("oneshot.delta_search") as search:
        lat0, qdeltas, delta_infos = quantize_image_deltas(net, state, img, lmbda)
        params = _combine_nets(state.decoder, qdeltas)
        # The predicted latents are in the stored (pre-gain) convention already.
        params["latents"] = [y.detach() for y in lat0]
        if sync:
            torch.cuda.synchronize(img.device)
    with span("oneshot.quantize") as quantize:
        qparams, infos, _ = quantize_model_with_info(params, img, lmbda, net.cfg)
        if sync:
            torch.cuda.synchronize(img.device)
    with span("oneshot.write") as write:
        nn_q_step = {m: {"weight": i.q_step_w, "bias": i.q_step_b} for m, i in infos.items()}
        nn_expgol = {m: {"weight": i.expgol_w, "bias": i.expgol_b} for m, i in infos.items()}
        bs = encode_image_bitstream(qparams, net.cfg, nn_q_step, nn_expgol, bitdepth=bitdepth)
    if timings is not None:
        timings.update(delta_search_s=1e-9 * search.ns, quantize_s=1e-9 * quantize.ns,
                       write_s=1e-9 * write.ns)
    return bs, {"delta_infos": delta_infos, "nn_infos": infos}


@torch.no_grad()
def eval_dataset(
    net,
    state: WholeNetState,
    images: Iterable,  # (name, [3, H, W] array or tensor) pairs
    lmbda: float,
    csv_path: Optional[Path] = None,
    delta_subset_search: bool = False,
) -> List[Dict]:
    """Per-image sweep -> rows, and optionally a CSV with the reference's
    ablation schema. Each image goes to the device of ``state``."""
    device = tree_leaves(state.decoder)[0].device
    rows = []
    for name, img in images:
        img = torch.as_tensor(np.asarray(img) if not isinstance(img, torch.Tensor) else img,
                              dtype=torch.float32, device=device)
        if delta_subset_search and isinstance(net, DeltaWholeNet):
            row = eval_image_delta_subsets(net, state, img, lmbda)
        else:
            decoded, rate = net.forward(state, img[None], training=False)
            out = loss_function(decoded[0], rate[0], img, lmbda)
            row = {
                "loss": float(out.loss),
                "psnr_db": float(out.psnr_db),
                "rate_latent_bpp": float(out.rate_latent_bpp),
                "option_selected": "none",
            }
        mse = 10 ** (-row["psnr_db"] / 10)
        rows.append(
            {
                "seq_name": name,
                "rate_bpp": row["rate_latent_bpp"],
                "rate_latent_bpp": row["rate_latent_bpp"],
                "rate_nn_bpp": 0.0,
                "psnr_db": row["psnr_db"],
                "mse": mse,
                "option_selected": row["option_selected"],
            }
        )
    if csv_path is not None:
        with open(csv_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            writer.writeheader()
            writer.writerows(rows)
    return rows
