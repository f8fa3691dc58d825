"""Hypernet weights between flax's parameter trees and the port's modules.

The JAX package keeps a hypernet's weights as a flax parameter tree: nested
dicts named after the modules (``LatentHyperNet_0/ResidualBlock_2/Conv_0/
kernel``), NHWC layouts. Its checkpoints pickle that tree as numpy arrays.
The port's modules carry the same names (``hypernet/blocks.py``), so the
tree and a state dict differ only in the leaf's name and layout:

=====================  ================  ======================
flax leaf              state-dict leaf   layout
=====================  ================  ======================
Conv ``kernel``        ``weight``        HWIO -> OIHW (a depthwise (7, 7, 1, C) -> (C, 1, 7, 7))
Dense ``kernel``       ``weight``        (in, out) -> (out, in)
LayerNorm / GroupNorm  ``weight``        ``scale`` renamed
``bias``               ``bias``          unchanged
``layer_scale``        ``layer_scale``   unchanged
=====================  ================  ======================

Nothing here knows an architecture: the conversion walks the names.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_NORMS = ("LayerNorm", "GroupNorm")


def _to_torch_layout(name: str, a: np.ndarray) -> np.ndarray:
    if name == "kernel" and a.ndim == 4:
        return np.transpose(a, (3, 2, 0, 1))
    if name == "kernel" and a.ndim == 2:
        return a.T
    return a


def _to_flax_layout(name: str, a: np.ndarray) -> np.ndarray:
    if name == "kernel" and a.ndim == 4:
        return np.transpose(a, (2, 3, 1, 0))
    if name == "kernel" and a.ndim == 2:
        return a.T
    return a


def _flat(tree: Dict[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_state_dict(tree: Dict[str, Any], device="cpu") -> Dict[str, torch.Tensor]:
    """A flax parameter tree (numpy or array-like leaves) -> a state dict of
    the port's module with the same names, on ``device``. Bit-exact."""
    out = {}
    for path, leaf in _flat(tree):
        name = path[-1]
        torch_name = "weight" if name in ("kernel", "scale") else name
        a = np.ascontiguousarray(_to_torch_layout(name, np.asarray(leaf)))
        out[".".join(path[:-1] + (torch_name,))] = torch.tensor(a, device=device)
    return out


def state_dict_to_flax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of ``flax_to_state_dict``: nested dicts of numpy arrays in
    flax's names and layouts (what a JAX checkpoint holds)."""
    tree: Dict[str, Any] = {}
    for key, t in state_dict.items():
        path = key.split(".")
        name = path[-1]
        if name == "weight":
            name = "scale" if path[-2].startswith(_NORMS) else "kernel"
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        node[name] = np.ascontiguousarray(_to_flax_layout(name, a))
    return tree
