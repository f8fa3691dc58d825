"""Parameter trees between numpy and torch, in the JAX package's layout.

A frame's parameters are nested dicts and lists of arrays (see the package
docstring). These two functions move such a tree across the framework
boundary without changing its structure or its bits: tests feed the JAX
package's weights to the port this way, and the bitstream writer takes the
port's weights back as numpy. A batch of B decoders is the same tree with a
leading [B] axis on every leaf (what ``jax.vmap`` of the JAX package's init
gives), and crosses the boundary unchanged; ``stack_params`` and
``unstack_params`` go between it and B single trees.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np
import torch


def from_numpy_pytree(tree: Any, device: torch.device | str) -> Any:
    """Copy every array leaf of ``tree`` into a tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: from_numpy_pytree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy_pytree(v, device) for v in tree)
    return torch.tensor(np.asarray(tree), device=device)


def to_numpy_pytree(tree: Any) -> Any:
    """Copy every tensor leaf of ``tree`` into a numpy array (a leaf that is
    not a tensor is passed through ``np.asarray``)."""
    if isinstance(tree, dict):
        return {k: to_numpy_pytree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_pytree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def tree_leaves(tree: Any) -> list:
    """Tensor leaves in a fixed order (dict insertion order, then list order)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every leaf of ``tree``, keeping its structure; with
    ``rest``, trees of the same structure whose matching leaves are passed
    as further arguments (``tree_map(torch.add, base, delta)``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_clone(tree: Any) -> Any:
    """Detached copies of every leaf (a snapshot that no later update touches)."""
    return tree_map(lambda t: t.detach().clone(), tree)


def stack_params(trees: Sequence[Any]) -> Any:
    """B trees of one structure -> one tree whose leaves have a leading [B]
    axis: the parameters of a batch of decoders."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_params([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_params([t[i] for t in trees]) for i in range(len(first)))
    return torch.stack(list(trees))


def unstack_params(tree: Any) -> List[Any]:
    """The inverse of ``stack_params``: one tree per row of the leading axis
    (views of the stacked leaves)."""
    n = tree_leaves(tree)[0].shape[0]
    return [tree_map(lambda t: t[b], tree) for b in range(n)]


def flatten_with_paths(tree: Any, prefix: str = "") -> dict:
    """{"arm/layers/0/weight": leaf, ...}: the layout used for ``.npz`` files."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten_with_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out
