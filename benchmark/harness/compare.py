"""The gaps that decide ``correct``, each against the plain reference.

Norm gaps are taken leaf by leaf, as the gap between the program's norm and
the reference's (not the norm of their difference), over the reference's
norm of that leaf or of the median leaf, whichever is larger: some leaves'
gradients are all but zero.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import List, Optional, Sequence

import torch

# A leaf whose reference gradient is under this share of the median leaf's is
# nought to rounding: Adam moves it by round-off alone, so its change is not compared.
NOUGHT_GRAD_SHARE = 1e-3


def rel_gap(values: Sequence[float], refs: Sequence[float]) -> float:
    """Largest |value - ref| / |ref|."""
    return max(abs(v - r) / max(abs(r), 1e-30) for v, r in zip(values, refs))


def leaf_norm_gap(got: Sequence[torch.Tensor], ref: Sequence[torch.Tensor],
                  keep: Optional[List[bool]] = None, median: bool = False) -> float:
    """Worst leaf's |norm(got) - norm(ref)| / max(norm(ref), median leaf's
    norm(ref)); with ``median``, the median leaf's gap instead of the worst."""
    g = torch.stack([t.double().norm() for t in got])
    r = torch.stack([t.double().norm() for t in ref])
    floor = torch.clamp(r, min=float(r.median()))
    gaps = (g - r).abs() / torch.clamp(floor, min=1e-30)
    if keep is not None:
        gaps = gaps[torch.tensor(keep, device=gaps.device)]
    return float(gaps.median() if median else gaps.max())


def moving_leaves(ref_grads: Sequence[torch.Tensor]) -> List[bool]:
    """Leaves whose reference gradient is not nought to rounding."""
    n = torch.stack([t.double().norm() for t in ref_grads])
    return [bool(v >= NOUGHT_GRAD_SHARE * float(n.median())) for v in n]


@contextmanager
def tf32(enabled: bool):
    """Matrix products and convolutions in TF32 (the control) or in float32."""
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
