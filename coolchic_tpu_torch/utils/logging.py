"""Optional experiment logging (wandb when installed, nothing otherwise).

Counterpart of ``coolchic_tpu/utils/logging.py``. wandb is optional: if the
package is missing or logging is disabled, every call does nothing.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

_run = None
_disabled = False


def init(project: str = "coolchic-tpu-runs", config: Optional[Dict] = None,
         disable: bool = False, **kwargs) -> None:
    """Start a run. ``disable=True`` (or wandb not installed) makes every
    later ``log`` call do nothing."""
    global _run, _disabled
    _disabled = disable
    if disable:
        os.environ["WANDB_MODE"] = "disabled"
        return
    try:
        import wandb
    except ImportError:
        _disabled = True
        return
    try:
        _run = wandb.init(project=project, config=config or {}, **kwargs)
    except Exception:  # a logging back end that fails must not stop training
        _disabled = True


def log(metrics: Dict[str, Any], step: Optional[int] = None) -> None:
    if _disabled or _run is None:
        return
    try:
        _run.log(metrics, step=step)
    except Exception:  # as in init
        pass


def finish() -> None:
    global _run
    if _run is not None:
        try:
            _run.finish()
        except Exception:  # as in init
            pass
        _run = None


def mem_info(prefix: str = "Memory allocated") -> str:
    """The process's resident memory and, per CUDA device,
    ``torch.cuda.memory_allocated``."""
    lines = []
    try:
        import psutil

        rss = psutil.Process().memory_info().rss / 2**30
        lines.append(f"{prefix}: cpu {rss:.3f} GiB")
    except ImportError:
        pass
    import torch

    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            used = torch.cuda.memory_allocated(i) / 2**30
            lines.append(f"{prefix}: cuda:{i} {used:.3f} GiB")
    return "\n".join(lines)
