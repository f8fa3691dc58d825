"""Reading what the window's entry does inside, without changing it.

The check drives the window's own entry (``run_phase_batch``,
``train_wholenet``) through its first steps. What the entry returns is its
state after them; the loss of each step and the optimizer's state after the
first are read by a spy: a wrapper put, for that one call, in place of the
function that the entry looks up by name in its module, which calls the real
function with the same arguments and returns what it returns.
"""

from __future__ import annotations

from contextlib import contextmanager
from types import ModuleType
from typing import Callable


@contextmanager
def spy(module: ModuleType, name: str, wrap: Callable[[Callable], Callable]):
    """``module.name`` replaced by ``wrap(module.name)`` inside the block."""
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        yield
    finally:
        setattr(module, name, real)
