"""Training patches for the amortized encoder, made on the host in numpy.

A copy of ``coolchic_tpu_torch/metalearning/data.py::synthetic_batches``
(the trainer CLI's ``--synthetic`` data): smooth sine and cosine patterns plus
noise, [B, 3, ph, pw] in [0, 1], from a numpy seed (reduced to 32 bits here,
since ``RandomState`` takes no more).
"""

from __future__ import annotations

import time
from typing import Iterator, Tuple

import numpy as np


def synthetic_batches(batch_size: int, patch_size: Tuple[int, int], seed: int) -> Iterator[np.ndarray]:
    rng = np.random.RandomState(seed % 2 ** 32)
    ph, pw = patch_size
    yy, xx = np.meshgrid(np.linspace(0, 1, ph, dtype=np.float32),
                         np.linspace(0, 1, pw, dtype=np.float32), indexing="ij")
    while True:
        batch = []
        for _ in range(batch_size):
            f1, f2 = rng.uniform(1, 8, 2)
            p1, p2 = rng.uniform(0, 6.28, 2)
            a = 0.5 + 0.4 * np.sin(f1 * xx * 6.28 + p1) * np.cos(f2 * yy * 6.28 + p2)
            b = 0.5 + 0.3 * np.cos(f2 * xx * 6.28 + p2)
            c = np.clip(0.5 * (a + b) + 0.05 * rng.randn(ph, pw), 0, 1)
            batch.append(np.stack([a, b, c], 0).astype(np.float32))
        yield np.stack(batch, 0)


class TimedIterator:
    """Wraps an iterator and sums the host seconds spent in its ``next()``."""

    def __init__(self, it: Iterator):
        self.it = it
        self.seconds = 0.0
        self.calls = 0

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        try:
            return next(self.it)
        finally:
            self.seconds += time.perf_counter() - t0
            self.calls += 1
