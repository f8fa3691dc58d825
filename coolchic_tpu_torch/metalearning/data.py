"""Training-data streams for the amortized encoder.

Counterpart of ``coolchic_tpu/metalearning/data.py``, the same numpy code
with the same ``RandomState`` draws in the same order, so that a seed gives
the same arrays bit for bit: content-seeded random patch crops, deterministic
per image, over any local directory of images; a train / test split with at
most 64 test images; and a synthetic stream that needs no data set at all.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from coolchic_tpu_torch.io.image import load_frame_data_from_file

N_MAX_TEST = 64


def train_test_split(paths: Sequence[Path]) -> Tuple[List[Path], List[Path]]:
    """Deterministic split: at most 64 (10 %) test images, the first of the
    sorted paths."""
    paths = sorted(paths)
    n_test = min(N_MAX_TEST, len(paths) // 10)
    return list(paths[n_test:]), list(paths[:n_test])


def _content_seed(path: Path) -> int:
    """Stable per-image seed derived from the file name."""
    return int(hashlib.sha1(str(path.name).encode()).hexdigest()[:8], 16)


def random_patch(
    img: np.ndarray, patch_size: Tuple[int, int], rng: np.random.RandomState
) -> np.ndarray:
    """[3, H, W] -> [3, ph, pw] random crop (reflect-pad if too small)."""
    c, h, w = img.shape
    ph, pw = patch_size
    if h < ph or w < pw:
        img = np.pad(
            img,
            ((0, 0), (0, max(0, ph - h)), (0, max(0, pw - w))),
            mode="reflect",
        )
        c, h, w = img.shape
    y = rng.randint(0, h - ph + 1)
    x = rng.randint(0, w - pw + 1)
    return img[:, y : y + ph, x : x + pw]


class PatchDataset:
    """Random patch crops from a directory of images."""

    def __init__(
        self,
        image_paths: Sequence[Path],
        patch_size: Tuple[int, int] = (256, 256),
        seed: int = 0,
    ):
        self.paths = list(image_paths)
        self.patch_size = patch_size
        self.seed = seed

    @classmethod
    def from_dir(cls, root: Path, patch_size=(256, 256), seed: int = 0):
        exts = (".png", ".ppm", ".jpg", ".jpeg")
        paths = [p for p in sorted(Path(root).rglob("*")) if p.suffix.lower() in exts]
        return cls(paths, patch_size, seed)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> np.ndarray:
        path = self.paths[idx % len(self.paths)]
        fd = load_frame_data_from_file(str(path))
        rng = np.random.RandomState((_content_seed(path) + idx) % 2**31)
        return random_patch(np.asarray(fd.data, np.float32), self.patch_size, rng)

    def batches(self, batch_size: int, seed: Optional[int] = None) -> Iterator[np.ndarray]:
        """Infinite stream of [B, 3, ph, pw] batches."""
        rng = np.random.RandomState(self.seed if seed is None else seed)
        while True:
            idx = rng.randint(0, len(self.paths), batch_size)
            yield np.stack([self[i] for i in idx], 0)


def synthetic_batches(
    batch_size: int, patch_size: Tuple[int, int] = (256, 256), seed: int = 0
) -> Iterator[np.ndarray]:
    """Infinite stream of smooth synthetic [B, 3, ph, pw] batches (used when
    no dataset is available: tests, benchmarks, dry runs)."""
    rng = np.random.RandomState(seed)
    ph, pw = patch_size
    yy, xx = np.meshgrid(
        np.linspace(0, 1, ph, dtype=np.float32),
        np.linspace(0, 1, pw, dtype=np.float32),
        indexing="ij",
    )
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
