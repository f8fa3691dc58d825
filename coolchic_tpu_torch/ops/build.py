"""Build the CUDA sources of ``csrc/`` into shared libraries at first use.

Each library is compiled by ``nvcc`` for ``sm_90a`` into a plain C ABI
``.so`` and loaded with ``ctypes``. Builds are keyed by a hash of the
sources and flags under ``coolchic_tpu_torch/_build/`` (listed in
``.gitignore``), so a checkout builds once and reuses the library after.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# name -> (library, compiler log); one entry per process.
_LOADED: Dict[str, Tuple[ctypes.CDLL, str]] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
            "coolchic_tpu_torch are built from csrc/ at first use"
        )
    return nvcc


def load_library(name: str) -> Tuple[ctypes.CDLL, str]:
    """Build (if needed) and load ``csrc/<name>.cu``.

    Returns (library, nvcc's log of the build). Raises RuntimeError with
    nvcc's output when the build fails.
    """
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_DIR / digest
    lib_path = out_dir / f"lib{name}.so"
    log_path = out_dir / f"{name}.log"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    log = log_path.read_text() if log_path.exists() else ""
    _LOADED[name] = (ctypes.CDLL(str(lib_path)), log)
    return _LOADED[name]
