"""Build the native sources into shared libraries at first use.

The CUDA sources of ``csrc/`` are compiled by ``nvcc`` for ``sm_90a``, the
host C++ entropy / decoder backend of the repo's ``cpp/`` by ``g++``; each
becomes a plain C ABI ``.so`` loaded with ``ctypes``. Builds are keyed by a
hash of the sources and flags under ``coolchic_tpu_torch/_build/`` (listed
in ``.gitignore``), so a checkout builds once and reuses the library after.
Nothing is ever written beside the sources.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

CPP_DIR = Path(__file__).resolve().parent.parent.parent / "cpp"
CPP_HEADERS = ("cabac.hpp", "gen_contexts.inc")
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread")

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


def host_cpu_identity() -> str:
    """What ``-march=native`` resolves to on this host: the architecture and
    the CPU's model and feature flags. It is part of a g++ build's digest, so
    a library built on one machine is never loaded on another whose copy of
    the tree carries the first one's ``_build/``."""
    ident = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags", "Features")):
                    ident.append(line.strip())
                if line.startswith(("flags", "Features")):
                    break
    except OSError:
        ident.append(platform.processor())
    return "\n".join(ident)


def build_cpp(name: str, sources: Sequence[str], shared: bool = True) -> Path:
    """Compile ``sources`` of ``cpp/`` with g++ into ``_build/<digest>/<name>``
    (a shared library, or an executable when ``shared`` is false) and return
    its path. The digest covers the sources, the headers, the flags and the
    host CPU. Concurrent builds each write a temporary file and rename it
    into place. Raises RuntimeError on a missing source, a missing g++ or a
    failed build."""
    flags = GXX_FLAGS + (("-shared",) if shared else ())
    h = hashlib.sha256((name + " ".join(flags) + host_cpu_identity()).encode())
    for f in tuple(sources) + CPP_HEADERS:
        path = CPP_DIR / f
        if not path.exists():
            raise RuntimeError(f"{path} is missing: the C++ backend builds from the repo's cpp/")
        h.update(f.encode())
        h.update(path.read_bytes())
    out_dir = BUILD_DIR / h.hexdigest()[:16]
    out = out_dir / name
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(
            "g++ not found on PATH: the entropy coder and integer decoder of "
            "coolchic_tpu_torch are built from cpp/ at first use"
        )
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{name}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [gxx, *flags, *(str(CPP_DIR / s) for s in sources), "-o", str(tmp)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {list(sources)}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out

