"""Build the port's CUDA sources into shared libraries and load them.

Each library is compiled by `nvcc` from `wespeaker_hubert_tpu_torch/csrc/`
at first use into `build/kernels/` beside the package (listed in
.gitignore), keyed by a hash of its sources and flags, and loaded with
ctypes.  The sources expose a plain C interface, so nothing includes
PyTorch's headers and a build takes seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "load_library", "build_library"]

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_NAME_LOCKS: Dict[str, threading.Lock] = {}  # one per library: builds run in parallel
_LOADED: Dict[str, ctypes.CDLL] = {}
# seconds spent in nvcc per library name, and its -Xptxas -v report
BUILD_LOG: Dict[str, Tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "wespeaker_hubert_tpu_torch are built from source on first use"
    )


def _digest(sources: Sequence[Path]) -> str:
    """Of the flags, the sources and every header under csrc/ (the sources
    include them)."""
    h = hashlib.sha256()
    for flag in NVCC_FLAGS:
        h.update(flag.encode())
    for src in [*sources, *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_library(name: str, sources: List[str]) -> Path:
    """Compile `sources` (file names under csrc/) into one shared library
    unless a build of the same sources and flags exists; returns its path."""
    srcs = [CSRC_DIR / s for s in sources]
    out = BUILD_DIR / f"lib{name}-{_digest(srcs)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name} ({proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    BUILD_LOG[name] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    return out


def load_library(name: str, sources: List[str]) -> ctypes.CDLL:
    """Build (if needed) and load a kernel library once per process.  Two
    libraries build at once when two threads ask for them."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name not in _LOADED:
            _LOADED[name] = ctypes.CDLL(str(build_library(name, sources)))
        return _LOADED[name]
