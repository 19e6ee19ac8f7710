"""ctypes wrapper for the C++ host data-loader (data/native/loader.cc).

Counterpart of `wespeaker_hubert_tpu/data/native_loader.py`.  The source
is compiled at first use with `g++ -O3 -shared -fPIC -std=c++17 -pthread
... -lz` (plus `-DWESP_HAVE_ZSTD -lzstd`, streaming zstd tar shards, where
the compiler finds libzstd) into `build/native/` beside the package,
keyed by a hash of the source, through a temporary file renamed into
place, so processes building at once never load a half-written library.
`$CXX` names another compiler.  A failed build raises with the compiler's
output: the training loop does not fall back to the Python pipeline, whose
batches come in another order.

`DeterministicNativeLoader` (Loader2, raw lists) and
`DeterministicNativeShardLoader` (Loader3, tar shards) yield (wav, label,
speed_idx) batches that are a pure function of (seed, epoch, rank, world)
(Loader3's also of its thread count: shards stripe over the threads).
Both take the configured `sample_rate` and raise a `WavRateError` once a
wav at another rate has been refused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, List, Tuple

import numpy as np

from .wav_io import WavRateError

__all__ = [
    "BUILD_DIR",
    "DeterministicNativeLoader",
    "DeterministicNativeShardLoader",
    "build_native_library",
    "native_zstd_available",
]

SOURCE = Path(__file__).resolve().parent / "native" / "loader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
ZSTD_FLAGS = ("-DWESP_HAVE_ZSTD", "-lzstd")

_LOCK = threading.Lock()
_LIB = None

_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)


def build_native_library() -> Path:
    """Compile loader.cc unless a build of the same source exists; returns
    the library's path.  Tries with libzstd, then without it; raises with
    the compiler's output when both fail."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libloader-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}")
    cxx = os.environ.get("CXX", "g++")
    errors = []
    for extra in (ZSTD_FLAGS, ()):
        cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp), "-lz", *extra]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:  # no compiler
            errors.append(f"{' '.join(cmd)}\n{e}")
            break
        if proc.returncode == 0:
            os.replace(tmp, out)
            return out
        errors.append(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    tmp.unlink(missing_ok=True)
    raise RuntimeError("building the C++ host loader failed (num_workers > 0 trains on it):\n"
                       + "\n".join(errors))


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build_native_library()))
        sig = {
            "loader2_create": (ctypes.c_void_p, [
                ctypes.POINTER(ctypes.c_char_p), _i32p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]),
            "loader3_create": (ctypes.c_void_p, [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                _i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int]),
            "loader_zstd_supported": (ctypes.c_int, []),
        }
        for v in ("2", "3"):
            sig[f"loader{v}_start_epoch"] = (None, [ctypes.c_void_p, ctypes.c_int])
            sig[f"loader{v}_next"] = (ctypes.c_int, [ctypes.c_void_p, _f32p, _i32p, _i32p])
            sig[f"loader{v}_destroy"] = (None, [ctypes.c_void_p])
            sig[f"loader{v}_failures"] = (ctypes.c_long, [ctypes.c_void_p])
            sig[f"loader{v}_rate_refusals"] = (ctypes.c_long, [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, _i32p])
        for name, (restype, argtypes) in sig.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _LIB = lib
        return lib


def native_zstd_available() -> bool:
    """True when the built library streams zstd tar shards."""
    return bool(_lib().loader_zstd_supported())


class _BatchLoader:
    """Epoch iteration over a Loader2 / Loader3 handle (`_v` "2" / "3"):
    full batches only, then the epoch ends."""

    _v = ""

    def _fn(self, name):
        return getattr(self._lib, f"loader{self._v}_{name}")

    def epoch(self, epoch: int) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        self._fn("start_epoch")(self._h, epoch)
        while True:
            wav = np.empty((self.batch_size, self.chunk_samples), np.float32)
            label = np.empty((self.batch_size,), np.int32)
            speed = np.zeros((self.batch_size,), np.int32)
            n = self._fn("next")(self._h, wav.ctypes.data_as(_f32p),
                                 label.ctypes.data_as(_i32p), speed.ctypes.data_as(_i32p))
            self._raise_on_rate()
            if n < self.batch_size:
                break  # the last partial batch is dropped (training semantics)
            yield wav, label, speed

    def _raise_on_rate(self) -> None:
        name, rate = ctypes.create_string_buffer(4096), ctypes.c_int32(0)
        if self._fn("rate_refusals")(self._h, name, len(name), ctypes.byref(rate)):
            raise WavRateError(self._name_of(name.value.decode()), rate.value, self.sample_rate)

    def _name_of(self, name: str) -> str:
        return name

    def decode_failures(self) -> int:
        """Items skipped as unreadable: wavs the C parser cannot decode,
        or compressed / unreadable shards."""
        return int(self._fn("failures")(self._h))

    def close(self) -> None:
        if self._h:
            self._fn("destroy")(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class DeterministicNativeLoader(_BatchLoader):
    """(wav, label, speed_idx) batches from wav paths (Loader2): workers
    claim epoch positions and a reorder window of 4 x batch_size emits
    them in order, so a batch is a pure function of (seed, epoch, rank,
    world) for any thread count.  num_spks > 0 draws the speed index and expands the labels x3.
    `keys` (one per path) name a refused wav in the error."""

    _v = "2"

    def __init__(self, paths: List[str], labels: List[int], chunk_samples: int,
                 batch_size: int, num_spks: int = 0, min_samples: int = 16000,
                 max_samples: int = 0, seed: int = 42, num_threads: int = 8, rank: int = 0,
                 world_size: int = 1, sample_rate: int = 16000, keys: List[str] = ()):
        self._lib, self._h = _lib(), None
        self.batch_size, self.chunk_samples = batch_size, chunk_samples
        self.sample_rate = sample_rate
        self._keys = dict(zip(paths, keys))
        self._paths_keepalive = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(paths))(*self._paths_keepalive)
        lab = np.ascontiguousarray(labels, np.int32)
        self._h = self._lib.loader2_create(
            arr, lab.ctypes.data_as(_i32p), len(paths), num_spks, chunk_samples, batch_size,
            min_samples, max_samples, seed, num_threads, rank, world_size, sample_rate)

    def _name_of(self, name: str) -> str:
        return self._keys.get(name, name)


class DeterministicNativeShardLoader(_BatchLoader):
    """(wav, label, speed_idx) batches from tar shards of KEY.wav +
    KEY.spk members (Loader3): the shards stripe over the threads, each
    streams its stripe through the filter, chunk and speed policy and a
    bounded-buffer shuffle, and full batches emit round-robin over the
    threads, a pure function of (seed, epoch, rank, world, num_threads).
    Plain and gzip tars, and zstd where the library has libzstd."""

    _v = "3"

    def __init__(self, shards: List[str], spk2id: dict, chunk_samples: int, batch_size: int,
                 num_spks: int = 0, min_samples: int = 16000, max_samples: int = 0,
                 shuffle_size: int = 2500, seed: int = 42, num_threads: int = 8, rank: int = 0,
                 world_size: int = 1, sample_rate: int = 16000):
        self._lib, self._h = _lib(), None
        self.batch_size, self.chunk_samples = batch_size, chunk_samples
        self.sample_rate = sample_rate
        self._shards_keepalive = [s.encode() for s in shards]
        arr = (ctypes.c_char_p * len(shards))(*self._shards_keepalive)
        names = sorted(spk2id)
        self._names_keepalive = [n.encode() for n in names]
        narr = (ctypes.c_char_p * len(names))(*self._names_keepalive)
        ids = np.ascontiguousarray([spk2id[n] for n in names], np.int32)
        self._h = self._lib.loader3_create(
            arr, len(shards), narr, ids.ctypes.data_as(_i32p), len(names), num_spks,
            chunk_samples, batch_size, min_samples, max_samples, shuffle_size, seed, num_threads,
            rank, world_size, sample_rate)
