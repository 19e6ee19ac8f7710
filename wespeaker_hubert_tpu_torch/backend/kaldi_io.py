"""Kaldi binary matrix reading, for the `feat` data type.

A copy of `read_kaldi_matrix` and its helpers from
`wespeaker_hubert_tpu/backend/kaldi_io.py`: a Kaldi binary record is the
b"\\0B" marker, then "FM" / "DM", an int32 row count and column count (each
after a width byte), then the data.
"""

from __future__ import annotations

import struct
from typing import BinaryIO

import numpy as np

__all__ = ["read_kaldi_matrix"]


def _read_token(f: BinaryIO) -> str:
    chars = []
    while True:
        c = f.read(1)
        if not c or c == b" ":
            break
        chars.append(c)
    return b"".join(chars).decode()


def _read_int32(f: BinaryIO) -> int:
    size = f.read(1)
    if size != b"\x04":
        raise ValueError(f"expected int32 size marker, got {size!r}")
    return struct.unpack("<i", f.read(4))[0]


def _read_matrix(f: BinaryIO) -> np.ndarray:
    """One FM / DM matrix in its on-disk dtype."""
    token = _read_token(f)
    if token == "FM":
        dtype, width = "<f4", 4
    elif token == "DM":
        dtype, width = "<f8", 8
    else:
        raise ValueError(f"expected FM/DM, got {token!r}")
    rows = _read_int32(f)
    cols = _read_int32(f)
    return np.frombuffer(f.read(rows * cols * width), dtype=dtype).reshape(rows, cols)


def read_kaldi_matrix(rxspecifier: str) -> np.ndarray:
    """Read one matrix from 'path/to/file.ark:offset' (the scp entry
    format) or from a file that starts with a bare '\\0B FM' record."""
    path, sep, offset = rxspecifier.rpartition(":")
    if sep and offset.isdigit():
        pos = int(offset)
    else:
        path, pos = rxspecifier, 0
    with open(path, "rb") as f:
        f.seek(pos)
        if f.read(2) != b"\x00B":
            raise ValueError(f"not kaldi binary at {rxspecifier!r} (missing \\0B)")
        return _read_matrix(f)
