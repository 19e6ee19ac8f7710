"""Kaldi binary archives: PLDA models, vector and matrix arks.

Counterpart of `wespeaker_hubert_tpu/backend/kaldi_io.py`; the writers'
output is byte for byte the JAX package's.  A Kaldi binary record is the
b"\\0B" marker, space-terminated tokens and basic types prefixed by a byte
giving their width: vectors are "FV" / "DV" + int32 dim + data, matrices
"FM" / "DM" + int32 rows + int32 cols + data.  A PLDA model file is
<Plda> mean transform psi </Plda>.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Tuple

import numpy as np

__all__ = ["read_kaldi_plda", "load_kaldi_plda",
           "write_kaldi_vectors", "read_kaldi_vectors",
           "write_kaldi_matrices", "read_kaldi_matrices",
           "read_kaldi_matrix"]


def _read_token(f: BinaryIO) -> str:
    chars = []
    while True:
        c = f.read(1)
        if not c or c == b" ":
            break
        chars.append(c)
    return b"".join(chars).decode()


def _expect_token(f: BinaryIO, want: str):
    got = _read_token(f)
    if got != want:
        raise ValueError(f"expected kaldi token {want!r}, got {got!r}")


def _read_int32(f: BinaryIO) -> int:
    size = f.read(1)
    if size != b"\x04":
        raise ValueError(f"expected int32 size marker, got {size!r}")
    return struct.unpack("<i", f.read(4))[0]


def _read_vector(f: BinaryIO) -> np.ndarray:
    token = _read_token(f)
    if token == "FV":
        dtype, width = "<f4", 4
    elif token == "DV":
        dtype, width = "<f8", 8
    else:
        raise ValueError(f"expected FV/DV, got {token!r}")
    dim = _read_int32(f)
    return np.frombuffer(f.read(dim * width), dtype=dtype).astype(np.float64)


def _read_matrix(f: BinaryIO, out_dtype=np.float64) -> np.ndarray:
    """One FM / DM matrix; out_dtype=None keeps the on-disk dtype (the feat
    reader's path), the PLDA reader converts to float64."""
    token = _read_token(f)
    if token == "FM":
        dtype, width = "<f4", 4
    elif token == "DM":
        dtype, width = "<f8", 8
    else:
        raise ValueError(f"expected FM/DM, got {token!r}")
    rows = _read_int32(f)
    cols = _read_int32(f)
    data = np.frombuffer(f.read(rows * cols * width), dtype=dtype)
    data = data.reshape(rows, cols)
    return data if out_dtype is None else data.astype(out_dtype)


def read_kaldi_plda(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (mean, transform, psi)."""
    with open(path, "rb") as f:
        marker = f.read(2)
        if marker != b"\x00B":
            raise ValueError("not a kaldi binary file (missing \\0B)")
        _expect_token(f, "<Plda>")
        mean = _read_vector(f)
        transform = _read_matrix(f)
        psi = _read_vector(f)
        # trailing </Plda> optional to tolerate writer variants
    return mean, transform, psi


def load_kaldi_plda(path: str, normalize_length: bool = True, device="cuda"):
    """Kaldi plda file -> backend.plda.TwoCovPLDA on `device`."""
    import torch

    from .plda import TwoCovPLDA

    arrays = read_kaldi_plda(path)
    plda = TwoCovPLDA(dim=len(arrays[0]), normalize_length=normalize_length, device=device)
    plda.mu, plda.transform, plda.psi = (torch.as_tensor(a).to(plda.device) for a in arrays)
    plda.offset = -plda.transform @ plda.mu
    return plda


def write_kaldi_vectors(ark_path: str, names, vectors, scp_path: str = None):
    """Write embeddings as a Kaldi binary vector archive (+ optional scp).

    Each ark entry is 'key \\0B FV <int32 dim> <f32 data>', each scp line
    'key ark:offset', the layout kaldiio writes.
    """
    scp_lines = []
    with open(ark_path, "wb") as f:
        for name, vec in zip(names, vectors):
            vec = np.asarray(vec, "<f4").reshape(-1)
            f.write(name.encode() + b" ")
            offset = f.tell()
            f.write(b"\x00B")
            f.write(b"FV ")
            f.write(b"\x04" + struct.pack("<i", vec.shape[0]))
            f.write(vec.tobytes())
            scp_lines.append(f"{name} {ark_path}:{offset}")
    if scp_path:
        with open(scp_path, "w", encoding="utf-8") as f:
            f.write("\n".join(scp_lines) + "\n")
    return ark_path


def write_kaldi_matrices(ark_path: str, names, matrices, scp_path: str = None):
    """Write (T, F) float matrices as a Kaldi binary matrix archive
    (+ optional scp with 'key ark:offset' lines), the format Kaldi's
    feature extraction writes and the `feat` data type reads."""
    scp_lines = []
    with open(ark_path, "wb") as f:
        for name, mat in zip(names, matrices):
            mat = np.ascontiguousarray(np.asarray(mat, "<f4"))
            if mat.ndim != 2:
                raise ValueError(f"matrix for {name!r} must be 2-D")
            f.write(name.encode() + b" ")
            offset = f.tell()
            f.write(b"\x00B")
            f.write(b"FM ")
            f.write(b"\x04" + struct.pack("<i", mat.shape[0]))
            f.write(b"\x04" + struct.pack("<i", mat.shape[1]))
            f.write(mat.tobytes())
            scp_lines.append(f"{name} {ark_path}:{offset}")
    if scp_path:
        with open(scp_path, "w", encoding="utf-8") as f:
            f.write("\n".join(scp_lines) + "\n")
    return ark_path


def read_kaldi_matrix(rxspecifier: str) -> np.ndarray:
    """Read ONE matrix from 'path/to/file.ark:offset' (the scp entry
    format, kaldiio.load_mat's rxspecifier) or from a file positioned at
    a bare '\\0B FM' record, in its on-disk dtype."""
    path, sep, offset = rxspecifier.rpartition(":")
    if sep and offset.isdigit():
        pos = int(offset)
    else:
        path, pos = rxspecifier, 0
    with open(path, "rb") as f:
        f.seek(pos)
        marker = f.read(2)
        if marker != b"\x00B":
            raise ValueError(
                f"not kaldi binary at {rxspecifier!r} (missing \\0B)"
            )
        return _read_matrix(f, out_dtype=None)


def read_kaldi_matrices(path: str):
    """Read a binary matrix ark written by write_kaldi_matrices (or
    kaldi) -> list[(key, np.ndarray)]."""
    out = []
    with open(path, "rb") as f:
        while True:
            key_chars = []
            c = f.read(1)
            if not c:
                break
            while c not in (b" ", b""):
                key_chars.append(c)
                c = f.read(1)
            key = b"".join(key_chars).decode()
            marker = f.read(2)
            if marker != b"\x00B":
                raise ValueError(f"not kaldi binary at {key!r}")
            out.append((key, _read_matrix(f, out_dtype=None)))
    return out


def read_kaldi_vectors(path: str):
    """Read a binary vector ark written by write_kaldi_vectors (or kaldi)
    -> list[(key, np.ndarray)]."""
    out = []
    with open(path, "rb") as f:
        while True:
            key_chars = []
            c = f.read(1)
            if not c:
                break
            while c not in (b" ", b""):
                key_chars.append(c)
                c = f.read(1)
            key = b"".join(key_chars).decode()
            marker = f.read(2)
            if marker != b"\x00B":
                raise ValueError(f"not kaldi binary at {key!r}")
            vec = _read_vector(f)
            out.append((key, vec))
    return out
