"""A reader of flax's msgpack checkpoints in the standard library.

The JAX package writes its `.ckpt` files with `flax.serialization.to_bytes`
(`wespeaker_hubert_tpu/utils/checkpoint.py:save_checkpoint`): a msgpack
document of nested string-keyed maps whose leaves are flax's ext types.  The
port reads them with `struct` alone (the GPU machine has no msgpack
package):

  * msgpack nil, bool, ints, float32 / float64, str, bin, array and map;
  * ext 1, an ndarray: its payload is msgpack `(shape, dtype name, raw
    C-order bytes)`; ext 2, a Python complex `(real, imag)`; ext 3, a numpy
    scalar (an ndarray of shape ());
  * `bfloat16` leaves (`export_model(dtype="bf16")` writes them), which
    numpy has no dtype for: their 16-bit patterns read as integers and
    viewed as `torch.bfloat16` tensors;
  * the chunked form flax writes for a leaf over 2**30 bytes,
    `{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
    {"0": ...}}`, joined back into one array.

`loads` mirrors `flax.serialization.msgpack_restore`: maps become dicts,
arrays lists, ndarrays numpy arrays (or bf16 tensors).
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

__all__ = ["loads", "load"]

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

# fixed-width heads: byte -> (struct format, size)
_NUMBERS = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LENGTHS = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} (wants {n} more)")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def length(self, n: int) -> int:
        return self.unpack(_LENGTHS[n], n)

    def value(self) -> Any:
        b = self.unpack(">B", 1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.mapping(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _NUMBERS:
            return self.unpack(*_NUMBERS[b])
        if b in (0xC4, 0xC5, 0xC6):  # bin 8 / 16 / 32
            return bytes(self.take(self.length(1 << (b - 0xC4))))
        if b in (0xD9, 0xDA, 0xDB):  # str 8 / 16 / 32
            return str(self.take(self.length(1 << (b - 0xD9))), "utf-8")
        if b in (0xDC, 0xDD):  # array 16 / 32
            return [self.value() for _ in range(self.length(2 << (b - 0xDC)))]
        if b in (0xDE, 0xDF):  # map 16 / 32
            return self.mapping(self.length(2 << (b - 0xDE)))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8 / 16 / 32
            n = self.length(1 << (b - 0xC7))
            return self.ext(self.unpack(">b", 1), n)
        if 0xD4 <= b <= 0xD8:  # fixext 1 / 2 / 4 / 8 / 16
            return self.ext(self.unpack(">b", 1), 1 << (b - 0xD4))
        raise ValueError(f"msgpack: unknown head byte 0x{b:02x} at {self.pos - 1}")

    def mapping(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int) -> Any:
        payload = _Reader(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload.value())
        if code == _EXT_NPSCALAR:
            return _ndarray(payload.value())[()]
        if code == _EXT_COMPLEX:
            real, imag = payload.value()
            return complex(real, imag)
        raise ValueError(f"msgpack: unknown ext type {code}")


def _ndarray(triple: Tuple) -> Any:
    """flax's ndarray payload (shape, dtype name, C-order bytes) -> a numpy
    array, or a torch.bfloat16 tensor for bfloat16."""
    shape, name, buf = triple
    if isinstance(name, bytes):
        name = name.decode()
    shape = tuple(shape)
    if name == "bfloat16":
        bits = np.frombuffer(buf, "<i2").reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()


def _unchunk(tree: Any) -> Any:
    """Join flax's chunked leaves back into arrays, everywhere in `tree`."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return np.concatenate([np.reshape(c, -1) for c in chunks]).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def loads(data: bytes) -> Any:
    """The tree of a flax msgpack document (`flax.serialization.to_bytes`)."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes after the document")
    return _unchunk(tree)


def load(path: str) -> Any:
    with open(path, "rb") as f:
        return loads(f.read())
