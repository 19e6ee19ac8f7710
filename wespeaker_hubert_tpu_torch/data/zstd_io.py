"""zstd stream IO through ctypes over the system libzstd: a copy of
`wespeaker_hubert_tpu/data/zstd_io.py`.

Python's tarfile cannot read `.tar.zst`, and no zstd package is needed:
`ZstdStreamReader` is a file-like streaming decompressor (it feeds
`tarfile.open(fileobj=..., mode="r|")`, data/dataset.py:iter_tar_shards),
`compress_file` a file-to-file streaming compressor (bin/tools.py
make_shard_list with compress='zstd').  Everything reports "unavailable"
(`zstd_available()`) on a host without libzstd.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import io
from typing import BinaryIO, Optional

__all__ = [
    "zstd_available",
    "ZstdStreamReader",
    "compress_bytes",
    "compress_file",
    "ZSTD_MAGIC",
    "open_maybe_zstd",
]

ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"

_LIB = None  # None = not probed, False = unavailable


class _ZBuf(ctypes.Structure):
    """ZSTD_inBuffer / ZSTD_outBuffer share this exact layout."""

    _fields_ = [
        ("ptr", ctypes.c_void_p),
        ("size", ctypes.c_size_t),
        ("pos", ctypes.c_size_t),
    ]


def _zstd():
    global _LIB
    if _LIB is False:
        return None
    if _LIB is None:
        lib = None
        for name in ("libzstd.so.1", ctypes.util.find_library("zstd"),
                     "libzstd.so"):
            if not name:
                continue
            try:
                lib = ctypes.CDLL(name)
                break
            except OSError:
                continue
        if lib is None:
            _LIB = False
            return None
        p = ctypes.POINTER(_ZBuf)
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_createDStream.restype = ctypes.c_void_p
        lib.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
        lib.ZSTD_decompressStream.restype = ctypes.c_size_t
        lib.ZSTD_decompressStream.argtypes = [ctypes.c_void_p, p, p]
        lib.ZSTD_DStreamInSize.restype = ctypes.c_size_t
        lib.ZSTD_createCCtx.restype = ctypes.c_void_p
        lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
        lib.ZSTD_CCtx_setParameter.restype = ctypes.c_size_t
        lib.ZSTD_CCtx_setParameter.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.ZSTD_compressStream2.restype = ctypes.c_size_t
        lib.ZSTD_compressStream2.argtypes = [
            ctypes.c_void_p, p, p, ctypes.c_int]
        lib.ZSTD_CStreamInSize.restype = ctypes.c_size_t
        lib.ZSTD_CStreamOutSize.restype = ctypes.c_size_t
        _LIB = lib
    return _LIB


def zstd_available() -> bool:
    return _zstd() is not None


class ZstdStreamReader(io.RawIOBase):
    """File-like streaming zstd decompressor over a binary file object.

    Supports multi-frame archives (a new frame continues at the next
    input refill), which is what concatenated/zstd-cli outputs produce.
    """

    def __init__(self, raw: BinaryIO):
        lib = _zstd()
        if lib is None:
            raise OSError("libzstd not available")
        self._lib = lib
        self._raw = raw
        self._ds = lib.ZSTD_createDStream()
        if not self._ds:
            raise OSError("ZSTD_createDStream failed")
        self._inbuf = ctypes.create_string_buffer(
            int(lib.ZSTD_DStreamInSize()))
        self._zin = _ZBuf(ctypes.cast(self._inbuf, ctypes.c_void_p), 0, 0)
        self._eof = False

    def readable(self) -> bool:  # pragma: no cover - io protocol
        return True

    def readinto(self, b) -> int:
        if self._eof or len(b) == 0:
            return 0
        view = (ctypes.c_char * len(b)).from_buffer(b)
        out = _ZBuf(ctypes.cast(view, ctypes.c_void_p), len(b), 0)
        lib = self._lib
        while out.pos < out.size:
            if self._zin.pos == self._zin.size:
                chunk = self._raw.read(len(self._inbuf))
                if not chunk:
                    self._eof = True
                    break
                ctypes.memmove(self._inbuf, chunk, len(chunk))
                self._zin.size = len(chunk)
                self._zin.pos = 0
            ret = lib.ZSTD_decompressStream(
                self._ds, ctypes.byref(out), ctypes.byref(self._zin))
            if lib.ZSTD_isError(ret):
                raise OSError("zstd decompression error")
        return out.pos

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            parts = []
            while True:
                chunk = self.read(1 << 20)
                if not chunk:
                    return b"".join(parts)
                parts.append(chunk)
        buf = bytearray(n)
        got = self.readinto(buf)
        return bytes(buf[:got])

    def close(self) -> None:
        if getattr(self, "_ds", None):
            self._lib.ZSTD_freeDStream(self._ds)
            self._ds = None
            self._raw.close()  # reader owns the underlying file
        super().close()


_ZSTD_c_compressionLevel = 100  # ZSTD_cParameter enum
_ZSTD_e_continue, _ZSTD_e_end = 0, 2


def compress_file(src_path: str, dst_path: str, level: int = 3) -> None:
    """Stream-compress a file to zstd (constant memory, any size)."""
    lib = _zstd()
    if lib is None:
        raise OSError("libzstd not available")
    cctx = lib.ZSTD_createCCtx()
    if not cctx:
        raise OSError("ZSTD_createCCtx failed")
    try:
        lib.ZSTD_CCtx_setParameter(cctx, _ZSTD_c_compressionLevel, level)
        in_cap = int(lib.ZSTD_CStreamInSize())
        out_cap = int(lib.ZSTD_CStreamOutSize())
        outbuf = ctypes.create_string_buffer(out_cap)
        with open(src_path, "rb") as fin, open(dst_path, "wb") as fout:
            while True:
                chunk = fin.read(in_cap)
                last = len(chunk) < in_cap
                cbuf = ctypes.create_string_buffer(chunk, len(chunk))
                zin = _ZBuf(ctypes.cast(cbuf, ctypes.c_void_p),
                            len(chunk), 0)
                mode = _ZSTD_e_end if last else _ZSTD_e_continue
                while True:
                    out = _ZBuf(ctypes.cast(outbuf, ctypes.c_void_p),
                                out_cap, 0)
                    remaining = lib.ZSTD_compressStream2(
                        cctx, ctypes.byref(out), ctypes.byref(zin), mode)
                    if lib.ZSTD_isError(remaining):
                        raise OSError("zstd compression error")
                    if out.pos:
                        fout.write(outbuf.raw[: out.pos])
                    done = (remaining == 0) if last else (zin.pos == zin.size)
                    if done:
                        break
                if last:
                    return
    finally:
        lib.ZSTD_freeCCtx(cctx)


def compress_bytes(data: bytes, level: int = 3) -> bytes:
    """One-shot compress (test fixtures / small payloads)."""
    lib = _zstd()
    if lib is None:
        raise OSError("libzstd not available")
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_compress.restype = ctypes.c_size_t
    lib.ZSTD_compress.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
    bound = int(lib.ZSTD_compressBound(len(data)))
    dst = ctypes.create_string_buffer(bound)
    n = lib.ZSTD_compress(dst, bound, data, len(data), level)
    if lib.ZSTD_isError(n):
        raise OSError("zstd compression error")
    return dst.raw[:n]


def open_maybe_zstd(path: str) -> Optional[BinaryIO]:
    """Return a decompressing reader when `path` is a zstd stream,
    else None (caller uses its normal open path)."""
    f = open(path, "rb")
    magic = f.read(4)
    f.seek(0)
    if magic[:4] == ZSTD_MAGIC and zstd_available():
        return io.BufferedReader(ZstdStreamReader(f))  # type: ignore[arg-type]
    f.close()
    return None
