"""Host-side WAV reading/writing (PCM8/16/32 and float32) without external
deps: a copy of `wespeaker_hubert_tpu/data/wav_io.py`.

Uses the stdlib `wave` module for standard PCM files plus a small RIFF
reader for float32 wavs; returns float32 arrays scaled to [-1, 1].  The
port adds `WavRateError`, which its pipelines raise for a wav whose rate is
not the configured one.
"""

from __future__ import annotations

import io
import struct
import wave
from typing import Tuple

import numpy as np

__all__ = ["WavRateError", "read_wav", "read_wav_bytes", "write_wav"]


class WavRateError(ValueError):
    """A wav whose header rate is not the configured sample rate (the
    pipelines frame every wav at `dataset_args.resample_rate` and resample
    nothing)."""

    def __init__(self, name: str, rate: int, expected: int):
        super().__init__(f"{name}: the wav's rate is {rate} Hz, but resample_rate is "
                         f"{expected}; resample it to {expected} Hz first")


def read_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode a WAV byte string -> (mono float32 [-1,1], sample_rate)."""
    try:
        with wave.open(io.BytesIO(data), "rb") as w:
            sr = w.getframerate()
            nchan = w.getnchannels()
            width = w.getsampwidth()
            raw = w.readframes(w.getnframes())
        if width == 2:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif width == 4:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif width == 1:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported sample width {width}")
    except wave.Error:
        x, sr, nchan = _read_riff_float(data)
    if nchan > 1:
        x = x.reshape(-1, nchan).mean(axis=1)
    return np.ascontiguousarray(x, dtype=np.float32), sr


def _read_riff_float(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Minimal RIFF parser for IEEE-float wavs the wave module rejects."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data" and fmt is not None:
            audio_fmt, nchan, sr = fmt[0], fmt[1], fmt[2]
            bits = fmt[5]
            if audio_fmt == 3 and bits == 32:
                x = np.frombuffer(body, dtype="<f4").astype(np.float32)
            elif audio_fmt == 1 and bits == 16:
                x = np.frombuffer(body, dtype="<i2").astype(np.float32) / 32768.0
            else:
                raise ValueError(f"unsupported fmt {audio_fmt}/{bits}")
            return x, sr, nchan
        pos += 8 + size + (size & 1)
    raise ValueError("no data chunk found")


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        return read_wav_bytes(f.read())


def write_wav(path: str, x: np.ndarray, sample_rate: int = 16000) -> None:
    """Write mono float32 [-1,1] as PCM16."""
    pcm = np.clip(np.asarray(x) * 32768.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
