"""Whisper's log-mel spectrogram, batched.

Counterpart of `wespeaker_hubert_tpu/ops/whisper_mel.py`, step by step: a
reflect padding of N_FFT // 2 on each side, 400-point frames at hop 160, a
periodic Hann window, a float32 rFFT (`torch.fft.rfft`, cuFFT on the card,
as the JAX function's is a library FFT too), |.|^2, the last frame dropped
(Whisper's convention), the slaney-normalized mel filterbank (librosa's
`filters.mel(htk=False)`) as a float32 product with TF32 off (JAX asks for
`Precision.HIGHEST`), log10 of max(., 1e-10), the dynamic range cut to 8
below each utterance's maximum, and (x + 4) / 4.  It is no Pallas kernel in
the JAX package, so it stays plain PyTorch on every device.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["N_FFT", "HOP", "whisper_log_mel", "slaney_mel_filters"]

N_FFT = 400
HOP = 160


def slaney_mel_filters(
    sr: int = 16000, n_fft: int = N_FFT, n_mels: int = 80
) -> np.ndarray:
    """librosa.filters.mel(..., htk=False, norm='slaney') reimplemented:
    mel scale linear below 1 kHz then logarithmic, triangle weights with
    slaney area normalization.  Returns (n_mels, n_fft//2 + 1) float32 (a
    copy of the JAX package's function)."""
    f_min, f_max = 0.0, sr / 2.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        f_sp = 200.0 / 3
        mels = f / f_sp
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        return np.where(
            f >= min_log_hz,
            min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
            mels,
        )

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        f_sp = 200.0 / 3
        freqs = f_sp * m
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        return np.where(
            m >= min_log_mel,
            min_log_hz * np.exp(logstep * (m - min_log_mel)),
            freqs,
        )

    mel_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fft_freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)

    weights = np.zeros((n_mels, len(fft_freqs)))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    # slaney normalization: 2 / bandwidth
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


_TABLES: Dict[Tuple[int, str], Tuple[torch.Tensor, torch.Tensor]] = {}


def _tables(n_mels: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(window (N_FFT,), filters^T (N_FFT//2 + 1, n_mels)) float32 on
    `device`, made once per (n_mels, device)."""
    key = (n_mels, str(device))
    if key not in _TABLES:
        window = torch.from_numpy(np.hanning(N_FFT + 1)[:-1].astype(np.float32))
        filters = torch.from_numpy(slaney_mel_filters(n_mels=n_mels)).t().contiguous()
        _TABLES[key] = (window.to(device), filters.to(device))
    return _TABLES[key]


@contextlib.contextmanager
def _no_tf32():
    """float32 matmuls in full float32 for the block (cuBLAS's TF32 off)."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def whisper_log_mel(wav: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """(B, W) wav in [-1, 1] -> (B, W // HOP, n_mels) float32 (float64 for
    a float64 wav)."""
    if wav.dim() == 1:
        wav = wav[None]
    wav = wav.to(torch.promote_types(wav.dtype, torch.float32))
    pad = N_FFT // 2
    x = F.pad(wav[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP)  # (B, 1 + W // HOP, N_FFT)
    window, filters = (t.to(wav.dtype) for t in _tables(n_mels, wav.device))
    spec = torch.fft.rfft(frames * window, n=N_FFT, dim=-1)
    mag = spec.abs() ** 2
    mag = mag[:, :-1]  # whisper drops the last frame
    with _no_tf32():
        mel = torch.matmul(mag, filters)
    log_spec = torch.log10(torch.clamp_min(mel, 1e-10))
    max_val = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, max_val - 8.0)
    return (log_spec + 4.0) / 4.0
