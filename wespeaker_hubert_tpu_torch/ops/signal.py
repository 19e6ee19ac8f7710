"""Static DSP tables for the fbank frontend (numpy).

A copy of `wespeaker_hubert_tpu/ops/signal.py`: window functions and
Kaldi-style mel filterbank matrices.  They depend only on the config,
never on data, and are built once per config in float64.

Semantics follow the Kaldi feature-extraction definition (mel scale
1127*ln(1+f/700), triangular bins laid out uniformly in mel between
low_freq and high_freq, FFT size = next power of two of the window length).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "mel_scale",
    "next_pow2",
    "window_function",
    "mel_banks",
]


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def window_function(window_type: str, window_size: int) -> np.ndarray:
    """Kaldi-style analysis windows of length `window_size` (float64)."""
    n = np.arange(window_size, dtype=np.float64)
    a = 2.0 * math.pi / (window_size - 1)
    if window_type == "hanning":
        return 0.5 - 0.5 * np.cos(a * n)
    if window_type == "hamming":
        return 0.54 - 0.46 * np.cos(a * n)
    if window_type == "povey":
        # Kaldi's default: hanning ** 0.85
        return (0.5 - 0.5 * np.cos(a * n)) ** 0.85
    if window_type == "rectangular":
        return np.ones(window_size, dtype=np.float64)
    if window_type == "blackman":
        blackman_coeff = 0.42
        return (
            blackman_coeff
            - 0.5 * np.cos(a * n)
            + (0.5 - blackman_coeff) * np.cos(2 * a * n)
        )
    raise ValueError(f"unknown window type {window_type!r}")


def mel_banks(
    num_bins: int,
    window_length_padded: int,
    sample_freq: float,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> np.ndarray:
    """Triangular mel filterbank matrix, shape (num_fft_bins+1, num_bins).

    Kaldi semantics: `high_freq <= 0` means nyquist + high_freq.  The filter
    for bin j is triangular in *mel* space between left/center/right mel
    points spaced `mel_delta = (mel_high - mel_low) / (num_bins + 1)` apart.
    The nyquist bin (index num_fft_bins) always has zero weight; it is kept
    so the (num_fft_bins+1)-wide power spectrum multiplies it directly.
    """
    assert num_bins >= 3
    num_fft_bins = window_length_padded // 2
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    assert 0.0 <= low_freq < nyquist and low_freq < high_freq <= nyquist

    fft_bin_width = sample_freq / window_length_padded
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    # mel value of each fft bin (num_fft_bins,)
    fft_mel = mel_scale(fft_bin_width * np.arange(num_fft_bins, dtype=np.float64))

    left = mel_low + np.arange(num_bins, dtype=np.float64) * mel_delta
    center = left + mel_delta
    right = center + mel_delta

    m = fft_mel[:, None]  # (F, 1)
    up = (m - left[None, :]) / mel_delta
    down = (right[None, :] - m) / mel_delta
    weights = np.maximum(0.0, np.minimum(up, down))

    out = np.zeros((num_fft_bins + 1, num_bins), dtype=np.float64)
    out[:num_fft_bins] = weights
    return out.astype(np.float32)
