"""Wrapper of the fused CUDA fbank kernel (csrc/fbank.cu) and its plain
PyTorch version.

Counterpart of `wespeaker_hubert_tpu/ops/fbank_pallas.py`.  Int16 scaling,
DC removal, pre-emphasis and the window are linear, so `_effective_matrices`
folds them in float64 into cos/sin DFT matrices (a bit-identical copy of the
JAX package's function), and the log-mel of a frame x is

    log(max(((x Ecos)^2 + (x Esin)^2) Mel, float32 eps)).

`fbank_kernel_reference` is that algebra in plain PyTorch.  The kernel
computes the same function with an FFT: per frame the samples' DC removal
and window, an N-point complex FFT (N = fft_size) in radix-8/4 stages
(`FFT_RADICES`, with the twiddles of `fft_twiddles`) of the windowed frame
and of a small correction, pre-emphasis applied after it as the response
1 - c W_N^k (`kernel_tables`; the reason is at the top of csrc/fbank.cu),
the power, and the mel filters' nonzeros (`mel_csr`).  `fbank_kernel`
launches it and raises on any failure, a CPU tensor included (`fbank()`
routes those to the plain path).  `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from .fbank import FbankConfig, frame_signal, num_frames
from .signal import mel_banks, window_function

__all__ = [
    "FFT_RADICES",
    "LAUNCHES",
    "fbank_kernel",
    "fbank_kernel_reference",
    "fft_twiddles",
    "kernel_matrices",
    "kernel_tables",
    "mel_csr",
]

LAUNCHES = 0

# the kernel's FFT sizes and, per size N, the radices of its N-point
# complex FFT (csrc/fbank.cu:FftPlan): Stockham stages, first to last
FFT_RADICES = {256: (8, 8, 4), 512: (8, 8, 8), 1024: (8, 8, 4, 4), 2048: (8, 8, 8, 4)}

_LOG_EPS = float(np.finfo(np.float32).eps)
_SOURCES = ["fbank.cu"]
_MATRICES: Dict[Tuple[FbankConfig, str], Tuple[torch.Tensor, ...]] = {}
_TABLES: Dict[Tuple[FbankConfig, str], Tuple[torch.Tensor, ...]] = {}
_MATRICES_LOCK = threading.Lock()


def _effective_matrices(cfg: FbankConfig):
    """Fold int16-scale, DC removal, pre-emphasis, window and DFT into
    cos/sin projection matrices, computed in float64.

    Returns (ecos, esin, mel, frame_pad, nb_pad, m_pad): (frame_pad, nb_pad),
    (frame_pad, nb_pad) and (nb_pad, m_pad) float32 arrays, zero-padded to
    multiples of 128 so that padded rows/cols contribute exactly 0.
    """
    L = cfg.frame_length
    fft = cfg.fft_size
    nb = fft // 2 + 1
    frame_pad = ((L + 127) // 128) * 128

    n = np.arange(L, dtype=np.float64)[:, None]
    k = np.arange(nb, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / fft
    win = window_function(cfg.window_type, L).astype(np.float64)
    if cfg.scale_to_int16:
        win = win * 32768.0
    ccos = win[:, None] * np.cos(ang)  # (L, nb)
    csin = -win[:, None] * np.sin(ang)

    # pre-emphasis P (L, L): y = P x
    p = float(cfg.preemph_coeff)
    if p != 0.0:
        P = np.eye(L)
        P[0, 0] = 1.0 - p
        P[np.arange(1, L), np.arange(L - 1)] = -p
    else:
        P = np.eye(L)
    # DC removal D (L, L): y = (I - J/L) x
    if cfg.remove_dc_offset:
        D = np.eye(L) - np.full((L, L), 1.0 / L)
    else:
        D = np.eye(L)
    PD = P @ D  # (L, L)
    ecos_l = PD.T @ ccos  # (L, nb)
    esin_l = PD.T @ csin

    nb_pad = ((nb + 127) // 128) * 128
    m = cfg.num_mel_bins
    m_pad = ((m + 127) // 128) * 128

    ecos = np.zeros((frame_pad, nb_pad), np.float32)
    esin = np.zeros((frame_pad, nb_pad), np.float32)
    ecos[:L, :nb] = ecos_l
    esin[:L, :nb] = esin_l

    mel_w = mel_banks(
        m, fft, float(cfg.sample_rate), cfg.low_freq, cfg.high_freq
    ).astype(np.float64)  # (nb, m)
    mel = np.zeros((nb_pad, m_pad), np.float32)
    mel[:nb, :m] = mel_w
    return ecos, esin, mel, frame_pad, nb_pad, m_pad


def kernel_matrices(cfg: FbankConfig, device) -> Tuple[torch.Tensor, ...]:
    """(Ecos (L, NB), Esin (L, NB), Mel (NB, M)) float32 on `device`, the
    unpadded blocks of `_effective_matrices`; built once per (cfg, device)."""
    device = torch.device(device)
    key = (cfg, str(device))
    with _MATRICES_LOCK:
        if key not in _MATRICES:
            ecos, esin, mel, _, _, _ = _effective_matrices(cfg)
            L, nb, m = cfg.frame_length, cfg.fft_size // 2 + 1, cfg.num_mel_bins
            _MATRICES[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (ecos[:L, :nb], esin[:L, :nb], mel[:nb, :m])
            )
        return _MATRICES[key]


def fft_twiddles(n: int) -> np.ndarray:
    """(n, 2) float32 (re, im) of W_n^e = exp(-2 pi i e / n), e < n, computed
    in float64: the twiddles of the kernel's stages."""
    return _complex_table(np.exp(-2j * np.pi * np.arange(n, dtype=np.float64) / n))


def _complex_table(z: np.ndarray) -> np.ndarray:
    return np.stack([z.real, z.imag], axis=-1).astype(np.float32)


def mel_csr(cfg: FbankConfig) -> Tuple[np.ndarray, np.ndarray]:
    """The triangular mel filters of `mel_banks` (nb, M) by their nonzero
    bins: (tab, weights), tab (3, M) int32 holding each filter's first bin,
    bin count and offset into weights, weights (nnz,) float32 the filters'
    values over [first, first + count) (the span between the first and the
    last nonzero), filter after filter."""
    mel = mel_banks(cfg.num_mel_bins, cfg.fft_size, float(cfg.sample_rate),
                    cfg.low_freq, cfg.high_freq)
    tab = np.zeros((3, mel.shape[1]), np.int32)
    weights = []
    for m in range(mel.shape[1]):
        nz = np.flatnonzero(mel[:, m])
        first, count = (int(nz[0]), int(nz[-1] - nz[0] + 1)) if nz.size else (0, 0)
        tab[:, m] = first, count, sum(len(w) for w in weights)
        weights.append(mel[first:first + count, m])
    return tab, np.concatenate(weights).astype(np.float32)


def kernel_tables(cfg: FbankConfig, device) -> Tuple[torch.Tensor, ...]:
    """The kernel's tables on `device`, built once per (cfg, device):
    twiddles (N, 2); the pre-emphasis response 1 - c W_N^k, k <= N/2, as
    (N/2 + 1, 2) from float64; the window (L,), float32 of the float64
    `window_function` as the plain path takes it; its differences
    window[n] - window[n-1] (L,) of those float32 values (entry 0 unused);
    the mel tab (3, M) int32 and weights (nnz,) of `mel_csr`."""
    device = torch.device(device)
    key = (cfg, str(device))
    with _MATRICES_LOCK:
        if key not in _TABLES:
            n = cfg.fft_size
            tab, weights = mel_csr(cfg)
            window = window_function(cfg.window_type, cfg.frame_length).astype(np.float32)
            dwindow = np.diff(window.astype(np.float64), prepend=0.0).astype(np.float32)
            emph = 1.0 - float(cfg.preemph_coeff) * np.exp(
                -2j * np.pi * np.arange(n // 2 + 1, dtype=np.float64) / n)
            _TABLES[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (fft_twiddles(n), _complex_table(emph), window, dwindow, tab, weights)
            )
        return _TABLES[key]


def fbank_kernel_reference(wav: torch.Tensor, cfg: FbankConfig) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, W) -> (B, T, M) float32."""
    if wav.dim() == 1:
        wav = wav[None]
    ecos, esin, mel = kernel_matrices(cfg, wav.device)
    frames = frame_signal(wav.float(), cfg.frame_length, cfg.frame_shift)
    pc = torch.matmul(frames, ecos)
    ps = torch.matmul(frames, esin)
    out = torch.matmul(pc * pc + ps * ps, mel)
    return torch.log(torch.clamp_min(out, _LOG_EPS))


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        from ..utils.cuda_build import load_library

        lib = load_library("fbank", _SOURCES)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # wav, B, W, T, L, shift, n_fft, twiddles, emph, window, dwindow, mel
        # tab, mel weights, num_mel, nnz, preemph, flags, out, stream
        lib.fbank_logmel_f32.argtypes = [
            ptr, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32,
            ctypes.c_float, i32, ptr, ptr,
        ]
        lib.fbank_logmel_f32.restype = i32
        lib.fbank_error_string.argtypes = [i32]
        lib.fbank_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def fbank_kernel(wav: torch.Tensor, cfg: FbankConfig) -> torch.Tensor:
    """(B, W) float32 CUDA wav -> (B, T, M) float32 log-mel through the CUDA
    kernel.  Eval only: no dither, always the log; FFT sizes 256-2048 (8-48
    kHz at 25 ms frames)."""
    global LAUNCHES
    if cfg.dither != 0.0:
        raise ValueError("the fbank kernel is the dither-free eval path")
    if not cfg.use_log:
        raise ValueError("the fbank kernel always takes the log (use_log=True)")
    if wav.dim() == 1:
        wav = wav[None]
    if not wav.is_cuda:
        raise ValueError(f"fbank_kernel takes a CUDA tensor, got one on {wav.device}")
    if wav.dtype != torch.float32:
        raise TypeError(f"fbank_kernel takes float32, got {wav.dtype}")
    if wav.dim() != 2:
        raise ValueError(f"fbank_kernel takes (B, W), got {tuple(wav.shape)}")
    if not wav.is_contiguous():
        raise ValueError("fbank_kernel takes a contiguous wav batch")
    b, w = wav.shape
    L, shift = cfg.frame_length, cfg.frame_shift
    t = num_frames(w, L, shift)
    if t <= 0:
        raise ValueError(f"{w} samples hold no {L}-sample frame")
    if cfg.fft_size not in FFT_RADICES:
        raise ValueError(f"the fbank kernel takes FFT sizes {sorted(FFT_RADICES)}, got "
                         f"{cfg.fft_size} ({L}-sample frames)")
    tw, emph, window, dwindow, tab, weights = kernel_tables(cfg, wav.device)
    m = cfg.num_mel_bins
    out = torch.empty((b, t, m), device=wav.device, dtype=torch.float32)
    flags = int(cfg.scale_to_int16) | (int(cfg.remove_dc_offset) << 1)
    lib = _library()
    with torch.cuda.device(wav.device):
        stream = torch.cuda.current_stream(wav.device).cuda_stream
        rc = lib.fbank_logmel_f32(
            wav.data_ptr(), b, w, t, L, shift, cfg.fft_size, tw.data_ptr(), emph.data_ptr(),
            window.data_ptr(), dwindow.data_ptr(), tab.data_ptr(), weights.data_ptr(), m,
            weights.numel(), float(cfg.preemph_coeff), flags, out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"fbank kernel launch failed: {lib.fbank_error_string(rc).decode()}"
        )
    LAUNCHES += 1
    return out
