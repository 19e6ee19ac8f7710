"""Batched Kaldi-compatible log-mel filterbank frontend in PyTorch.

Counterpart of `wespeaker_hubert_tpu/ops/fbank.py`.  One pass over a
(B, W) waveform batch:

    frame -> dither -> DC removal -> preemphasis -> window
        -> DFT (two matmuls, or rFFT) -> power -> mel matmul -> log

Numerical semantics match Kaldi with snip_edges=True, round-to-pow2 FFT:
  - num_frames = 1 + (W - frame_len) // frame_shift
  - per-frame: optional gaussian dither, optional DC offset removal,
    preemphasis 0.97 with first-sample self-subtraction, hamming window
  - power spectrum of the zero-padded frame, 257 bins for 16 kHz/25 ms
  - triangular mel bins between 20 Hz and nyquist
  - log with the float32 epsilon floor
`scale_to_int16=True` scales [-1, 1] waveforms by 32768 first, as the
reference recipes do.

`spectrum_impl="kernel"` (or "pallas", the JAX package's name for the same
setting) routes dither-free CUDA batches to the hand-written fbank kernel
(`ops/fbank_kernel.py`); CPU tensors, dithered batches and `use_log=False`
take the plain matmul path below.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .signal import mel_banks, next_pow2, window_function

__all__ = ["FbankConfig", "fbank", "num_frames", "frame_signal"]

_LOG_EPS = float(np.finfo(np.float32).eps)  # 1.1920929e-07
_KERNEL_IMPLS = ("kernel", "pallas")


@dataclasses.dataclass(frozen=True)
class FbankConfig:
    sample_rate: int = 16000
    num_mel_bins: int = 80
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    dither: float = 0.0
    preemph_coeff: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "hamming"
    low_freq: float = 20.0
    high_freq: float = 0.0  # <=0 means nyquist + high_freq
    use_log: bool = True
    scale_to_int16: bool = True
    compute_dtype: torch.dtype = torch.float32
    # 'matmul': DFT as two (frame_len, n_bins) matmuls; 'fft': torch rFFT;
    # 'kernel' / 'pallas': the fused CUDA kernel for dither-free log-mel of
    # CUDA batches (ops/fbank_kernel.py), the 'matmul' path otherwise.
    spectrum_impl: str = "matmul"
    # Kept for config parity with the JAX package.  A float32 matmul in
    # PyTorch is exact float32 unless torch.backends.cuda.matmul.allow_tf32
    # is set, which the port never does.
    matmul_precision: str = "highest"

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * self.frame_length_ms * 1e-3)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms * 1e-3)

    @property
    def fft_size(self) -> int:
        return next_pow2(self.frame_length)


def num_frames(num_samples, frame_length: int, frame_shift: int):
    """Kaldi snip_edges frame count; works on ints or tensors."""
    return 1 + (num_samples - frame_length) // frame_shift


def frame_signal(
    wav: torch.Tensor, frame_length: int, frame_shift: int
) -> torch.Tensor:
    """(B, W) -> (B, T, frame_length) overlapping frames (snip_edges), as a
    strided view of `wav`."""
    return wav.unfold(-1, frame_length, frame_shift)


def _dft_matrix(cfg: FbankConfig) -> np.ndarray:
    """(frame_len, 2 * n_bins) [cos | -sin] real-DFT matrix."""
    n_bins = cfg.fft_size // 2 + 1
    k = np.arange(n_bins)[None, :]
    n = np.arange(cfg.frame_length)[:, None]
    ang = 2.0 * np.pi * n * k / cfg.fft_size
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).astype(
        np.float32
    )


def _mel_matrix(cfg: FbankConfig) -> np.ndarray:
    return mel_banks(
        cfg.num_mel_bins,
        cfg.fft_size,
        float(cfg.sample_rate),
        cfg.low_freq,
        cfg.high_freq,
    )


def _fbank_impl(
    wav: torch.Tensor,
    cfg: FbankConfig,
    generator: Optional[torch.Generator],
) -> torch.Tensor:
    dev = wav.device
    frame_len = cfg.frame_length

    x = wav.float()
    if cfg.scale_to_int16:
        x = x * 32768.0
    frames = frame_signal(x, frame_len, cfg.frame_shift)  # (B, T, L)

    if cfg.dither != 0.0 and generator is not None:
        noise = torch.randn(
            frames.shape, generator=generator, device=dev, dtype=torch.float32
        )
        frames = frames + cfg.dither * noise

    if cfg.remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)

    if cfg.preemph_coeff != 0.0:
        # out[0] = f[0] - c*f[0]; out[i] = f[i] - c*f[i-1]
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - cfg.preemph_coeff * prev

    window = torch.as_tensor(
        window_function(cfg.window_type, frame_len), dtype=torch.float32
    ).to(dev)
    frames = frames * window

    if cfg.spectrum_impl == "matmul":
        n_bins = cfg.fft_size // 2 + 1
        coeffs = torch.as_tensor(_dft_matrix(cfg)).to(dev)
        proj = torch.matmul(
            frames.to(cfg.compute_dtype), coeffs.to(cfg.compute_dtype)
        ).float()
        power = proj[..., :n_bins] ** 2 + proj[..., n_bins:] ** 2
    elif cfg.spectrum_impl == "fft":
        spec = torch.fft.rfft(frames, n=cfg.fft_size, dim=-1)
        power = spec.real**2 + spec.imag**2
    else:
        raise ValueError(f"unknown spectrum_impl {cfg.spectrum_impl!r}")

    mel_w = torch.as_tensor(_mel_matrix(cfg)).to(dev)
    mel = torch.matmul(
        power.to(cfg.compute_dtype), mel_w.to(cfg.compute_dtype)
    ).float()
    if cfg.use_log:
        mel = torch.log(torch.clamp_min(mel, _LOG_EPS))
    return mel


def fbank(
    wav: torch.Tensor,
    cfg: FbankConfig = FbankConfig(),
    generator: Optional[torch.Generator] = None,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Compute log-mel fbank features for a batch of waveforms.

    Args:
      wav: (B, W) float waveform batch in [-1, 1].
      cfg: FbankConfig.
      generator: torch.Generator for dither (on wav's device); dither is
        skipped when None (eval mode).
      lengths: optional (B,) valid sample counts for padded batches.

    Returns:
      (feats, feat_lengths): feats (B, T, num_mel_bins) float32; feat_lengths
      (B,) int32 valid frame counts (None when lengths is None).  Frames
      past feat_lengths are garbage and must be masked by the consumer.
    """
    if wav.dim() == 1:
        wav = wav[None]
    dithered = cfg.dither != 0.0 and generator is not None
    if cfg.spectrum_impl in _KERNEL_IMPLS:
        plain_cfg = dataclasses.replace(cfg, spectrum_impl="matmul")
        if wav.is_cuda and not dithered and cfg.use_log:
            from .fbank_kernel import fbank_kernel

            feats = fbank_kernel(
                wav.float().contiguous(),
                dataclasses.replace(plain_cfg, dither=0.0),
            )
        else:
            feats = _fbank_impl(wav, plain_cfg, generator)
    else:
        feats = _fbank_impl(wav, cfg, generator)
    if lengths is None:
        return feats, None
    lengths = torch.as_tensor(lengths, device=wav.device)
    feat_lengths = torch.clamp_min(
        num_frames(lengths, cfg.frame_length, cfg.frame_shift), 0
    ).to(torch.int32)
    return feats, feat_lengths
