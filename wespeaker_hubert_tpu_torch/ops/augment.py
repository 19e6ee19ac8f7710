"""Waveform augmentation on the device: RIR reverb, SNR-banded noise mixing
and speed perturbation, batched.

Counterpart of `wespeaker_hubert_tpu/ops/augment.py` (plain PyTorch: there is
no Pallas there).  The host only chooses the parameters (which RIR or
noise, the SNR, the speed index) and ships fixed-size arrays; the arithmetic
runs here:

  * reverb: FFT convolution (rfft / irfft at the next power of two) with the
    energy-normalized RIR, cut to the input length;
  * noise at a target SNR with the reference's dB formulas and 1e-4 floors;
  * augmented rows are peak-normalized into [-1, 1];
  * speed perturbation by 0.9 / 1.0 / 1.1 as a polyphase product: every
    block of 10 output samples reads p = 10 * speed input samples with fixed
    per-phase linear-interpolation weights.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "SPEEDS",
    "add_reverb_noise",
    "add_reverb_noise_packed",
    "speed_input_len",
    "speed_perturb",
]

SPEEDS = (1.0, 0.9, 1.1)

_POLY_Q = 10
_POLY_P = {1.0: 10, 0.9: 9, 1.1: 11}


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _fft_reverb(wav: torch.Tensor, rir: torch.Tensor) -> torch.Tensor:
    """Rows of `wav` (N, L) convolved with the energy-normalized rows of
    `rir` (N, R), cut to L."""
    l, r = wav.shape[1], rir.shape[1]
    energy = torch.sqrt(torch.sum(rir.float() ** 2, dim=1, keepdim=True))
    rir_n = rir / torch.clamp_min(energy, 1e-8)
    nfft = _next_pow2(l + r - 1)
    y = torch.fft.irfft(
        torch.fft.rfft(wav, n=nfft, dim=-1) * torch.fft.rfft(rir_n, n=nfft, dim=-1),
        n=nfft, dim=-1,
    )
    return y[:, :l]


def _noise_mix(wav: torch.Tensor, noise: torch.Tensor, snr: torch.Tensor) -> torch.Tensor:
    audio_db = 10.0 * torch.log10(torch.mean(wav**2, dim=1) + 1e-4)
    noise_db = 10.0 * torch.log10(torch.mean(noise**2, dim=1) + 1e-4)
    gain = torch.sqrt(10.0 ** ((audio_db - noise_db - snr) / 10.0))
    return wav + gain[:, None] * noise


def _peak_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.amax(torch.abs(x), dim=1, keepdim=True) + 1e-4)


def add_reverb_noise(
    wav: torch.Tensor,
    rir: torch.Tensor,
    noise: torch.Tensor,
    aug_type: torch.Tensor,
    snr: torch.Tensor,
) -> torch.Tensor:
    """Per-row augmentation.

    wav (B, L) in [-1, 1]; rir (B, R) zero-padded; noise (B, L); aug_type
    (B,) int, 0: none, 1: reverb, 2: additive noise; snr (B,) dB."""
    y = _fft_reverb(wav, rir)
    z = _noise_mix(wav, noise, snr)
    out = torch.where(
        (aug_type == 1)[:, None], y, torch.where((aug_type == 2)[:, None], z, wav)
    )
    return torch.where((aug_type > 0)[:, None], _peak_normalize(out), out)


def add_reverb_noise_packed(
    wav: torch.Tensor,
    rir: torch.Tensor,
    noise: torch.Tensor,
    snr: torch.Tensor,
    n_reverb: int,
) -> torch.Tensor:
    """The packed layout: rows [0, n_reverb) get reverb with `rir`
    (n_reverb, R), the next noise.shape[0] rows noise (n_noise, L) at `snr`
    (n_noise,) dB, the rest pass through untouched.  Only the reverb rows
    are FFT-convolved."""
    n_noise = noise.shape[0]
    parts = []
    if n_reverb:
        parts.append(_fft_reverb(wav[:n_reverb], rir))
    if n_noise:
        parts.append(_noise_mix(wav[n_reverb:n_reverb + n_noise], noise, snr))
    if not parts:
        return wav
    aug = _peak_normalize(torch.cat(parts, dim=0))
    return torch.cat([aug, wav[n_reverb + n_noise:]], dim=0)


def _poly_plan(s: float):
    """(p, w_in, k, weight (q, w_in)) for speed s = p / 10."""
    p = _POLY_P[s]
    w_in = int(np.floor((_POLY_Q - 1) * s)) + 2
    k = -(-w_in // p) + 1  # slabs needed to cover a block
    weight = np.zeros((_POLY_Q, w_in), np.float32)
    for j in range(_POLY_Q):
        pos = j * s
        lo = int(np.floor(pos))
        f = pos - lo
        weight[j, lo] += 1.0 - f
        weight[j, lo + 1] += f
    return p, w_in, k, weight


def speed_input_len(out_len: int) -> int:
    """Samples the host supplies per utterance so that every speed has input
    for whole polyphase blocks."""
    m = -(-out_len // _POLY_Q)
    need = 0
    for s in SPEEDS:
        p, _, k, _ = _poly_plan(s)
        need = max(need, (m + k - 1) * p)
    return need


def speed_perturb(wav: torch.Tensor, speed_idx: torch.Tensor, out_len: int) -> torch.Tensor:
    """Resample row i by SPEEDS[speed_idx[i]] (sox 'speed': output[n] =
    linear interpolation of the input at n * speed) to exactly out_len
    samples.  wav (B, L_in) with L_in >= speed_input_len(out_len)."""
    b, l_in = wav.shape
    m = -(-out_len // _POLY_Q)
    outs = []
    for s in SPEEDS:
        p, w_in, k, weight = _poly_plan(s)
        need = (m + k - 1) * p
        x = torch.nn.functional.pad(wav, (0, need - l_in)) if l_in < need else wav
        slabs = [x[:, j * p:(j + m) * p].reshape(b, m, p) for j in range(k)]
        xb = torch.cat(slabs, dim=-1)[:, :, :w_in]  # (B, M, w_in)
        w = torch.from_numpy(weight).to(xb.device, xb.dtype)
        y = torch.einsum("bmw,qw->bmq", xb, w)
        outs.append(y.reshape(b, m * _POLY_Q)[:, :out_len])
    stacked = torch.stack(outs)  # (3, B, out_len)
    return stacked[speed_idx.long().to(wav.device), torch.arange(b, device=wav.device)]
