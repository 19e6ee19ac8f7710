"""Silero-VAD (v5, 16 kHz) on PyTorch.

Counterpart of `wespeaker_hubert_tpu/diar/silero.py`.  WeSpeaker's system
SAD and CLI VAD run the Silero torchscript model one 512-sample chunk at a
time from Python (make_system_sad.py, threshold 0.18).  Here a whole
conversation batch is one forward of `SileroVAD`: chunk framing, the STFT
basis projection and the four-conv encoder are batched over every chunk,
and the 128-wide LSTM carried across chunks is one `nn.LSTM` call over
the sequence (cuDNN's on the card), as the JAX package's `lax.scan` runs
outside any Pallas kernel.

Architecture (the public silero-vad v5 graph):
  chunk = [context 64 samples | 512 new samples]  (the context is the tail
  of the previous chunk, zeros for the first)
  -> reflect-pad left 128, STFT basis projection (256 taps, hop 128)
     => 4 frames x 258 (real || imag), magnitude => (4, 129)
  -> encoder: 4 x [Conv1d k=3 pad=1 + ReLU], channels 129->128->64->64->128,
     strides 1, 2, 2, 1  => 128 features per chunk
  -> LSTM(128) across chunks -> ReLU -> Conv1d(128->1) -> sigmoid

Weights: nothing is downloaded.  `convert_silero_state_dict` takes the
official package's `load_silero_vad().state_dict()` into the JAX package's
parameter tree (numpy; `silero_init_params` makes a seeded one),
`save_silero_params` / `load_silero_params` keep it as an `.npz` (a model
directory's `vad.npz`), and `SileroVAD.from_params` loads it through
`models/convert_jax.py:silero_state_from_jax`.  Without weights,
`diar.sad.energy_vad` stands in.

`get_speech_timestamps` is silero_vad/utils_vad.py's triggered / hangover
state machine, then its padding pass.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "silero_init_params",
    "silero_probs",
    "silero_probs_batch",
    "convert_silero_state_dict",
    "load_silero_params",
    "save_silero_params",
    "get_speech_timestamps",
    "SileroVAD",
]

SR = 16000
WINDOW = 512  # samples per chunk at 16 kHz
CONTEXT = 64  # samples of left context carried between chunks
FILTER_LEN = 256
HOP = 128
N_BINS = FILTER_LEN // 2 + 1  # 129
STFT_PAD = FILTER_LEN // 2  # reflect pad (left) inside the STFT
BATCH_ROWS = 16  # conversations per forward: one shape per chunk bucket

# encoder conv spec: (in, out, stride); all k=3, pad=1
_ENCODER = ((N_BINS, 128, 1), (128, 64, 2), (64, 64, 2), (64, 128, 1))
_HIDDEN = 128


def _stft_basis() -> np.ndarray:
    """(258, 256) forward DFT basis as the model's forward_basis_buffer:
    rows [real part; imag part] of the DFT matrix, Hann-windowed."""
    k = np.arange(N_BINS)[:, None]
    n = np.arange(FILTER_LEN)[None, :]
    ang = -2.0 * np.pi * k * n / FILTER_LEN
    win = np.hanning(FILTER_LEN + 1)[:-1]
    return np.concatenate([np.cos(ang), np.sin(ang)], axis=0).astype(
        np.float32
    ) * win[None, :]


def silero_init_params(rng: Optional[np.random.Generator] = None) -> Dict:
    """Random parameter tree with the official shapes, as the JAX
    package's (same draws from `rng`)."""
    rng = rng or np.random.default_rng(0)

    def conv(cin, cout, k):
        scale = 1.0 / np.sqrt(cin * k)
        return {
            "kernel": rng.uniform(-scale, scale, (cout, cin, k)).astype(
                np.float32
            ),
            "bias": rng.uniform(-scale, scale, (cout,)).astype(np.float32),
        }

    params = {"stft_basis": _stft_basis()}
    for i, (cin, cout, _s) in enumerate(_ENCODER):
        params[f"encoder_{i}"] = conv(cin, cout, 3)
    s = 1.0 / np.sqrt(_HIDDEN)
    params["lstm"] = {
        "weight_ih": rng.uniform(-s, s, (4 * _HIDDEN, _HIDDEN)).astype(
            np.float32
        ),
        "weight_hh": rng.uniform(-s, s, (4 * _HIDDEN, _HIDDEN)).astype(
            np.float32
        ),
        "bias_ih": rng.uniform(-s, s, (4 * _HIDDEN,)).astype(np.float32),
        "bias_hh": rng.uniform(-s, s, (4 * _HIDDEN,)).astype(np.float32),
    }
    params["out"] = conv(_HIDDEN, 1, 1)
    return params


def convert_silero_state_dict(sd: Dict) -> Dict:
    """Official jit / package state_dict -> the parameter tree.

    Keys with or without the `_model.` prefix (the torchscript model nests
    the 16 kHz graph under `_model`; `_model_8k`, the 8 kHz variant, is not
    supported).  Values may be torch tensors or numpy arrays."""

    def get(key):
        for k in (f"_model.{key}", key):
            if k in sd:
                v = sd[k]
                return np.asarray(
                    v.detach().cpu().numpy() if hasattr(v, "detach") else v,
                    np.float32,
                )
        raise KeyError(f"silero state_dict missing {key!r}")

    params: Dict = {
        # (258, 1, 256) conv weight -> (258, 256)
        "stft_basis": get("stft.forward_basis_buffer").reshape(
            2 * N_BINS, FILTER_LEN
        )
    }
    for i in range(len(_ENCODER)):
        params[f"encoder_{i}"] = {
            "kernel": get(f"encoder.{i}.reparam_conv.weight"),
            "bias": get(f"encoder.{i}.reparam_conv.bias"),
        }
    params["lstm"] = {
        "weight_ih": get("decoder.rnn.weight_ih"),
        "weight_hh": get("decoder.rnn.weight_hh"),
        "bias_ih": get("decoder.rnn.bias_ih"),
        "bias_hh": get("decoder.rnn.bias_hh"),
    }
    params["out"] = {
        "kernel": get("decoder.decoder.2.weight"),
        "bias": get("decoder.decoder.2.bias"),
    }
    return params


def save_silero_params(path: str, params: Dict) -> None:
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                walk(v, key + "/")
            else:
                flat[key] = np.asarray(v)

    walk(params, "")
    np.savez(path, **flat)


def load_silero_params(path: str) -> Dict:
    with np.load(path) as data:
        params: Dict = {}
        for key in data.files:
            parts = key.split("/")
            node = params
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return params


class SileroVAD(nn.Module):
    """Speech probabilities, one per 512-sample chunk, of a (B, N * 512)
    float32 batch of 16 kHz waveforms."""

    def __init__(self):
        super().__init__()
        self.register_buffer("stft_basis", torch.from_numpy(_stft_basis()).float())
        self.encoder = nn.ModuleList(
            nn.Conv1d(cin, cout, 3, stride=s, padding=1) for cin, cout, s in _ENCODER
        )
        self.lstm = nn.LSTM(_HIDDEN, _HIDDEN, batch_first=True)
        self.out = nn.Conv1d(_HIDDEN, 1, 1)

    @classmethod
    def from_params(cls, params: Dict, device="cpu") -> "SileroVAD":
        """A module on `device` from the parameter tree (strict load)."""
        from ..models.convert_jax import silero_state_from_jax

        model = cls()
        model.load_state_dict(silero_state_from_jax(params), strict=True)
        return model.to(device).eval()

    @classmethod
    def from_file(cls, path: str, device="cpu") -> "SileroVAD":
        return cls.from_params(load_silero_params(path), device)

    @property
    def device(self) -> torch.device:
        return self.stft_basis.device

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        b, w = wav.shape
        n = w // WINDOW
        body = wav.float().reshape(b, n, WINDOW)
        ctx = torch.cat([body.new_zeros(b, 1, CONTEXT), body[:, :-1, -CONTEXT:]], dim=1)
        x = torch.cat([ctx, body], dim=-1)  # (B, N, 576)
        # reflect-pad left by 128 (torch F.pad mode='reflect')
        x = torch.cat([x[..., 1 : STFT_PAD + 1].flip(-1), x], dim=-1)  # (B, N, 704)
        frames = x.unfold(-1, FILTER_LEN, HOP)  # (B, N, 4, 256)
        proj = frames @ self.stft_basis.T  # (B, N, 4, 258)
        mag = torch.sqrt(proj[..., :N_BINS] ** 2 + proj[..., N_BINS:] ** 2 + 1e-12)
        h = mag.reshape(b * n, -1, N_BINS).transpose(1, 2)  # (B N, 129, 4)
        for conv in self.encoder:
            h = F.relu(conv(h))
        feat = h[:, :, 0].reshape(b, n, _HIDDEN)  # time collapsed to 1 by the strides
        hs, _ = self.lstm(feat)  # causal: trailing zero chunks change no earlier output
        logits = self.out(F.relu(hs).transpose(1, 2))  # (B, 1, N)
        return torch.sigmoid(logits)[:, 0]


def _chunks(n_samples: int) -> int:
    return max(1, -(-n_samples // WINDOW))


def _bucket(n_chunks: int) -> int:
    """Power-of-two chunk count, at least 32: a conversation's probabilities
    come from a forward of the same shape whether it runs alone or in a
    batch, so the two agree bit for bit."""
    return max(32, 1 << (n_chunks - 1).bit_length())


def silero_probs(model: SileroVAD, wav: np.ndarray) -> np.ndarray:
    """Whole-utterance speech probabilities, one per 512-sample window: one
    row of `silero_probs_batch`."""
    return silero_probs_batch(model, [wav])[0]


def silero_probs_batch(model: SileroVAD, wavs, return_device: bool = False):
    """Speech probabilities of many conversations, on the model's device.

    Conversations are sorted by length and grouped by power-of-two chunk
    bucket, up to BATCH_ROWS a forward, each forward BATCH_ROWS rows wide
    (zero rows fill a short group).  With ``return_device=True`` it also
    returns the uploaded (BATCH_ROWS, bucket * 512) float32 batches and a
    conversation -> (batch index, row) map, so a caller can slice the VAD
    segments out of the same upload (`Speaker._fbank_slices_from_rows`)."""
    dev = model.device
    wavs = [np.asarray(w, np.float32).reshape(-1) for w in wavs]
    chunks = [_chunks(len(w)) for w in wavs]
    order = sorted(range(len(wavs)), key=lambda i: chunks[i])
    out: Dict[int, np.ndarray] = {}
    batches: List[torch.Tensor] = []
    locs: Dict[int, tuple] = {}
    i = 0
    while i < len(order):
        bucket = _bucket(chunks[order[i]])
        idx = []
        while i < len(order) and chunks[order[i]] <= bucket and len(idx) < BATCH_ROWS:
            idx.append(order[i])
            i += 1
        batch = np.zeros((BATCH_ROWS, bucket * WINDOW), np.float32)
        for row, j in enumerate(idx):
            batch[row, : len(wavs[j])] = wavs[j]
            locs[j] = (len(batches), row)
        batch_dev = torch.from_numpy(batch).to(dev)
        batches.append(batch_dev)
        with torch.inference_mode():
            probs = model(batch_dev).cpu().numpy()
        for row, j in enumerate(idx):
            out[j] = probs[row, : chunks[j]]
    probs_list = [out[j] for j in range(len(wavs))]
    if return_device:
        return probs_list, batches, locs
    return probs_list


def get_speech_timestamps(
    wav: np.ndarray,
    model,
    threshold: float = 0.5,
    sampling_rate: int = SR,
    min_speech_duration_ms: float = 250,
    max_speech_duration_s: float = float("inf"),
    min_silence_duration_ms: float = 100,
    speech_pad_ms: float = 30,
    return_seconds: bool = False,
    neg_threshold: Optional[float] = None,
) -> List[Dict[str, float]]:
    """silero_vad.get_speech_timestamps (utils_vad.py): the triggered /
    hangover state machine over per-window probabilities, then the
    inter-segment padding pass.  `model` is a SileroVAD or any callable
    wav -> probabilities."""
    if sampling_rate != SR:
        raise ValueError("only 16 kHz supported")
    wav = np.asarray(wav, np.float32)
    audio_len = len(wav)
    if isinstance(model, SileroVAD):
        probs = silero_probs(model, wav)
    else:
        probs = np.asarray(model(wav))

    min_speech = int(sampling_rate * min_speech_duration_ms / 1000)
    pad = int(sampling_rate * speech_pad_ms / 1000)
    if max_speech_duration_s == float("inf"):
        max_speech = float("inf")
    else:
        max_speech = sampling_rate * max_speech_duration_s - WINDOW - 2 * pad
    min_silence = int(sampling_rate * min_silence_duration_ms / 1000)
    min_silence_at_max = int(sampling_rate * 98 / 1000)
    if neg_threshold is None:
        neg_threshold = max(threshold - 0.15, 0.01)

    triggered = False
    speeches: List[Dict[str, float]] = []
    current: Dict[str, float] = {}
    temp_end = 0
    prev_end = 0
    next_start = 0

    for i, prob in enumerate(probs):
        cur_sample = WINDOW * i
        if prob >= threshold and temp_end:
            temp_end = 0
            if next_start < prev_end:
                next_start = cur_sample
        if prob >= threshold and not triggered:
            triggered = True
            current["start"] = cur_sample
            continue
        if triggered and cur_sample - current["start"] > max_speech:
            if prev_end:
                current["end"] = prev_end
                speeches.append(current)
                current = {}
                if next_start < prev_end:
                    triggered = False
                else:
                    current["start"] = next_start
                prev_end = next_start = temp_end = 0
            else:
                current["end"] = cur_sample
                speeches.append(current)
                current = {}
                prev_end = next_start = temp_end = 0
                triggered = False
                continue
        if prob < neg_threshold and triggered:
            if not temp_end:
                temp_end = cur_sample
            if cur_sample - temp_end > min_silence_at_max:
                prev_end = temp_end
            if cur_sample - temp_end < min_silence:
                continue
            current["end"] = temp_end
            if current["end"] - current["start"] > min_speech:
                speeches.append(current)
            current = {}
            prev_end = next_start = temp_end = 0
            triggered = False
            continue

    if (
        current
        and "start" in current
        and audio_len - current["start"] > min_speech
    ):
        current["end"] = audio_len
        speeches.append(current)

    for i, speech in enumerate(speeches):
        if i == 0:
            speech["start"] = int(max(0, speech["start"] - pad))
        if i != len(speeches) - 1:
            silence = speeches[i + 1]["start"] - speech["end"]
            if silence < 2 * pad:
                speech["end"] += int(silence // 2)
                speeches[i + 1]["start"] = int(
                    max(0, speeches[i + 1]["start"] - silence // 2)
                )
            else:
                speech["end"] = int(min(audio_len, speech["end"] + pad))
                speeches[i + 1]["start"] = int(
                    max(0, speeches[i + 1]["start"] - pad)
                )
        else:
            speech["end"] = int(min(audio_len, speech["end"] + pad))

    if return_seconds:
        return [
            {
                "start": round(s["start"] / sampling_rate, 1),
                "end": round(s["end"] / sampling_rate, 1),
            }
            for s in speeches
        ]
    return speeches
