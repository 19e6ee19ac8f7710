"""Whisper audio encoder frontend (layer-subset concat) in PyTorch.

Counterpart of `wespeaker_hubert_tpu/frontend/whisper.py`: Whisper's log-mel
(ops/whisper_mel.py) computed in the forward, two convolutions (the second
at stride 2) with GELU, sinusoidal positions trimmed to the input length,
pre-LN residual attention blocks, and the outputs of layers
[layer_st..layer_ed] concatenated and layer-normed (`ln_post2`, this fork's
extra norm).  `large_v2()` is the JAX package's: 24 blocks (OpenAI's
large-v2 has 32; the loader reads blocks 0-23), width 1280, 20 heads of 64,
n_ctx 1500.

Parameter names are OpenAI's `encoder.*` names (conv1, conv2,
blocks.{i}.attn.{query,key,value,out} with no bias on `key`,
blocks.{i}.{attn_ln,mlp_ln}, blocks.{i}.mlp.{0,2}) plus `ln_post2`, so
importing an OpenAI state dict is a strict `load_state_dict`
(`load_whisper_state_dict`, the counterpart of
`convert_whisper_state_dict`).

As in the JAX package: every LayerNorm has flax's default epsilon 1e-6
(OpenAI's own is 1e-5); q and k are each scaled by head_dim^-0.25 and
attention runs at scale 1.0; no key is masked, so a bucketed batch's padded
frames are attended to; `h[:, :n_ctx]` cuts utterances past 30 s, and the
valid lengths are clamped to match.  `attn_impl='flash'` runs attention
through the CUDA kernels on CUDA tensors (ops/flash_attention.py; its plain
versions on CPU tensors); 'einsum' is the JAX package's default path.
`frozen=True` runs the encoder outside autograd, and bin/train turns the
`requires_grad` of every frontend tensor off, `ln_post2` included.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.norm import LayerNorm
from ..ops.flash_attention import flash_attention
from ..ops.whisper_mel import HOP, whisper_log_mel

__all__ = [
    "WhisperEncoderConfig",
    "WhisperEncoder",
    "LN_EPS",
    "whisper_encoder_state",
    "load_whisper_state_dict",
    "read_whisper_checkpoint",
]

# flax's LayerNorm default, which the JAX package's Whisper uses
LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class WhisperEncoderConfig:
    n_mels: int = 80
    n_state: int = 1280
    n_head: int = 20
    n_layer: int = 24
    n_ctx: int = 1500
    layer_st: int = 16
    layer_ed: int = 23
    # 'einsum' materializes (B, h, T, T) scores; 'flash' runs the CUDA
    # flash-attention kernels (ops/flash_attention.py)
    attn_impl: str = "einsum"
    # 'erf' is OpenAI's exact GELU; 'tanh' the tanh approximation
    gelu_impl: str = "erf"

    @staticmethod
    def large_v2():
        return WhisperEncoderConfig()

    @staticmethod
    def tiny_test():
        return WhisperEncoderConfig(
            n_state=32, n_head=4, n_layer=4, n_ctx=100, layer_st=1, layer_ed=3
        )

    @property
    def output_size(self) -> int:
        return self.n_state * (self.layer_ed - self.layer_st + 1)


def _sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> np.ndarray:
    """Whisper's positional embedding (length, channels) float32."""
    assert channels % 2 == 0
    log_inc = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def _gelu(cfg: WhisperEncoderConfig, x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if cfg.gelu_impl == "tanh" else "none")


class _MHA(nn.Module):
    def __init__(self, cfg: WhisperEncoderConfig):
        super().__init__()
        d = cfg.n_state
        self.cfg = cfg
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d, bias=False)
        self.value = nn.Linear(d, d)
        self.out = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.cfg.n_head
        hd = d // h
        # whisper scales q and k each by hd**-0.25
        scale = hd ** -0.25
        q = (self.query(x) * scale).reshape(b, t, h, hd)
        k = (self.key(x) * scale).reshape(b, t, h, hd)
        v = self.value(x).reshape(b, t, h, hd)
        if self.cfg.attn_impl == "flash":
            out = flash_attention(q, k, v, bias=None, key_len=None, scale=1.0)
        else:
            # scores stored in the compute dtype, float32 softmax,
            # probabilities back to the compute dtype (the JAX einsum path)
            w = torch.einsum("bqhd,bkhd->bhqk", q, k)
            w = torch.softmax(w.float(), dim=-1).to(v.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return self.out(out.reshape(b, t, d))


class _Block(nn.Module):
    """Pre-LN residual attention block."""

    def __init__(self, cfg: WhisperEncoderConfig):
        super().__init__()
        d = cfg.n_state
        self.attn = _MHA(cfg)
        self.attn_ln = LayerNorm(d, eps=LN_EPS)
        gelu = nn.GELU(approximate="tanh" if cfg.gelu_impl == "tanh" else "none")
        self.mlp = nn.Sequential(nn.Linear(d, 4 * d), gelu, nn.Linear(4 * d, d))
        self.mlp_ln = LayerNorm(d, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_ln(x))
        return x + self.mlp(self.mlp_ln(x))


class WhisperEncoder(nn.Module):
    """wav (B, W) -> ((B, T', n_state * n_concat) features, (B,) valid
    frames or None), T' = min(ceil((W // 160) / 2), n_ctx)."""

    def __init__(self, cfg: WhisperEncoderConfig, frozen: bool = False):
        super().__init__()
        self.cfg = cfg
        self.frozen = frozen
        self.conv1 = nn.Conv1d(cfg.n_mels, cfg.n_state, 3, padding=1)
        self.conv2 = nn.Conv1d(cfg.n_state, cfg.n_state, 3, stride=2, padding=1)
        self.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.n_layer))
        self.ln_post2 = LayerNorm(cfg.output_size, eps=LN_EPS)
        self.register_buffer(
            "positions", torch.tensor(_sinusoids(cfg.n_ctx, cfg.n_state)), persistent=False)

    @property
    def output_size(self) -> int:
        return self.cfg.output_size

    def forward(
        self, wav: torch.Tensor, lengths: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cfg = self.cfg
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.frozen):
            # log-mel in float32, then the caller's compute dtype
            mel = whisper_log_mel(wav, n_mels=cfg.n_mels).to(wav.dtype)
            h = _gelu(cfg, self.conv1(mel.transpose(1, 2)))
            h = _gelu(cfg, self.conv2(h)).transpose(1, 2)
            t = min(h.shape[1], cfg.n_ctx)
            h = h[:, :t]
            h = h + self.positions[:t].to(h.device, h.dtype)[None]  # it must not promote h
            outs = []
            for i, block in enumerate(self.blocks):
                h = block(h)
                if cfg.layer_st <= i <= cfg.layer_ed:
                    outs.append(h)
            xs = self.ln_post2(torch.cat(outs, dim=-1))
        feat_lengths = None
        if lengths is not None:
            # mel frames W // 160, conv2 stride 2 (same pad): ceil(T / 2)
            feat_lengths = torch.clamp_max((lengths.to(xs.device) // HOP + 1) // 2, t)
        return xs, feat_lengths


def whisper_encoder_state(sd: Mapping, cfg: WhisperEncoderConfig) -> Dict[str, torch.Tensor]:
    """An OpenAI Whisper encoder state dict (names with or without the
    `encoder.` prefix; tensors or numpy arrays) -> the tensors
    WhisperEncoder(cfg) loads: conv1, conv2, blocks 0..n_layer-1 (later
    blocks, `positional_embedding` and `ln_post` are not read) and
    `ln_post2`, fresh (ones, zeros) when the state dict has none."""
    if any(k.startswith("encoder.") for k in sd):
        sd = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}

    def keep(name: str) -> bool:
        if name.startswith(("conv1.", "conv2.", "ln_post2.")):
            return True
        if name.startswith("blocks."):
            return int(name.split(".")[1]) < cfg.n_layer
        return False

    out = {k: torch.as_tensor(np.asarray(v, np.float32) if not isinstance(v, torch.Tensor)
                              else v.float())
           for k, v in sd.items() if keep(k)}
    if "ln_post2.weight" not in out:
        out["ln_post2.weight"] = torch.ones(cfg.output_size)
        out["ln_post2.bias"] = torch.zeros(cfg.output_size)
    return out


def load_whisper_state_dict(encoder: WhisperEncoder, sd: Mapping) -> None:
    """Import an OpenAI Whisper encoder state dict into `encoder`: a strict
    `load_state_dict` of `whisper_encoder_state(sd, encoder.cfg)`."""
    encoder.load_state_dict(whisper_encoder_state(sd, encoder.cfg), strict=True)


def read_whisper_checkpoint(path: str) -> Dict:
    """The state dict of an `.npz` (one array per name) or an `.npy` holding
    a pickled dict, as the JAX package's bin/train reads
    `whisper_encoder_args.checkpoint`."""
    sd = np.load(path, allow_pickle=True)
    return dict(sd.item()) if hasattr(sd, "item") else dict(sd)
