"""HuBERT / WavLM speech encoders in PyTorch (the SSL frontend backbone).

Counterpart of `wespeaker_hubert_tpu/frontend/ssl_encoder.py`, with the
parameter names of HuggingFace's `HubertModel` / `WavLMModel`, so their
state_dicts load as they are (frontend/convert.py composes the weight-norm
positional conv).  The layouts follow: conv weights (out, in / groups, k),
the positional conv an `nn.Conv1d(groups=16)`, linears (out, in).

Architecture (both models):
  wav (B, W) -> 7-layer strided conv feature extractor (GELU; group-norm
  first layer for 'group' norm mode, per-layer LayerNorm for 'layer') ->
  feature projection (LN + Linear) -> conv positional embedding (grouped
  conv k=128 g=16, same-pad, one trailing frame trimmed, GELU) -> N
  transformer layers (post-LN for base models, pre-LN 'stable' for large)
  -> 1 + N hidden states.

WavLM adds gated relative-position-bias attention: a bucketed relative
position embedding (first layer only, passed down the stack) scaled by a
per-head gate computed from the layer input.

`attn_impl='flash'` runs attention through the hand-written CUDA kernels on
CUDA tensors (ops/flash_attention.py; its plain versions on CPU tensors)
with the padded keys masked by length.  WavLM's gated bias goes to them in
factored form, the (h, T, T) table (built once, padded for TMA) and the
(B, h, T, 1) gate, and is formed in the kernels, never materialized; under
autograd the `FlashAttention` Function returns the table's and the gate's
gradients, so `rel_attn_embed`, `gru_rel_pos_linear` and
`gru_rel_pos_const` train.  'einsum' is the JAX package's default path:
scores stored in the compute dtype, a -1e9 padding bias, float32 softmax.
There is no dropout, as in the JAX package, so training and inference run
the same function.  Norms take float32 statistics and return the input dtype
(models/norm.py).  The sequence-parallel `act_constraint` of the JAX config
is a multi-chip feature and is not ported.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.norm import GroupNorm, LayerNorm
from ..ops.flash_attention import flash_attention

__all__ = [
    "SSLEncoderConfig",
    "SSLEncoder",
    "ConvFeatureEncoder",
    "PositionalConvEmbedding",
    "WavLMAttention",
    "PlainAttention",
    "FeedForward",
    "EncoderLayer",
    "feat_extract_output_lengths",
]


@dataclasses.dataclass(frozen=True)
class SSLEncoderConfig:
    model_type: str = "hubert"  # 'hubert' | 'wavlm'
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    feat_extract_norm: str = "group"  # 'group' (base) | 'layer' (large)
    do_stable_layer_norm: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    # wavlm relative position bias
    num_buckets: int = 320
    max_distance: int = 800
    # 'einsum' materializes (B, h, T, T) scores; 'flash' runs the CUDA
    # flash-attention kernel (ops/flash_attention.py)
    attn_impl: str = "einsum"
    # 'erf' is the HF-exact GELU; 'tanh' the tanh approximation
    gelu_impl: str = "erf"

    @staticmethod
    def hubert_base():
        return SSLEncoderConfig()

    @staticmethod
    def wavlm_base():
        return SSLEncoderConfig(model_type="wavlm")

    @staticmethod
    def wavlm_large():
        return SSLEncoderConfig(
            model_type="wavlm",
            hidden_size=1024,
            num_hidden_layers=24,
            num_attention_heads=16,
            intermediate_size=4096,
            feat_extract_norm="layer",
            do_stable_layer_norm=True,
        )

    @staticmethod
    def wav2vec2_base():
        """wav2vec 2.0 base: for inference the HF Wav2Vec2Model forward is
        the HubertModel graph, so its checkpoints load through the hubert
        path."""
        return SSLEncoderConfig.hubert_base()

    @staticmethod
    def wav2vec2_large_lv60():
        """facebook/wav2vec2-large-lv60 / -robust / xlsr family:
        layer-norm feature extractor + pre-LN encoder."""
        return SSLEncoderConfig.hubert_large()

    @staticmethod
    def wav2vec2_large_960h():
        """facebook/wav2vec2-large (LibriSpeech 960h): group-norm feature
        extractor + post-LN encoder, unlike the lv60 family."""
        return SSLEncoderConfig(
            hidden_size=1024,
            num_hidden_layers=24,
            num_attention_heads=16,
            intermediate_size=4096,
        )

    # the s3prl upstream name 'wav2vec2_large' means the lv60 variant
    wav2vec2_large = wav2vec2_large_lv60

    @staticmethod
    def hubert_large():
        return SSLEncoderConfig(
            hidden_size=1024,
            num_hidden_layers=24,
            num_attention_heads=16,
            intermediate_size=4096,
            feat_extract_norm="layer",
            do_stable_layer_norm=True,
        )

    @staticmethod
    def tiny(model_type="hubert", do_stable_layer_norm=False):
        """For tests: 2 layers, 32-dim."""
        return SSLEncoderConfig(
            model_type=model_type,
            hidden_size=32,
            num_hidden_layers=2,
            num_attention_heads=4,
            intermediate_size=64,
            conv_dim=(16, 16, 16),
            conv_kernel=(10, 3, 3),
            conv_stride=(5, 2, 2),
            do_stable_layer_norm=do_stable_layer_norm,
            num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4,
            num_buckets=32,
            max_distance=64,
        )


def _gelu(cfg: SSLEncoderConfig, x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if cfg.gelu_impl == "tanh" else "none")


def feat_extract_output_lengths(cfg: SSLEncoderConfig, lengths):
    """Conv feature-extractor output lengths (floor((L-k)/s)+1 chain)."""
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        lengths = (lengths - k) // s + 1
    return lengths


class _ConvLayer(nn.Module):
    def __init__(self, cfg: SSLEncoderConfig, i: int):
        super().__init__()
        cin = 1 if i == 0 else cfg.conv_dim[i - 1]
        dim = cfg.conv_dim[i]
        self.cfg = cfg
        self.conv = nn.Conv1d(
            cin, dim, cfg.conv_kernel[i], stride=cfg.conv_stride[i], bias=False
        )
        self.layer_norm = None
        if cfg.feat_extract_norm == "group" and i == 0:
            self.layer_norm = GroupNorm(dim, dim, eps=cfg.layer_norm_eps)
        elif cfg.feat_extract_norm == "layer":
            self.layer_norm = LayerNorm(dim, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, T) -> (B, C', T')."""
        x = self.conv(x)
        if isinstance(self.layer_norm, LayerNorm):
            x = self.layer_norm(x.transpose(1, 2)).transpose(1, 2)
        elif self.layer_norm is not None:
            # one group per channel, statistics over all T (padding included,
            # as in the JAX package and HF)
            x = self.layer_norm(x)
        return _gelu(self.cfg, x)


class ConvFeatureEncoder(nn.Module):
    def __init__(self, cfg: SSLEncoderConfig):
        super().__init__()
        self.conv_layers = nn.ModuleList(
            _ConvLayer(cfg, i) for i in range(len(cfg.conv_dim))
        )

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, W) -> (B, T, conv_dim[-1])."""
        h = wav[:, None, :]
        for layer in self.conv_layers:
            h = layer(h)
        return h.transpose(1, 2)


class _FeatureProjection(nn.Module):
    def __init__(self, cfg: SSLEncoderConfig):
        super().__init__()
        self.layer_norm = LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x):
        return self.projection(self.layer_norm(x))


class PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: SSLEncoderConfig):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.cfg = cfg
        self.conv = nn.Conv1d(
            cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
            groups=cfg.num_conv_pos_embedding_groups,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, H) -> (B, T, H)."""
        if x.dtype == torch.bfloat16 and not x.is_cuda:
            # PyTorch's CPU bf16 grouped conv1d is wrong for some shapes
            # (torch 2.13: C=32, groups=4, k=16 is off by 5.0 on outputs of
            # 6.5); on the CPU it runs in float32 and rounds back
            c = self.conv
            h = F.conv1d(x.transpose(1, 2).float(), c.weight.float(), c.bias.float(),
                         padding=c.padding, groups=c.groups).to(x.dtype)
        else:
            h = self.conv(x.transpose(1, 2))
        if self.cfg.num_conv_pos_embeddings % 2 == 0:  # same-pad: trim one frame
            h = h[:, :, :-1]
        return _gelu(self.cfg, h).transpose(1, 2)


def _relative_positions_bucket(
    relative_positions: np.ndarray, num_buckets: int, max_distance: int
) -> np.ndarray:
    """WavLM (T5-style bidirectional) bucketing, in float64 numpy: a copy of
    the JAX package's function."""
    num_buckets = num_buckets // 2
    relative_buckets = (relative_positions > 0).astype(np.int64) * num_buckets
    rel = np.abs(relative_positions)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    rel_large = (
        np.log(np.maximum(rel, 1).astype(np.float64) / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    )
    rel_large = np.minimum(
        (max_exact + rel_large).astype(np.int64), num_buckets - 1
    )
    relative_buckets += np.where(is_small, rel, rel_large)
    return relative_buckets


_BUCKETS: Dict[Tuple[int, int, int, str], torch.Tensor] = {}
_BUCKETS_LOCK = threading.Lock()


def _bucket_table(t: int, cfg: SSLEncoderConfig, device) -> torch.Tensor:
    """(T, T) int64 bucket indices on `device`, built once per (T, device)."""
    key = (t, cfg.num_buckets, cfg.max_distance, str(device))
    with _BUCKETS_LOCK:
        if key not in _BUCKETS:
            pos = np.arange(t)
            buckets = _relative_positions_bucket(
                pos[None, :] - pos[:, None], cfg.num_buckets, cfg.max_distance
            )
            _BUCKETS[key] = torch.from_numpy(buckets).to(device)
        return _BUCKETS[key]


def _attend(cfg, q, k, v, bias, lengths, gate=None):
    """q, k, v (B, T, h, hd); bias (B, h, T, T), or with `gate` (B, h, T, 1)
    the (h, T, T) table of the gated bias gate * bias, or None; lengths (B,)
    valid frames or None -> (B, T, h * hd).  The flash path forms the gated
    bias in the kernels; the einsum path materializes it."""
    b, t, h, hd = q.shape
    if cfg.attn_impl == "flash":
        out = flash_attention(q, k, v, bias=bias, key_len=lengths, scale=1.0 / math.sqrt(hd),
                              bias_gate=gate)
        return out.reshape(b, t, h * hd)
    if gate is not None:
        bias = gate * bias[None]
    # scores stored in the compute dtype, float32 softmax, probabilities
    # back to the compute dtype (the JAX package's einsum path)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if bias is not None:
        scores = scores + bias
    if lengths is not None:
        valid = torch.arange(t, device=q.device)[None, :] < lengths[:, None]
        pad = torch.where(valid, 0.0, -1e9)[:, None, None, :]
        scores = scores + pad.to(scores.dtype)
    probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, h * hd)


class WavLMAttention(nn.Module):
    """Self-attention with gated relative position bias (WavLM)."""

    def __init__(self, cfg: SSLEncoderConfig, has_relative_position_bias: bool):
        super().__init__()
        d, h = cfg.hidden_size, cfg.num_attention_heads
        self.cfg = cfg
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, h, 1, 1))
        self.gru_rel_pos_linear = nn.Linear(d // h, 8)
        self.rel_attn_embed = (
            nn.Embedding(cfg.num_buckets, h) if has_relative_position_bias else None
        )

    def forward(self, x, lengths, position_bias):
        cfg = self.cfg
        b, t, d = x.shape
        h = cfg.num_attention_heads
        hd = d // h
        if position_bias is None:
            buckets = _bucket_table(t, cfg, x.device)
            position_bias = self.rel_attn_embed.weight[buckets].permute(2, 0, 1)  # (h, T, T)
            if cfg.attn_impl == "flash":
                # contiguous once for all layers, rows padded to 16 bytes: the
                # kernels read the table by TMA
                pad = -t % 8
                position_bias = F.pad(position_bias, (0, pad))[..., :t] if pad else (
                    position_bias.contiguous())

        # the gate from the layer input (HF WavLMAttention.forward)
        gated_hidden = x.reshape(b, t, h, hd).transpose(1, 2)  # (B, h, T, hd)
        proj = self.gru_rel_pos_linear(gated_hidden).reshape(b, h, t, 2, 4).sum(-1)
        gate = torch.sigmoid(proj)
        gate_a, gate_b = gate[..., 0:1], gate[..., 1:2]
        gate_output = gate_a * (gate_b * self.gru_rel_pos_const - 1.0) + 2.0  # (B, h, T, 1)

        q = self.q_proj(x).reshape(b, t, h, hd)
        k = self.k_proj(x).reshape(b, t, h, hd)
        v = self.v_proj(x).reshape(b, t, h, hd)
        # the gated bias gate_output * position_bias[None] (B, h, T, T)
        out = _attend(cfg, q, k, v, position_bias, lengths, gate=gate_output)
        return self.out_proj(out), position_bias


class PlainAttention(nn.Module):
    """Standard MHA (HuBERT / wav2vec2)."""

    def __init__(self, cfg: SSLEncoderConfig):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x, lengths, position_bias=None):
        b, t, d = x.shape
        h = self.cfg.num_attention_heads
        q = self.q_proj(x).reshape(b, t, h, d // h)
        k = self.k_proj(x).reshape(b, t, h, d // h)
        v = self.v_proj(x).reshape(b, t, h, d // h)
        return self.out_proj(_attend(self.cfg, q, k, v, None, lengths)), None


class FeedForward(nn.Module):
    def __init__(self, cfg: SSLEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.output_dense(_gelu(self.cfg, self.intermediate_dense(x)))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: SSLEncoderConfig, layer_idx: int):
        super().__init__()
        self.cfg = cfg
        if cfg.model_type == "wavlm":
            self.attention = WavLMAttention(cfg, has_relative_position_bias=(layer_idx == 0))
        else:
            self.attention = PlainAttention(cfg)
        self.layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = FeedForward(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, lengths, position_bias):
        if self.cfg.do_stable_layer_norm:  # pre-LN (large models)
            a, position_bias = self.attention(self.layer_norm(x), lengths, position_bias)
            x = x + a
            x = x + self.feed_forward(self.final_layer_norm(x))
        else:  # post-LN (base models)
            a, position_bias = self.attention(x, lengths, position_bias)
            x = self.layer_norm(x + a)
            x = x + self.feed_forward(x)
            x = self.final_layer_norm(x)
        return x, position_bias


class _Encoder(nn.Module):
    """Holds the HF `encoder.*` parameters; SSLEncoder.forward runs them."""

    def __init__(self, cfg: SSLEncoderConfig):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, i) for i in range(cfg.num_hidden_layers)
        )


class SSLEncoder(nn.Module):
    """Full encoder: wav -> list of hidden states (1 + num_layers)."""

    def __init__(self, cfg: SSLEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = ConvFeatureEncoder(cfg)
        self.feature_projection = _FeatureProjection(cfg)
        self.encoder = _Encoder(cfg)

    def forward(
        self, wav: torch.Tensor, lengths: Optional[torch.Tensor] = None
    ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
        """(B, W) wav [-1, 1], optional (B,) valid samples -> ([1 + N hidden
        states (B, T, H)], (B,) valid frames or None)."""
        cfg = self.cfg
        h = self.feature_projection(self.feature_extractor(wav))

        feat_lengths = None
        if lengths is not None:
            feat_lengths = feat_extract_output_lengths(cfg, lengths.to(h.device))
            t = h.shape[1]
            mask = torch.arange(t, device=h.device)[None, :] < feat_lengths[:, None]
            h = h * mask[:, :, None].to(h.dtype)

        enc = self.encoder
        h = h + enc.pos_conv_embed(h)
        if not cfg.do_stable_layer_norm:
            h = enc.layer_norm(h)

        hidden_states = [h]
        position_bias = None
        for layer in enc.layers:
            h, position_bias = layer(h, feat_lengths, position_bias)
            hidden_states.append(h)
        if cfg.do_stable_layer_norm:
            # the final LN applies to the last state (large models); the
            # featurizer mixes the raw per-layer states, as s3prl does
            hidden_states[-1] = enc.layer_norm(hidden_states[-1])
        return hidden_states, feat_lengths
