"""Temporal pooling: frame-level features -> utterance vectors.

Counterpart of `wespeaker_hubert_tpu/models/pooling.py` (TAP, TSDP, TSTP,
ASTP; ASP, MHASTP, MQMHASTP and XI are still to be ported).  Modules take
channels-first (B, D, T) features, as the rest of the PyTorch backbone
keeps them, and an optional (B, T) bool validity mask, so padded batches
pool exactly.  Parameter names and shapes are WeSpeaker's
(reference pooling_layers.py): the attention layers of ASTP are 1x1
`Conv1d`s, with `linear1` taking [x, mean, std] (3D inputs) in the
global-context variant.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

__all__ = ["TAP", "TSDP", "TSTP", "ASTP", "POOLING_LAYERS", "pooling_output_dim"]


def _masked_moments(
    x: torch.Tensor, mask: Optional[torch.Tensor], eps: float = 1e-7
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean/std over time of (B, D, T) with an optional (B, T) mask."""
    if mask is None:
        mean = x.mean(dim=2)
        var = x.var(dim=2, unbiased=False)
    else:
        m = mask[:, None, :].to(x.dtype)
        denom = torch.clamp_min(m.sum(dim=2), 1.0)
        mean = (x * m).sum(dim=2) / denom
        var = ((x - mean[:, :, None]) ** 2 * m).sum(dim=2) / denom
    return mean, torch.sqrt(var + eps)


class TAP(nn.Module):
    """Temporal average pooling."""

    def __init__(self, in_dim: int = 0):
        super().__init__()
        self.in_dim = in_dim

    def forward(self, x, mask=None):
        return _masked_moments(x, mask)[0]


class TSDP(nn.Module):
    """Temporal standard-deviation pooling."""

    def __init__(self, in_dim: int = 0):
        super().__init__()
        self.in_dim = in_dim

    def forward(self, x, mask=None):
        return _masked_moments(x, mask)[1]


class TSTP(nn.Module):
    """Temporal statistics pooling: concat(mean, std)."""

    def __init__(self, in_dim: int = 0):
        super().__init__()
        self.in_dim = in_dim

    def forward(self, x, mask=None):
        return torch.cat(_masked_moments(x, mask), dim=-1)


def _global_context_dense(
    conv: nn.Conv1d, x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor
) -> torch.Tensor:
    """`conv` over the [x, mean, std] channel concat WITHOUT materializing
    the (B, 3D, T) tensor: the time-varying part is a (H, D) @ (B, D, T)
    product, and the global mean/std parts collapse to a (B, H, 1) bias."""
    d = x.shape[1]
    w = conv.weight[:, :, 0]  # (H, 3D)
    glob = mean @ w[:, d : 2 * d].T + std @ w[:, 2 * d :].T + conv.bias
    return torch.matmul(w[:, :d], x) + glob[:, :, None]


class ASTP(nn.Module):
    """Attentive statistics pooling, ECAPA-style: tanh bottleneck ->
    softmax over time -> weighted mean/std; optional global mean/std
    context in the attention input."""

    def __init__(
        self,
        in_dim: int,
        bottleneck_dim: int = 128,
        global_context_att: bool = False,
    ):
        super().__init__()
        self.in_dim = in_dim
        self.global_context_att = global_context_att
        att_in = in_dim * 3 if global_context_att else in_dim
        self.linear1 = nn.Conv1d(att_in, bottleneck_dim, kernel_size=1)
        self.linear2 = nn.Conv1d(bottleneck_dim, in_dim, kernel_size=1)

    def forward(self, x, mask=None):
        if self.global_context_att:
            mean, std = _masked_moments(x, mask)
            a = _global_context_dense(self.linear1, x, mean, std)
        else:
            a = self.linear1(x)
        scores = self.linear2(torch.tanh(a))  # (B, D, T)
        if mask is not None:
            neg = torch.finfo(scores.dtype).min
            scores = scores.masked_fill(~mask[:, None, :], neg)
        alpha = torch.softmax(scores, dim=2)
        mean = (alpha * x).sum(dim=2)
        var = (alpha * x**2).sum(dim=2) - mean**2
        std = torch.sqrt(torch.clamp_min(var, 1e-7))
        return torch.cat([mean, std], dim=-1)


POOLING_LAYERS = {"TAP": TAP, "TSDP": TSDP, "TSTP": TSTP, "ASTP": ASTP}


def pooling_output_dim(pool_type: str, in_dim: int) -> int:
    if pool_type in ("TAP", "TSDP"):
        return in_dim
    if pool_type in ("TSTP", "ASTP"):
        return 2 * in_dim
    raise ValueError(f"pooling {pool_type!r} is not ported")
