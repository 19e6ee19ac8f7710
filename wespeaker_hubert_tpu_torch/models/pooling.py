"""Temporal pooling: frame-level features -> utterance vectors.

Counterpart of `wespeaker_hubert_tpu/models/pooling.py` (TAP, TSDP, TSTP,
ASTP, ASP, MHASTP, MQMHASTP and XI).  Modules take
channels-first (B, D, T) features, as the rest of the PyTorch backbone
keeps them, and an optional (B, T) bool validity mask, so padded batches
pool exactly.  Parameter names and shapes are WeSpeaker's
(reference pooling_layers.py): the attention layers of ASTP are 1x1
`Conv1d`s, with `linear1` taking [x, mean, std] (3D inputs) in the
global-context variant; ASP's attention is the `attention` Sequential
(1x1 conv, ReLU, BatchNorm, 1x1 conv) of WeSpeaker's SimAM-ResNet, and XI's
precision estimator `lin1_relu_bn` (1x1 conv, ReLU, BatchNorm) and `lin2`,
beside `prior_mean` and `prior_logprec`.  MHASTP splits the channel axis
(dim 1) into `head_num` equal chunks, each with its attention
`heads_att_trans.{h}` (1x1 convs `att_{i}` with tanh between); MQMHASTP
holds `query_num` MHASTPs as `n_query.{q}`.  The 2-D backbones feed the
multi-head poolings their frame map flattened frequency-major, as the JAX
package does, so that each head sees the same features there
(`MULTI_HEAD_POOLINGS`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .norm import BatchNorm1d

__all__ = ["TAP", "TSDP", "TSTP", "ASTP", "ASP", "MHASTP", "MQMHASTP", "XI", "POOLING_LAYERS",
           "MULTI_HEAD_POOLINGS", "pooling_output_dim"]


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


def _masked_scores(scores: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, D, T) scores with the padded frames at the dtype's minimum."""
    if mask is None:
        return scores
    return scores.masked_fill(~mask[:, None, :], torch.finfo(scores.dtype).min)


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
        alpha = torch.softmax(_masked_scores(scores, mask), dim=2)
        mean = (alpha * x).sum(dim=2)
        var = (alpha * x**2).sum(dim=2) - mean**2
        std = torch.sqrt(torch.clamp_min(var, 1e-7))
        return torch.cat([mean, std], dim=-1)


class ASP(nn.Module):
    """Attentive statistics pooling with a conv-BN attention (the SimAM
    ResNets'): 1x1 conv -> ReLU -> BatchNorm -> 1x1 conv, softmax over time,
    weighted mean / std with the variance clipped at 1e-5."""

    def __init__(self, in_dim: int, bottleneck_dim: int = 128):
        super().__init__()
        self.in_dim = in_dim
        self.attention = nn.Sequential(
            nn.Conv1d(in_dim, bottleneck_dim, kernel_size=1), nn.ReLU(),
            BatchNorm1d(bottleneck_dim, eps=1e-5, momentum=0.1),
            nn.Conv1d(bottleneck_dim, in_dim, kernel_size=1))

    def forward(self, x, mask=None):
        w = torch.softmax(_masked_scores(self.attention(x), mask), dim=2)
        mu = (x * w).sum(dim=2)
        sg = torch.sqrt(torch.clamp_min((x**2 * w).sum(dim=2) - mu**2, 1e-5))
        return torch.cat([mu, sg], dim=-1)


class MHASTP(nn.Module):
    """Multi-head attentive statistics pooling: the channels split into
    `head_num` chunks, each weighted over time by its own attention (d_s
    1: one score per frame; else one per channel), weighted mean / std per
    head, concatenated."""

    def __init__(self, in_dim: int, layer_num: int = 2, head_num: int = 2, d_s: int = 1,
                 bottleneck_dim: int = 64):
        super().__init__()
        assert in_dim % head_num == 0
        self.in_dim = in_dim
        self.head_num = head_num
        d_model = in_dim // head_num
        dims = [bottleneck_dim] * (layer_num + 1)
        dims[0], dims[-1] = d_model, d_model if d_s > 1 else 1
        self.heads_att_trans = nn.ModuleList()
        for _ in range(head_num):
            att = nn.Sequential()
            for i in range(layer_num - 1):
                att.add_module(f"att_{i}", nn.Conv1d(dims[i], dims[i + 1], kernel_size=1))
                att.add_module(f"tanh{i}", nn.Tanh())
            att.add_module(f"att_{layer_num - 1}",
                           nn.Conv1d(dims[layer_num - 1], dims[layer_num], kernel_size=1))
            self.heads_att_trans.append(att)

    def forward(self, x, mask=None):
        outs = []
        for chunk, att in zip(torch.chunk(x, self.head_num, dim=1), self.heads_att_trans):
            alpha = torch.softmax(_masked_scores(att(chunk), mask), dim=2)
            mean = (alpha * chunk).sum(dim=2)
            var = (alpha * chunk**2).sum(dim=2) - mean**2
            outs.append(torch.cat([mean, torch.sqrt(torch.clamp_min(var, 1e-7))], dim=-1))
        return torch.cat(outs, dim=-1)


class MQMHASTP(nn.Module):
    """Multi-query multi-head attentive statistics pooling: `query_num`
    independent MHASTPs over the same input, concatenated."""

    def __init__(self, in_dim: int, layer_num: int = 2, query_num: int = 2, head_num: int = 8,
                 d_s: int = 2, bottleneck_dim: int = 64):
        super().__init__()
        self.in_dim = in_dim
        self.query_num = query_num
        self.n_query = nn.ModuleList([
            MHASTP(in_dim, layer_num=layer_num, head_num=head_num, d_s=d_s,
                   bottleneck_dim=bottleneck_dim) for _ in range(query_num)])

    def forward(self, x, mask=None):
        return torch.cat([q(x, mask) for q in self.n_query], dim=-1)


class XI(nn.Module):
    """Xi-vector Gaussian-posterior pooling: a frame log-precision 2 log
    softplus(lin2(BN(ReLU(lin1 x)))), the padded frames at the dtype's
    minimum, and the learned prior appended as one pseudo-frame; the
    posterior mean is the softmax-weighted mean over the T + 1 frames (the
    JAX module's `stddev` option, which no config sets, is not ported)."""

    def __init__(self, in_dim: int, hidden_size: int = 256):
        super().__init__()
        self.in_dim = in_dim
        self.lin1_relu_bn = nn.Sequential(
            nn.Conv1d(in_dim, hidden_size, kernel_size=1), nn.ReLU(),
            BatchNorm1d(hidden_size, eps=1e-5, momentum=0.1))
        self.lin2 = nn.Conv1d(hidden_size, in_dim, kernel_size=1)
        self.prior_mean = nn.Parameter(torch.zeros(1, in_dim))
        self.prior_logprec = nn.Parameter(torch.zeros(1, in_dim))

    def forward(self, x, mask=None):
        b, d, _ = x.shape
        logprec = 2.0 * torch.log(F.softplus(self.lin2(self.lin1_relu_bn(x))))
        logprec = _masked_scores(logprec, mask)
        logprec_all = torch.cat(
            [logprec, self.prior_logprec[:, :, None].to(x.dtype).expand(b, d, 1)], dim=2)
        feat_all = torch.cat([x, self.prior_mean[:, :, None].to(x.dtype).expand(b, d, 1)], dim=2)
        return (feat_all * torch.softmax(logprec_all, dim=2)).sum(dim=2)


POOLING_LAYERS = {"TAP": TAP, "TSDP": TSDP, "TSTP": TSTP, "ASTP": ASTP, "ASP": ASP,
                  "MHASTP": MHASTP, "MQMHASTP": MQMHASTP, "XI": XI}
# poolings whose heads split the channel axis: the 2-D backbones flatten
# their frame map frequency-major for these, as the JAX package does
MULTI_HEAD_POOLINGS = ("MHASTP", "MQMHASTP")


def pooling_output_dim(pool_type: str, in_dim: int, **kwargs) -> int:
    if pool_type in ("TAP", "TSDP"):
        return in_dim
    if pool_type in ("TSTP", "ASTP", "ASP", "MHASTP"):
        return 2 * in_dim
    if pool_type == "MQMHASTP":
        return 2 * in_dim * kwargs.get("query_num", 2)
    if pool_type == "XI":
        return 2 * in_dim if kwargs.get("stddev", False) else in_dim
    raise ValueError(f"unknown pooling {pool_type}")
