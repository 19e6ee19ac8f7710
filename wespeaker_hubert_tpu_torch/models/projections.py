"""Margin-softmax classifier heads (the training-time projection).

Counterpart of `wespeaker_hubert_tpu/models/projections.py`.  The margin is
a call argument (the schedule's value at the step), and a head returns
`(logits, aux_loss)`: aux_loss is None except for `SphereFace2`, whose
binary-classification loss replaces cross-entropy.  Parameter names and
layouts are WeSpeaker's (reference wespeaker/models/projections.py):

  * the margin heads: `projection.weight` (num_class, embed_dim), the JAX
    package's (embed_dim, num_class) transposed;
  * `ArcMarginIntertopkSubcenter`: `projection.weight` (num_class * K,
    embed_dim), row c * K + k sub-center k of class c;
  * `SphereFace2`: `projection.weight` and `projection.bias` (1, 1);
  * `LinearProduct` (WeSpeaker's `Linear`): `projection.trans` = (BatchNorm1d,
    ReLU, Linear).

Two behaviours of the JAX package are kept as they are: its SpeakerNet calls
a head as `projection(emb, label, margin)`, so `SphereProduct`'s lambda
anneal always runs at `it = 1`; and `LinearProduct`'s BatchNorm always
normalizes with its running statistics (the JAX head is never passed
`train`), in training too, and never updates them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .norm import upcast

__all__ = [
    "ArcMarginProduct",
    "ArcMarginIntertopkSubcenter",
    "AddMarginProduct",
    "SphereProduct",
    "SphereFace2",
    "LinearProduct",
    "get_projection",
]

Margin = Union[float, torch.Tensor]


def _cosine_logits(embed: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """cos(theta) between the L2-normalized embeddings (B, D) and class
    weights (C, D), in float32 (float64 for float64 inputs)."""
    e = F.normalize(upcast(embed), dim=-1, eps=1e-12)
    w = F.normalize(upcast(weight), dim=-1, eps=1e-12)
    return e @ w.t()


def _margin(margin: Margin, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(margin, dtype=torch.float32, device=like.device)


def _xavier_weight(rows: int, cols: int) -> nn.Parameter:
    w = nn.Parameter(torch.empty(rows, cols))
    nn.init.xavier_uniform_(w)
    return w


def _arc_phi(cosine: torch.Tensor, m: torch.Tensor, easy_margin: bool) -> torch.Tensor:
    """cos(theta + m), with `easy_margin` (the margin only where cos(theta)
    > 0) or the `mmm = 1 + cos(pi - m)` continuity fix where cos(theta) <=
    cos(pi - m)."""
    sine = torch.sqrt(torch.clamp(1.0 - cosine**2, 0.0, 1.0))
    phi = cosine * torch.cos(m) - sine * torch.sin(m)
    if easy_margin:
        return torch.where(cosine > 0, phi, cosine)
    th = torch.cos(math.pi - m)
    return torch.where(cosine > th, phi, cosine - (1.0 + th))


class ArcMarginProduct(nn.Module):
    """AAM-softmax: cos(theta + m) at the target class."""

    def __init__(self, embed_dim: int, num_class: int, scale: float = 32.0,
                 easy_margin: bool = False):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_class = num_class
        self.scale = scale
        self.easy_margin = easy_margin
        self.weight = _xavier_weight(num_class, embed_dim)

    def forward(self, embed: torch.Tensor, label: torch.Tensor, margin: Margin = 0.0
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cosine = _cosine_logits(embed, self.weight)
        phi = _arc_phi(cosine, _margin(margin, cosine), self.easy_margin)
        one_hot = F.one_hot(label.long(), self.num_class).bool()
        return torch.where(one_hot, phi, cosine) * self.scale, None


class ArcMarginIntertopkSubcenter(nn.Module):
    """AAM-softmax over the max of K sub-centers per class, with the
    inter-top-k penalty: cos(theta - mp) on the k_top hardest non-target
    classes, mp ramped with the margin schedule (mp * margin / 0.2, none
    below margin 0.001).  `do_lm` (large-margin fine-tune) switches the
    penalty off."""

    def __init__(self, embed_dim: int, num_class: int, scale: float = 32.0,
                 easy_margin: bool = False, K: int = 3, mp: float = 0.06, k_top: int = 5,
                 do_lm: bool = False):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_class = num_class
        self.scale = scale
        self.easy_margin = easy_margin
        self.K = K
        self.mp = 0.0 if do_lm else mp
        self.k_top = 0 if do_lm else k_top
        self.weight = _xavier_weight(num_class * K, embed_dim)

    def forward(self, embed: torch.Tensor, label: torch.Tensor, margin: Margin = 0.0
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cosine = _cosine_logits(embed, self.weight)
        cosine = cosine.reshape(-1, self.num_class, self.K).amax(dim=-1)  # (B, C)
        m = _margin(margin, cosine)
        mp = torch.where(m > 0.001, self.mp * (m / 0.2), torch.zeros_like(m))
        sine = torch.sqrt(torch.clamp(1.0 - cosine**2, 0.0, 1.0))
        phi = _arc_phi(cosine, m, self.easy_margin)
        phi_mp = cosine * torch.cos(mp) + sine * torch.sin(mp)  # cos(theta - mp)
        one_hot = F.one_hot(label.long(), self.num_class).to(cosine.dtype)
        if self.k_top > 0:
            _, top_idx = torch.topk(cosine - 2 * one_hot, self.k_top, dim=-1)
            top = torch.zeros_like(cosine).scatter_(1, top_idx, 1.0)
            logits = one_hot * phi + top * phi_mp + (1.0 - one_hot - top) * cosine
        else:
            logits = torch.where(one_hot > 0, phi, cosine)
        return logits * self.scale, None


class AddMarginProduct(nn.Module):
    """CosFace / additive-margin softmax: cos(theta) - m at the target."""

    def __init__(self, embed_dim: int, num_class: int, scale: float = 32.0):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_class = num_class
        self.scale = scale
        self.weight = _xavier_weight(num_class, embed_dim)

    def forward(self, embed: torch.Tensor, label: torch.Tensor, margin: Margin = 0.0
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cosine = _cosine_logits(embed, self.weight)
        one_hot = F.one_hot(label.long(), self.num_class).to(cosine.dtype)
        return (cosine - one_hot * _margin(margin, cosine)) * self.scale, None


# Chebyshev polynomials: cos(m theta) from cos(theta), m = 0..5
_CHEBYSHEV = (
    lambda x: x * 0 + 1,
    lambda x: x,
    lambda x: 2 * x**2 - 1,
    lambda x: 4 * x**3 - 3 * x,
    lambda x: 8 * x**4 - 8 * x**2 + 1,
    lambda x: 16 * x**5 - 20 * x**3 + 5 * x,
)


class SphereProduct(nn.Module):
    """A-softmax / SphereFace: cos(m theta) at the target, blended with
    cos(theta) by the annealed lambda = max(lambda_min, base (1 + gamma
    it)^-power), logits scaled by the embedding's norm.  `margin` is the
    integer angular multiplier m (< 6); the call's `margin` argument (the
    schedule's) is not used, and `it` stays 1 as the JAX SpeakerNet calls it."""

    def __init__(self, embed_dim: int, num_class: int, margin: int = 4, base: float = 1000.0,
                 gamma: float = 0.12, power: float = 1.0, lambda_min: float = 5.0):
        super().__init__()
        if not 0 <= margin < len(_CHEBYSHEV):
            raise ValueError(f"sphere's margin must be an integer in 0-5, not {margin!r}")
        self.embed_dim = embed_dim
        self.num_class = num_class
        self.margin = margin
        self.base = base
        self.gamma = gamma
        self.power = power
        self.lambda_min = lambda_min
        self.weight = _xavier_weight(num_class, embed_dim)

    def lamb(self, it: float = 1) -> float:
        return max(self.lambda_min, self.base * (1 + self.gamma * it) ** (-self.power))

    def forward(self, embed: torch.Tensor, label: torch.Tensor, margin: Margin = 0.0,
                it: float = 1) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cos_t = torch.clamp(_cosine_logits(embed, self.weight), -1.0, 1.0)
        cos_m_t = _CHEBYSHEV[self.margin](cos_t)
        with torch.no_grad():  # k is a step function of theta
            k = torch.floor(self.margin * torch.arccos(cos_t) / math.pi)
        phi = (1.0 - 2.0 * torch.remainder(k, 2.0)) * cos_m_t - 2 * k
        feat_norm = torch.linalg.vector_norm(upcast(embed), dim=1, keepdim=True)
        one_hot = F.one_hot(label.long(), self.num_class).to(cos_t.dtype)
        return (one_hot * (phi - cos_t) / (1 + self.lamb(it)) + cos_t) * feat_norm, None


class SphereFace2(nn.Module):
    """SphereFace2's binary-classification head: returns the scaled cosine
    logits (for accuracy) and its loss, which replaces cross-entropy.
    `margin_type` 'A' (ArcFace-like) or 'C' (CosFace-like)."""

    def __init__(self, embed_dim: int, num_class: int, scale: float = 32.0,
                 lanbuda: float = 0.7, t: float = 3.0, margin_type: str = "C"):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_class = num_class
        self.scale = scale
        self.lanbuda = lanbuda
        self.t = t
        self.margin_type = margin_type
        self.weight = _xavier_weight(num_class, embed_dim)
        self.bias = nn.Parameter(torch.zeros(1, 1))

    def forward(self, embed: torch.Tensor, label: torch.Tensor, margin: Margin = 0.0
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cos = _cosine_logits(embed, self.weight)
        m = _margin(margin, cos).to(cos.dtype)
        b0 = self.bias[0, 0].to(cos.dtype)

        def fun_g(z):
            return 2.0 * ((z + 1.0) / 2.0) ** self.t - 1.0

        if self.margin_type == "A":
            sin = torch.sqrt(torch.clamp(1.0 - cos**2, 0.0, 1.0))
            th = torch.cos(math.pi - m)
            mmm = 1.0 + torch.cos(math.pi - m)
            pos = torch.where(cos > th, cos * torch.cos(m) - sin * torch.sin(m), cos - mmm)
            cos_m_theta_p = self.scale * fun_g(pos) + b0
            cos_m_theta_n = self.scale * fun_g(cos * torch.cos(m) + sin * torch.sin(m)) + b0
        else:
            cos_m_theta_p = self.scale * (fun_g(cos) - m) + b0
            cos_m_theta_n = self.scale * (fun_g(cos) + m) + b0
        zero = torch.zeros_like(cos)  # softplus as log(1 + e^x), as jax.nn.softplus
        cos_p_theta = self.lanbuda * torch.logaddexp(-cos_m_theta_p, zero)
        cos_n_theta = (1.0 - self.lanbuda) * torch.logaddexp(cos_m_theta_n, zero)
        target = F.one_hot(label.long(), self.num_class).to(cos.dtype)
        logits = self.scale * (cos - m * target)
        loss = (target * cos_p_theta + (1 - target) * cos_n_theta).sum(dim=1).mean()
        return logits, loss


class _RunningStatsBatchNorm(nn.BatchNorm1d):
    """BatchNorm1d that always normalizes with its running statistics and
    never updates them (the JAX LinearProduct's BatchNorm, which is never
    told it is training)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=self.eps)


class LinearProduct(nn.Module):
    """Plain softmax head (WeSpeaker's `Linear`): BatchNorm -> ReLU -> Linear,
    the BatchNorm on its running statistics in training too."""

    def __init__(self, embed_dim: int, num_class: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_class = num_class
        self.trans = nn.Sequential(_RunningStatsBatchNorm(embed_dim, eps=1e-5), nn.ReLU(),
                                   nn.Linear(embed_dim, num_class))

    def forward(self, embed: torch.Tensor, label: Optional[torch.Tensor] = None,
                margin: Margin = 0.0) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return self.trans(embed), None


def get_projection(conf: dict) -> nn.Module:
    """The head named by `project_type` (conf also holds embed_dim and
    num_class), with the JAX package's defaults; an unknown or missing
    `project_type` gives `LinearProduct`, as there."""
    ptype = conf.get("project_type", "linear")
    embed_dim, num_class = conf["embed_dim"], conf["num_class"]
    if ptype == "add_margin":
        return AddMarginProduct(embed_dim, num_class, scale=conf.get("scale", 32.0))
    if ptype == "arc_margin":
        return ArcMarginProduct(embed_dim, num_class, scale=conf.get("scale", 32.0),
                                easy_margin=conf.get("easy_margin", False))
    if ptype == "arc_margin_intertopk_subcenter":
        return ArcMarginIntertopkSubcenter(
            embed_dim, num_class, scale=conf.get("scale", 32.0),
            easy_margin=conf.get("easy_margin", False), K=conf.get("K", 3),
            mp=conf.get("mp", 0.06), k_top=conf.get("k_top", 5), do_lm=conf.get("do_lm", False))
    if ptype == "sphere":
        return SphereProduct(embed_dim, num_class, margin=conf.get("margin", 4))
    if ptype == "sphereface2":
        return SphereFace2(embed_dim, num_class, scale=conf.get("scale", 32.0),
                           lanbuda=conf.get("lanbuda", 0.7), t=conf.get("t", 3),
                           margin_type=conf.get("margin_type", "C"))
    return LinearProduct(embed_dim, num_class)
