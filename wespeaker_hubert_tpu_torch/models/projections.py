"""Margin-softmax classifier heads (the training-time projection).

Counterpart of `wespeaker_hubert_tpu/models/projections.py`.  The margin is
a call argument (the schedule's value at the step), and a head returns
`(logits, aux_loss)` with aux_loss None for the heads here.  The weight
keeps WeSpeaker's name and layout, `projection.weight` (num_class,
embed_dim); the JAX package stores it transposed, (embed_dim, num_class).
Only `arc_margin` is ported; the other heads are queued.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["ArcMarginProduct", "get_projection"]


def _cosine_logits(embed: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """cos(theta) between the L2-normalized embeddings (B, D) and class
    weights (C, D), in float32."""
    e = F.normalize(embed.float(), dim=-1, eps=1e-12)
    w = F.normalize(weight.float(), dim=-1, eps=1e-12)
    return e @ w.t()


class ArcMarginProduct(nn.Module):
    """AAM-softmax: cos(theta + m) at the target class, with the
    `mmm = 1 + cos(pi - m)` continuity fix where cos(theta) <= cos(pi - m),
    or `easy_margin` (the margin only where cos(theta) > 0)."""

    def __init__(self, embed_dim: int, num_class: int, scale: float = 32.0,
                 easy_margin: bool = False):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_class = num_class
        self.scale = scale
        self.easy_margin = easy_margin
        self.weight = nn.Parameter(torch.empty(num_class, embed_dim))
        nn.init.xavier_uniform_(self.weight)

    def forward(
        self, embed: torch.Tensor, label: torch.Tensor,
        margin: Union[float, torch.Tensor] = 0.0,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cosine = _cosine_logits(embed, self.weight)
        m = torch.as_tensor(margin, dtype=torch.float32, device=cosine.device)
        sine = torch.sqrt(torch.clamp(1.0 - cosine**2, 0.0, 1.0))
        phi = cosine * torch.cos(m) - sine * torch.sin(m)
        if self.easy_margin:
            phi = torch.where(cosine > 0, phi, cosine)
        else:
            th = torch.cos(math.pi - m)
            mmm = 1.0 + torch.cos(math.pi - m)
            phi = torch.where(cosine > th, phi, cosine - mmm)
        one_hot = F.one_hot(label.long(), self.num_class).bool()
        return torch.where(one_hot, phi, cosine) * self.scale, None


def get_projection(conf: dict) -> nn.Module:
    """The head named by `project_type` (conf also holds embed_dim and
    num_class)."""
    ptype = conf.get("project_type", "linear")
    if ptype == "arc_margin":
        return ArcMarginProduct(
            conf["embed_dim"], conf["num_class"], scale=conf.get("scale", 32.0),
            easy_margin=conf.get("easy_margin", False),
        )
    raise NotImplementedError(
        f"projection {ptype!r} is not ported yet (arc_margin is; ROADMAP.md queue 1, item 4)"
    )
