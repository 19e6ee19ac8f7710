"""Kaldi-style TDNN x-vector in PyTorch.

Counterpart of `wespeaker_hubert_tpu/models/tdnn.py` (TdnnLayer, XVEC), in
WeSpeaker's names (reference wespeaker/models/tdnn.py): `frame_{1..5}` each
a `conv_1d` (Conv1d) and an affine-free `bn`, the pooling `pool`, `seg_1`,
the affine-free `seg_bn_1` and `seg_2`.  The context convs are VALID, so T
shrinks by (5-1) + 2 (3-1) + 3 (3-1) = 14 frames; the pooling mask drops its
*first* 14 entries, as the JAX module does, although the frames the convs
lose lie at both ends.  forward returns (embed_a, embed_b); the embedding
is embed_b.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .norm import BatchNorm1d
from .pooling import POOLING_LAYERS, pooling_output_dim

__all__ = ["TdnnLayer", "XVEC", "XVEC_factory"]


class TdnnLayer(nn.Module):
    """VALID dilated Conv1d -> ReLU -> affine-free BatchNorm."""

    def __init__(self, in_dim: int, out_dim: int, context_size: int, dilation: int = 1):
        super().__init__()
        self.conv_1d = nn.Conv1d(in_dim, out_dim, context_size, dilation=dilation)
        self.bn = BatchNorm1d(out_dim, eps=1e-5, momentum=0.1, affine=False)

    def forward(self, x):
        return self.bn(F.relu(self.conv_1d(x)))


class XVEC(nn.Module):
    """X-vector network: (B, T, feat_dim) features -> (embed_a, embed_b)."""

    def __init__(self, feat_dim: int = 40, hid_dim: int = 512, stats_dim: int = 1500,
                 embed_dim: int = 512, pooling_func: str = "TSTP"):
        super().__init__()
        self.feat_dim = feat_dim
        self.embed_dim = embed_dim
        self.frame_1 = TdnnLayer(feat_dim, hid_dim, 5, 1)
        self.frame_2 = TdnnLayer(hid_dim, hid_dim, 3, 2)
        self.frame_3 = TdnnLayer(hid_dim, hid_dim, 3, 3)
        self.frame_4 = TdnnLayer(hid_dim, hid_dim, 1, 1)
        self.frame_5 = TdnnLayer(hid_dim, stats_dim, 1, 1)
        self.pool = POOLING_LAYERS[pooling_func](in_dim=stats_dim)
        self.seg_1 = nn.Linear(pooling_output_dim(pooling_func, stats_dim), embed_dim)
        self.seg_bn_1 = BatchNorm1d(embed_dim, eps=1e-5, momentum=0.1, affine=False)
        self.seg_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        out = x.transpose(1, 2)
        for layer in (self.frame_1, self.frame_2, self.frame_3, self.frame_4, self.frame_5):
            out = layer(out)
        if mask is not None:
            mask = mask[:, x.shape[1] - out.shape[2]:]  # the first 14, as JAX drops them
        embed_a = self.seg_1(self.pool(out, mask))
        return embed_a, self.seg_2(self.seg_bn_1(F.relu(embed_a)))


def XVEC_factory(feat_dim, embed_dim, pooling_func="TSTP", **kw):
    return XVEC(feat_dim=feat_dim, embed_dim=embed_dim, pooling_func=pooling_func)
