"""ECAPA-TDNN speaker-embedding backbone in PyTorch.

Counterpart of `wespeaker_hubert_tpu/models/ecapa_tdnn.py`.  The public
forward takes (B, T, feat_dim) features and an optional (B, T) bool mask,
as the JAX module does; inside, activations are channels-first (B, C, T)
for `Conv1d`.  Parameter names and shapes are WeSpeaker's ECAPA_TDNN
(reference wespeaker/models/ecapa_tdnn.py), so its checkpoints load as they
are: `layer1.conv/bn`, `layerN.se_res2block.{0,1,2,3}` with
`.1.convs.i` / `.1.bns.i` and `.3.linear1/2`, `conv`, `pool.linear1/2`,
`bn`, `linear` and, with `emb_bn`, `bn2`.

BatchNorm is `models/norm.py:BatchNorm1d(eps=1e-5, momentum=0.1)`: torch's
momentum is the weight of the new batch, so it is flax's `momentum=0.9`, and
in train mode the running variance takes the biased batch variance, as
flax's does.  In eval it is torch's BatchNorm1d and returns the input dtype,
as the JAX package's dtype-preserving BatchNorm.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .norm import BatchNorm1d
from .pooling import POOLING_LAYERS, pooling_output_dim

__all__ = [
    "ConvReluBn",
    "Res2ConvReluBn",
    "SEConnect",
    "SERes2Block",
    "EcapaTdnn",
    "ECAPA_TDNN_c512",
    "ECAPA_TDNN_GLOB_c512",
    "ECAPA_TDNN_c1024",
    "ECAPA_TDNN_GLOB_c1024",
]


def _bn(channels: int) -> BatchNorm1d:
    return BatchNorm1d(channels, eps=1e-5, momentum=0.1)


class ConvReluBn(nn.Module):
    """Conv1d -> ReLU -> BN (reference Conv1dReluBn)."""

    def __init__(self, in_channels, channels, kernel_size=1, dilation=1):
        super().__init__()
        pad = (kernel_size - 1) // 2 * dilation
        self.conv = nn.Conv1d(
            in_channels, channels, kernel_size, padding=pad, dilation=dilation
        )
        self.bn = _bn(channels)

    def forward(self, x):
        return self.bn(F.relu(self.conv(x)))


class Res2ConvReluBn(nn.Module):
    """Res2Net-style hierarchical conv (reference Res2Conv1dReluBn): split
    C into `scale` groups; group i (1 <= i < scale-1) convolves
    spx[i] + the previous output; the last group passes through."""

    def __init__(self, channels, kernel_size=3, dilation=1, scale=8):
        super().__init__()
        assert channels % scale == 0
        self.scale = scale
        self.width = channels // scale
        nums = scale if scale == 1 else scale - 1
        pad = (kernel_size - 1) // 2 * dilation
        self.convs = nn.ModuleList(
            nn.Conv1d(
                self.width, self.width, kernel_size, padding=pad,
                dilation=dilation,
            )
            for _ in range(nums)
        )
        self.bns = nn.ModuleList(_bn(self.width) for _ in range(nums))

    def forward(self, x):
        spx = torch.split(x, self.width, dim=1)
        out = []
        sp = spx[0]
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            if i >= 1:
                sp = sp + spx[i]
            sp = bn(F.relu(conv(sp)))
            out.append(sp)
        if self.scale != 1:
            out.append(spx[self.scale - 1])
        return torch.cat(out, dim=1)


class SEConnect(nn.Module):
    """Squeeze-excitation over (masked) time (reference SE_Connect)."""

    def __init__(self, channels, se_bottleneck_dim=128):
        super().__init__()
        self.linear1 = nn.Linear(channels, se_bottleneck_dim)
        self.linear2 = nn.Linear(se_bottleneck_dim, channels)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        if mask is None:
            s = x.mean(dim=2)
        else:
            m = mask[:, None, :].to(x.dtype)
            s = (x * m).sum(dim=2) / torch.clamp_min(m.sum(dim=2), 1.0)
        s = F.relu(self.linear1(s))
        s = torch.sigmoid(self.linear2(s))
        return x * s[:, :, None]


class SERes2Block(nn.Module):
    """conv1x1 -> res2conv -> conv1x1 -> SE, residual add (reference
    SE_Res2Block; its `se_res2block` Sequential is a ModuleList here so the
    SE stage can take the mask)."""

    def __init__(self, channels, kernel_size=3, dilation=2, scale=8):
        super().__init__()
        self.se_res2block = nn.ModuleList([
            ConvReluBn(channels, channels, 1),
            Res2ConvReluBn(channels, kernel_size, dilation, scale),
            ConvReluBn(channels, channels, 1),
            SEConnect(channels),
        ])

    def forward(self, x, mask=None):
        conv1, res2, conv2, se = self.se_res2block
        return x + se(conv2(res2(conv1(x))), mask)


class EcapaTdnn(nn.Module):
    """ECAPA-TDNN: (B, T, feat_dim) features -> (B, embed_dim) embedding."""

    def __init__(
        self,
        channels: int = 512,
        feat_dim: int = 80,
        embed_dim: int = 192,
        pooling_func: str = "ASTP",
        global_context_att: bool = False,
        emb_bn: bool = False,
    ):
        super().__init__()
        self.embed_dim = embed_dim
        self.layer1 = ConvReluBn(feat_dim, channels, 5)
        self.layer2 = SERes2Block(channels, 3, 2, 8)
        self.layer3 = SERes2Block(channels, 3, 3, 8)
        self.layer4 = SERes2Block(channels, 3, 4, 8)
        self.conv = nn.Conv1d(channels * 3, 512 * 3, kernel_size=1)
        kwargs = {}
        if pooling_func == "ASTP":
            kwargs["global_context_att"] = global_context_att
        self.pool = POOLING_LAYERS[pooling_func](in_dim=512 * 3, **kwargs)
        pool_dim = pooling_output_dim(pooling_func, 512 * 3)
        self.bn = _bn(pool_dim)
        self.linear = nn.Linear(pool_dim, embed_dim)
        self.bn2 = _bn(embed_dim) if emb_bn else None

    def _frame_level(self, x, mask):
        out1 = self.layer1(x.transpose(1, 2))
        out2 = self.layer2(out1, mask)
        out3 = self.layer3(out2, mask)
        out4 = self.layer4(out3, mask)
        return self.conv(torch.cat([out2, out3, out4], dim=1))

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        out = F.relu(self._frame_level(x, mask))
        out = self.bn(self.pool(out, mask))
        out = self.linear(out)
        if self.bn2 is not None:
            out = self.bn2(out)
        return out


def ECAPA_TDNN_c512(feat_dim, embed_dim, pooling_func="ASTP", emb_bn=False, **kw):
    return EcapaTdnn(512, feat_dim, embed_dim, pooling_func, False, emb_bn)


def ECAPA_TDNN_GLOB_c512(feat_dim, embed_dim, pooling_func="ASTP", emb_bn=False, **kw):
    return EcapaTdnn(512, feat_dim, embed_dim, pooling_func, True, emb_bn)


def ECAPA_TDNN_c1024(feat_dim, embed_dim, pooling_func="ASTP", emb_bn=False, **kw):
    return EcapaTdnn(1024, feat_dim, embed_dim, pooling_func, False, emb_bn)


def ECAPA_TDNN_GLOB_c1024(feat_dim, embed_dim, pooling_func="ASTP", emb_bn=False, **kw):
    return EcapaTdnn(1024, feat_dim, embed_dim, pooling_func, True, emb_bn)
