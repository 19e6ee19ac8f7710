"""CAM++: a 2-D convolutional front (FCM) and a densely connected trunk of
context-aware masked TDNN layers, in PyTorch.

Counterpart of `wespeaker_hubert_tpu/models/campplus.py`.  The public
forward takes (B, T, feat_dim) features and an optional (B, T) bool mask, as
the JAX module does; inside, WeSpeaker's layout (reference
wespeaker/models/campplus.py): the FCM frame map is NCHW (B, C, F, T) with
its stride on frequency alone, the trunk (B, C, T).  The parameter names
are WeSpeaker's: `head.conv1`, `head.layer{1,2}.{0,1}.*`, `head.conv2`,
`xvector.tdnn.linear` / `.nonlinear.batchnorm`,
`xvector.block{i}.tdnnd{j}.{nonlinear1.batchnorm, linear1,
nonlinear2.batchnorm, cam_layer.linear_local, cam_layer.linear1,
cam_layer.linear2}`, `xvector.transit{i}.{nonlinear.batchnorm, linear}`,
`xvector.out_nonlinear.batchnorm` and `xvector.dense.{linear,
nonlinear.batchnorm}` (that BatchNorm without affine).  Every 1x1 layer is
a `Conv1d`, as WeSpeaker holds it, where the JAX module has a Dense.  A
pooling with parameters sits under `pool` (WeSpeaker also registers it as
`xvector.stats`; the configs pool with TSTP, which has none).

The FCM map (B, C, F', T) flattens channel-major to (B, C * F', T), as
WeSpeaker's does; the JAX package flattens frequency-major, so the first
TDNN's input channels reach the port permuted (models/convert_jax.py).  That
TDNN halves time (kernel 5, stride 2, pad 2), and the pooling mask follows
as the JAX one does: `mask[:, ::2][:, :T']`.

The context of each CAM layer is the mean over all T frames plus the mean
of the frame's 100-frame segment (the last, partial segment averaging only
its own frames), padded frames included, as in WeSpeaker and JAX.

forward returns the embedding: the dense layer's output through its
affine-free BatchNorm.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .norm import BatchNorm1d, BatchNorm2d
from .pooling import POOLING_LAYERS, pooling_output_dim

__all__ = ["BasicResBlock", "FCM", "CAMLayer", "CAMDenseTDNNLayer", "CAMPPlus",
           "seg_pooling"]

SEG_LEN = 100


def _bn2d(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


def _nonlinear(channels: int, relu: bool = True, affine: bool = True) -> nn.Sequential:
    """WeSpeaker's `get_nonlinear`: 'batchnorm-relu', or 'batchnorm_' (no
    affine, no ReLU)."""
    layers = OrderedDict(batchnorm=BatchNorm1d(channels, eps=1e-5, momentum=0.1, affine=affine))
    if relu:
        layers["relu"] = nn.ReLU()
    return nn.Sequential(layers)


class BasicResBlock(nn.Module):
    """3x3 + 3x3 residual block whose stride applies to frequency only
    (reference campplus.py BasicResBlock)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=(stride, 1), padding=1, bias=False)
        self.bn1 = _bn2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = _bn2d(planes)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != planes:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=(stride, 1), bias=False), _bn2d(planes))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + self.shortcut(x))


class FCM(nn.Module):
    """Front-end conv module: (B, F, T) -> (B, m_channels * ceil(F / 8), T)."""

    def __init__(self, m_channels: int = 32, feat_dim: int = 80):
        super().__init__()
        self.conv1 = nn.Conv2d(1, m_channels, 3, padding=1, bias=False)
        self.bn1 = _bn2d(m_channels)
        self.layer1 = nn.Sequential(BasicResBlock(m_channels, m_channels, 2),
                                    BasicResBlock(m_channels, m_channels, 1))
        self.layer2 = nn.Sequential(BasicResBlock(m_channels, m_channels, 2),
                                    BasicResBlock(m_channels, m_channels, 1))
        self.conv2 = nn.Conv2d(m_channels, m_channels, 3, stride=(2, 1), padding=1, bias=False)
        self.bn2 = _bn2d(m_channels)
        self.out_channels = m_channels * math.ceil(feat_dim / 8)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x.unsqueeze(1))))
        out = self.layer2(self.layer1(out))
        out = F.relu(self.bn2(self.conv2(out)))
        b, c, f, t = out.shape
        return out.reshape(b, c * f, t)


def seg_pooling(x: torch.Tensor, seg_len: int = SEG_LEN) -> torch.Tensor:
    """(B, C, T) -> each frame's segment mean, segments of `seg_len` frames
    from the first (the last, partial one averaging only its own frames, as
    avg_pool1d's ceil mode does).  The frames are summed in t // seg_len + 2
    segments, one or two past the last holding nothing: a count that is
    never 1 lets torch.export keep T symbolic down to one segment."""
    b, c, t = x.shape
    n = t // seg_len + 2
    sums = F.pad(x, (0, n * seg_len - t)).reshape(b, c, n, seg_len).sum(-1)
    counts = torch.clamp(t - torch.arange(n, device=x.device) * seg_len, 1, seg_len)
    return (sums / counts.to(sums.dtype)).repeat_interleave(seg_len, dim=-1)[..., :t]


class CAMLayer(nn.Module):
    """A local conv gated by a context-aware mask (reference CAMLayer)."""

    def __init__(self, bn_channels: int, out_channels: int, kernel_size: int, dilation: int,
                 reduction: int = 2):
        super().__init__()
        pad = (kernel_size - 1) // 2 * dilation
        self.linear_local = nn.Conv1d(bn_channels, out_channels, kernel_size, padding=pad,
                                      dilation=dilation, bias=False)
        self.linear1 = nn.Conv1d(bn_channels, bn_channels // reduction, 1)
        self.linear2 = nn.Conv1d(bn_channels // reduction, out_channels, 1)

    def forward(self, x):
        y = self.linear_local(x)
        context = x.mean(-1, keepdim=True) + seg_pooling(x)
        context = F.relu(self.linear1(context))
        return y * torch.sigmoid(self.linear2(context))


class CAMDenseTDNNLayer(nn.Module):
    """BN-ReLU -> 1x1 bottleneck -> BN-ReLU -> CAM layer."""

    def __init__(self, in_channels: int, out_channels: int, bn_channels: int,
                 kernel_size: int, dilation: int):
        super().__init__()
        self.nonlinear1 = _nonlinear(in_channels)
        self.linear1 = nn.Conv1d(in_channels, bn_channels, 1, bias=False)
        self.nonlinear2 = _nonlinear(bn_channels)
        self.cam_layer = CAMLayer(bn_channels, out_channels, kernel_size, dilation)

    def forward(self, x):
        return self.cam_layer(self.nonlinear2(self.linear1(self.nonlinear1(x))))


class _CAMDenseTDNNBlock(nn.ModuleList):
    """Layers `tdnnd1..N`, each appending its output to the channels."""

    def __init__(self, num_layers: int, in_channels: int, out_channels: int, bn_channels: int,
                 kernel_size: int, dilation: int):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"tdnnd{i + 1}", CAMDenseTDNNLayer(
                in_channels + i * out_channels, out_channels, bn_channels, kernel_size, dilation))

    def forward(self, x):
        for layer in self:
            x = torch.cat([x, layer(x)], dim=1)
        return x


class _TDNNLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.linear = nn.Conv1d(in_channels, out_channels, 5, stride=2, padding=2, bias=False)
        self.nonlinear = _nonlinear(out_channels)

    def forward(self, x):
        return self.nonlinear(self.linear(x))


class _TransitLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.nonlinear = _nonlinear(in_channels)
        self.linear = nn.Conv1d(in_channels, out_channels, 1, bias=False)

    def forward(self, x):
        return self.linear(self.nonlinear(x))


class _DenseLayer(nn.Module):
    """1x1 conv on the pooled vector, then an affine-free BatchNorm."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.linear = nn.Conv1d(in_channels, out_channels, 1, bias=False)
        self.nonlinear = _nonlinear(out_channels, relu=False, affine=False)

    def forward(self, x):
        return self.nonlinear(self.linear(x.unsqueeze(-1)).squeeze(-1))


class CAMPPlus(nn.Module):
    """CAM++ (reference campplus.py CAMPPlus): FCM -> strided TDNN -> 3 dense
    blocks (12 / 24 / 16 layers) with halving transits -> BN-ReLU ->
    pooling -> dense + affine-free BatchNorm."""

    def __init__(self, feat_dim: int = 80, embed_dim: int = 512, pooling_func: str = "TSTP",
                 growth_rate: int = 32, bn_size: int = 4, init_channels: int = 128, **kw):
        super().__init__()
        self.feat_dim = feat_dim
        self.embed_dim = embed_dim
        self.head = FCM(feat_dim=feat_dim)
        xvector = nn.Module()
        xvector.add_module("tdnn", _TDNNLayer(self.head.out_channels, init_channels))
        channels = init_channels
        for i, (num_layers, dilation) in enumerate(zip((12, 24, 16), (1, 2, 2))):
            xvector.add_module(f"block{i + 1}", _CAMDenseTDNNBlock(
                num_layers, channels, growth_rate, bn_size * growth_rate, 3, dilation))
            channels += num_layers * growth_rate
            xvector.add_module(f"transit{i + 1}", _TransitLayer(channels, channels // 2))
            channels //= 2
        xvector.add_module("out_nonlinear", _nonlinear(channels))
        self.pool = POOLING_LAYERS[pooling_func](in_dim=channels)
        xvector.add_module("dense", _DenseLayer(pooling_output_dim(pooling_func, channels),
                                                embed_dim))
        self.xvector = xvector

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        xv = self.xvector
        h = xv.tdnn(self.head(x.transpose(1, 2)))  # (B, T, F) -> (B, F, T)
        for i in (1, 2, 3):
            h = getattr(xv, f"transit{i}")(getattr(xv, f"block{i}")(h))
        h = xv.out_nonlinear(h)
        if mask is not None:
            mask = mask[:, ::2][:, :h.shape[-1]]  # time was strided /2 by the TDNN
        return xv.dense(self.pool(h, mask))
