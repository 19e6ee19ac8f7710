"""ReDimNet in PyTorch: 2-D conv stages and 1-D time-context blocks over
one (C x F) axis, with softmax-mixed stage inputs.

Counterpart of `wespeaker_hubert_tpu/models/redimnet.py`, in WeSpeaker's
names (reference wespeaker/models/redimnet.py): `backbone.stem` (3x3 conv,
channels-first LayerNorm), `backbone.inputs_weights.{0..n}` (the stage-0
weight a frozen all-ones (1, 1, 1, 1), the others (1, i + 1, C F, 1) from
zeros), `backbone.stage{i}` Sequentials (the (stride, 1) frequency
downsampling conv; the ConvBlock2d blocks, each with its `conv_block`; the
`conv_exp` squeeze: 3x3 grouped conv, BatchNorm (eps 1e-6), GELU, 1x1; the
parameterless to1d; the TimeContextBlock1d), then `pool` (ASTP with global
context) and `seg_1`.  The JAX module's `out_channels` (an `mfa` layer
before the pooling) and `global_context_att=False` are set by no factory
and are not ported.

The 2-D maps are NCHW (B, C, F, T).  The 1-D axis orders f * C + c, the
reference's (b, c, f, t) -> (b, f, c, t) -> (b, f c, t), which is the JAX
package's own (B, T, F, C) flatten, so no weight needs a permutation.  A
stage's input is the per-(source, channel) softmax over sources, in
float32, of every earlier stage's 1-D output.  The LayerNorms use eps 1e-6,
the stem's over the channels alone.  The transformer is post-LN with a
tanh-GELU FFN, and its attention is plain softmax(q k^T hd^-1/2) v in
float32 (the JAX package computes it outside any Pallas kernel); the other
GELUs are erf unless `gelu_impl` is "tanh".  No layer sees the mask but the
pooling's, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .norm import BatchNorm1d, BatchNorm2d, LayerNorm, upcast
from .pooling import POOLING_LAYERS, pooling_output_dim

__all__ = [
    "ConvNeXtLikeBlock", "fwSEBlock", "ResBasicBlock", "TransformerEncoderLayer",
    "PosEncConv", "TimeContextBlock1d", "ReDimNet",
    "ReDimNetB0", "ReDimNetB1", "ReDimNetB2", "ReDimNetB3", "ReDimNetB4", "ReDimNetB5",
    "ReDimNetB6",
]


def _gelu(x: torch.Tensor, impl: str) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if impl == "tanh" else "none")


def _groups(c: int, gd: Optional[int]) -> int:
    if gd is None:
        return 1
    g = max(c // gd, 1)
    while c % g:
        g -= 1
    return g


class ChannelsFirstLayerNorm(nn.Module):
    """LayerNorm over dim 1 of (B, C, ...) with float32 statistics
    (WeSpeaker's channels-first LayerNorm; `weight` / `bias` of shape (C,))."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x):
        y = F.layer_norm(upcast(x).movedim(1, -1), self.weight.shape, upcast(self.weight),
                         upcast(self.bias), self.eps)
        return y.movedim(-1, 1).to(x.dtype)


def _conv(dim: int, *args, **kw):
    return (nn.Conv1d if dim == 1 else nn.Conv2d)(*args, **kw)


def _bn(dim: int, channels: int, eps: float = 1e-5):
    return (BatchNorm1d if dim == 1 else BatchNorm2d)(channels, eps=eps, momentum=0.1)


class ConvNeXtLikeBlock(nn.Module):
    """Grouped conv(s) -> BatchNorm -> GELU -> 1x1, residual; `dim` 2 over
    (B, C, F, T), 1 over (B, C, T)."""

    def __init__(self, C: int, dim: int = 2, kernel_sizes: Sequence = ((3, 3),),
                 group_divisor: Optional[int] = 1, gelu_impl: str = "erf"):
        super().__init__()
        self.gelu_impl = gelu_impl
        convs = []
        for ks in kernel_sizes:
            ks = (ks,) if isinstance(ks, int) else tuple(ks)
            convs.append(_conv(dim, C, C, ks[::-1] if dim == 2 else ks,
                               padding=tuple(k // 2 for k in ks[::-1]),
                               groups=_groups(C, group_divisor)))
        self.dwconvs = nn.ModuleList(convs)
        self.norm = _bn(dim, C * len(kernel_sizes))
        self.pwconv1 = _conv(dim, C * len(kernel_sizes), C, 1)

    def forward(self, x):
        h = torch.cat([conv(x) for conv in self.dwconvs], dim=1)
        return x + self.pwconv1(_gelu(self.norm(h), self.gelu_impl))


class fwSEBlock(nn.Module):
    """Frequency-wise squeeze-excitation over (B, C, F, T): squeeze over
    (C, T)."""

    def __init__(self, num_freq: int, num_feats: int = 64):
        super().__init__()
        self.squeeze = nn.Linear(num_freq, num_feats)
        self.exitation = nn.Linear(num_feats, num_freq)

    def forward(self, x):
        s = torch.sigmoid(self.exitation(F.relu(self.squeeze(x.mean(dim=(1, 3))))))
        return x * s[:, None, :, None]


class ResBasicBlock(nn.Module):
    """Grouped 3x3 + pointwise (or a dense 3x3 without `group_divisor`) ->
    ReLU -> BN, twice (no ReLU before the second BN), the optional fwSE, the
    shortcut, ReLU."""

    def __init__(self, in_planes: int, planes: int, num_freq: int,
                 group_divisor: Optional[int] = 4, use_fwse: bool = False,
                 se_channels: int = 64):
        super().__init__()
        self.grouped = group_divisor is not None
        if self.grouped:
            self.conv1 = nn.Conv2d(in_planes, in_planes, 3, padding=1, bias=False,
                                   groups=_groups(in_planes, group_divisor))
            self.conv1pw = nn.Conv2d(in_planes, planes, 1)
            self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False,
                                   groups=_groups(planes, group_divisor))
            self.conv2pw = nn.Conv2d(planes, planes, 1)
        else:
            self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1, bias=False)
            self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn1 = _bn(2, planes)
        self.bn2 = _bn(2, planes)
        self.se = fwSEBlock(num_freq, se_channels) if use_fwse else None
        self.downsample = None
        if planes != in_planes:
            self.downsample = nn.Sequential(nn.Conv2d(in_planes, planes, 1, bias=False),
                                            _bn(2, planes))

    def forward(self, x):
        h = self.conv1(x)
        if self.grouped:
            h = self.conv1pw(h)
        h = self.bn1(F.relu(h))
        h = self.conv2(h)
        if self.grouped:
            h = self.conv2pw(h)
        h = self.bn2(h)
        if self.se is not None:
            h = self.se(h)
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class ConvBlock2d(nn.Module):
    """The reference's wrapper of a 2-D block (its parameters under
    `conv_block.`)."""

    def __init__(self, c: int, f: int, block_type: str, group_divisor: Optional[int],
                 gelu_impl: str):
        super().__init__()
        if block_type == "convnext_like":
            self.conv_block = ConvNeXtLikeBlock(c, 2, ((3, 3),), group_divisor, gelu_impl)
        elif block_type in ("basic_resnet", "basic_resnet_fwse"):
            self.conv_block = ResBasicBlock(c, c, f, group_divisor,
                                            block_type == "basic_resnet_fwse",
                                            min(64, max(c, 32)))
        else:
            raise NotImplementedError(f"block_2d_type {block_type!r}")

    def forward(self, x):
        return self.conv_block(x)


class MultiHeadAttention(nn.Module):
    """Plain multi-head attention over (B, T, D), the softmax in float32."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, x):
        b, t, d = x.shape
        hd = d // self.num_heads
        q, k, v = (proj(x).view(b, t, self.num_heads, hd)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        w = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd**-0.5
        w = torch.softmax(upcast(w), dim=-1).to(v.dtype)
        return self.out_proj(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, t, d))


class FeedForward(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(hidden_size, intermediate_size)
        self.output_dense = nn.Linear(intermediate_size, hidden_size)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x), approximate="tanh"))


class TransformerEncoderLayer(nn.Module):
    """Post-LN transformer layer over channels-first (B, D, T)."""

    def __init__(self, n_state: int, n_mlp: int, n_head: int = 4):
        super().__init__()
        self.attention = MultiHeadAttention(n_state, n_head)
        self.layer_norm = LayerNorm(n_state, eps=1e-6)
        self.feed_forward = FeedForward(n_state, n_mlp)
        self.final_layer_norm = LayerNorm(n_state, eps=1e-6)

    def forward(self, x):
        h = x.transpose(1, 2)
        h = self.layer_norm(h + self.attention(h))
        h = self.final_layer_norm(h + self.feed_forward(h))
        return h.transpose(1, 2)


class PosEncConv(nn.Module):
    """Depthwise conv positional encoding with a channels-first LayerNorm,
    residual."""

    def __init__(self, C: int, ks: int):
        super().__init__()
        self.conv = nn.Conv1d(C, C, ks, padding=ks // 2, groups=C)
        self.norm = ChannelsFirstLayerNorm(C, eps=1e-6)

    def forward(self, x):
        return x + self.norm(self.conv(x))


class TimeContextBlock1d(nn.Module):
    """1x1 reduce (+ LayerNorm) -> time-context module -> 1x1 expand,
    residual; `conv+att` (every factory's): four depthwise ConvNeXt blocks
    (kernels 7, 19, 31, 59) and a transformer layer."""

    def __init__(self, C: int, hC: int, block_type: str = "conv+att", pos_ker_sz: int = 59,
                 gelu_impl: str = "erf"):
        super().__init__()
        self.red_dim_conv = nn.Sequential(nn.Conv1d(C, hC, 1),
                                          ChannelsFirstLayerNorm(hC, eps=1e-6))
        if block_type == "conv+att":
            self.tcm = nn.Sequential(
                *[ConvNeXtLikeBlock(hC, 1, (ks,), 1, gelu_impl) for ks in (7, 19, 31, 59)],
                TransformerEncoderLayer(hC, hC, 4))
        elif block_type == "att":
            self.tcm = nn.Sequential(PosEncConv(hC, pos_ker_sz),
                                     TransformerEncoderLayer(hC, hC * 2, 4))
        else:  # "fc" and "gru" have no factory and are not ported
            raise NotImplementedError(f"block_1d_type {block_type!r} is not ported")
        self.exp_dim_conv = nn.Conv1d(hC, C, 1)

    def forward(self, x):
        return x + self.exp_dim_conv(self.tcm(self.red_dim_conv(x)))


def _to1d(x: torch.Tensor) -> torch.Tensor:
    """(B, C, F, T) -> (B, F C, T), the axis ordered f * C + c."""
    b, c, f, t = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, f * c, t)


class To1d(nn.Module):
    """_to1d as the parameterless layer of a stage's Sequential."""

    def forward(self, x):
        return _to1d(x)


def _to2d(x: torch.Tensor, c: int, f: int) -> torch.Tensor:
    b, _, t = x.shape
    return x.reshape(b, f, c, t).permute(0, 2, 1, 3)


class ReDimNetBone(nn.Module):
    def __init__(self, F_: int, C: int, block_1d_type: str, block_2d_type: str,
                 stages_setup: Sequence, group_divisor: Optional[int], gelu_impl: str):
        super().__init__()
        self.C, self.F, self.gelu_impl = C, F_, gelu_impl
        self.stem = nn.Sequential(nn.Conv2d(1, C, 3, padding=1),
                                  ChannelsFirstLayerNorm(C, eps=1e-6))
        cf = C * F_
        self.inputs_weights = nn.ParameterList(
            [nn.Parameter(torch.ones(1, 1, 1, 1), requires_grad=False)]
            + [nn.Parameter(torch.zeros(1, n + 1, cf, 1)) for n in range(1, len(stages_setup) + 1)])
        self.shapes = []  # (channels, frequency rows) of each stage's input
        c, f = C, F_
        for si, (stride, num_blocks, conv_exp, _ks, att_red) in enumerate(stages_setup):
            self.shapes.append((c, f))
            layers = [nn.Conv2d(c, int(stride * c * conv_exp), (stride, 1), stride=(stride, 1))]
            c, f = stride * c, f // stride
            layers += [ConvBlock2d(int(c * conv_exp), f, block_2d_type, group_divisor, gelu_impl)
                       for _ in range(num_blocks)]
            if conv_exp != 1:
                layers.append(nn.Sequential(
                    nn.Conv2d(int(c * conv_exp), c, 3, padding=1,
                              groups=_groups(c, group_divisor)),
                    _bn(2, c, eps=1e-6), nn.GELU("tanh" if gelu_impl == "tanh" else "none"),
                    nn.Conv2d(c, c, 1)))
            layers.append(To1d())
            if att_red is not None:
                layers.append(TimeContextBlock1d(cf, cf // att_red, block_1d_type,
                                                 gelu_impl=gelu_impl))
            setattr(self, f"stage{si}", nn.Sequential(*layers))
        self.n_stages = len(stages_setup)

    @staticmethod
    def _mix(w: torch.Tensor, outs):
        """The softmax over sources of `w` (1, n, CF, 1), in float32, weighting
        the n stage outputs (B, CF, T)."""
        wn = torch.softmax(upcast(w), dim=1)
        acc = upcast(outs[0]) * wn[:, 0]
        for i in range(1, len(outs)):
            acc = acc + upcast(outs[i]) * wn[:, i]
        return acc.to(outs[0].dtype)

    def forward(self, x):  # (B, 1, F, T)
        outs = [_to1d(self.stem(x))]
        for si in range(self.n_stages):
            z = outs[0] if si == 0 else self._mix(self.inputs_weights[si], outs)
            outs.append(getattr(self, f"stage{si}")(_to2d(z, *self.shapes[si])))
        return self._mix(self.inputs_weights[self.n_stages], outs)


class ReDimNet(nn.Module):
    """(B, T, feat_dim) features -> (embed_a, embed_b) with `two_emb_layer`,
    else (0-d zero, embed_a)."""

    def __init__(self, feat_dim: int = 72, C: int = 16, block_1d_type: str = "conv+att",
                 block_2d_type: str = "basic_resnet",
                 stages_setup: Sequence[Tuple] = (
                     (1, 2, 1, ((3, 3),), 12), (2, 2, 1, ((3, 3),), 12),
                     (1, 3, 1, ((3, 3),), 12), (2, 4, 1, ((3, 3),), 8),
                     (1, 4, 1, ((3, 3),), 8), (2, 4, 1, ((3, 3),), 4)),
                 group_divisor: Optional[int] = 4, embed_dim: int = 192,
                 pooling_func: str = "ASTP", two_emb_layer: bool = False,
                 gelu_impl: str = "erf"):
        super().__init__()
        self.feat_dim = feat_dim
        self.embed_dim = embed_dim
        self.two_emb_layer = two_emb_layer
        self.backbone = ReDimNetBone(feat_dim, C, block_1d_type, block_2d_type, stages_setup,
                                     group_divisor, gelu_impl)
        out_dim = C * feat_dim
        kwargs = {"global_context_att": True} if pooling_func == "ASTP" else {}
        self.pool = POOLING_LAYERS[pooling_func](in_dim=out_dim, **kwargs)
        self.seg_1 = nn.Linear(pooling_output_dim(pooling_func, out_dim), embed_dim)
        if two_emb_layer:
            self.seg_bn_1 = BatchNorm1d(embed_dim, eps=1e-5, momentum=0.1, affine=False)
            self.seg_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        feat = self.backbone(x.transpose(1, 2).unsqueeze(1))
        embed_a = self.seg_1(self.pool(feat, mask))
        if self.two_emb_layer:
            return embed_a, self.seg_2(self.seg_bn_1(F.relu(embed_a)))
        return embed_a.new_zeros(()), embed_a


def _mk(C, b2, setup, gd):
    def make(feat_dim=72, embed_dim=192, pooling_func="ASTP", two_emb_layer=False,
             gelu_impl="erf", **kw):
        return ReDimNet(feat_dim=feat_dim, C=C, block_1d_type="conv+att", block_2d_type=b2,
                        stages_setup=setup, group_divisor=gd, embed_dim=embed_dim,
                        pooling_func=pooling_func, two_emb_layer=two_emb_layer,
                        gelu_impl=gelu_impl)

    return make


ReDimNetB0 = _mk(
    10, "basic_resnet",
    ((1, 2, 1, ((3, 3),), 30), (2, 3, 2, ((3, 3),), 30), (1, 3, 3, ((3, 3),), 30),
     (2, 4, 2, ((3, 3),), 10), (1, 3, 1, ((3, 3),), 10)),
    1)
ReDimNetB1 = _mk(
    12, "convnext_like",
    ((1, 2, 1, ((3, 3),), None), (2, 3, 1, ((3, 3),), None), (3, 4, 1, ((3, 3),), 12),
     (2, 5, 1, ((3, 3),), 12), (2, 3, 1, ((3, 3),), 8)),
    8)
ReDimNetB2 = _mk(
    16, "convnext_like",
    ((1, 2, 1, ((3, 3),), 12), (2, 2, 1, ((3, 3),), 12), (1, 3, 1, ((3, 3),), 12),
     (2, 4, 1, ((3, 3),), 8), (1, 4, 1, ((3, 3),), 8), (2, 4, 1, ((3, 3),), 4)),
    4)
ReDimNetB3 = _mk(
    16, "basic_resnet_fwse",
    ((1, 6, 4, ((3, 3),), 32), (2, 6, 2, ((3, 3),), 32), (1, 8, 2, ((3, 3),), 32),
     (2, 10, 2, ((3, 3),), 16), (1, 10, 1, ((3, 3),), 16), (2, 8, 1, ((3, 3),), 16)),
    1)
ReDimNetB4 = _mk(
    32, "basic_resnet_fwse",
    ((1, 4, 2, ((3, 3),), 48), (2, 4, 2, ((3, 3),), 48), (1, 6, 2, ((3, 3),), 48),
     (2, 6, 1, ((3, 3),), 32), (1, 8, 1, ((3, 3),), 24), (2, 4, 1, ((3, 3),), 16)),
    1)
ReDimNetB5 = _mk(
    32, "basic_resnet_fwse",
    ((1, 4, 2, ((3, 3),), 48), (2, 4, 2, ((3, 3),), 48), (1, 6, 2, ((3, 3),), 48),
     (2, 6, 1, ((3, 3),), 32), (1, 8, 1, ((3, 3),), 24), (2, 4, 1, ((3, 3),), 16)),
    16)
ReDimNetB6 = _mk(
    32, "basic_resnet",
    ((1, 4, 4, ((3, 3),), 32), (2, 6, 2, ((3, 3),), 32), (1, 6, 2, ((3, 3),), 24),
     (3, 8, 1, ((3, 3),), 24), (1, 8, 1, ((3, 3),), 16), (2, 8, 1, ((3, 3),), 16)),
    32)
