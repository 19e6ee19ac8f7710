"""Whisper-PMFA: the pooling head over Whisper-encoder features.

Counterpart of `wespeaker_hubert_tpu/models/whisper_pmfa.py`: ASTP with
global context over the concatenated Whisper layers (frontend/whisper.py),
BatchNorm over the pooled statistics (models/norm.py's, flax's train mode),
then a Linear to the embedding.  Names are the reference's
(`pooling.linear1`, `pooling.linear2`, `bn.norm.*`, `fc`), which the JAX
package's `models/convert_torch.py:whisper_pmfa_from_torch` reads.  The
module takes (B, T, D) features and an optional (B, T) validity mask.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .norm import BatchNorm1d
from .pooling import POOLING_LAYERS, pooling_output_dim

__all__ = ["WhisperPMFA", "whisper_PMFA", "whisper_PMFA_large_v2"]


class _StatsNorm(nn.Module):
    """BatchNorm over the pooled statistics, under the reference's `bn.norm`."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = BatchNorm1d(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)


class WhisperPMFA(nn.Module):
    def __init__(self, output_size: int = 1280, embed_dim: int = 192,
                 pooling_func: str = "ASTP", global_context_att: bool = True):
        super().__init__()
        kwargs = {"global_context_att": global_context_att} if pooling_func == "ASTP" else {}
        self.pooling = POOLING_LAYERS[pooling_func](in_dim=output_size, **kwargs)
        stats_dim = pooling_output_dim(pooling_func, output_size)
        self.bn = _StatsNorm(stats_dim)
        self.fc = nn.Linear(stats_dim, embed_dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        stats = self.pooling(x.transpose(1, 2), mask=mask)
        return self.fc(self.bn(stats))


def whisper_PMFA(feat_dim, embed_dim, **kw):
    """The generic head; its width follows the frontend's `feat_dim`."""
    return WhisperPMFA(output_size=feat_dim, embed_dim=embed_dim)


def whisper_PMFA_large_v2(feat_dim, embed_dim, **kw):
    return WhisperPMFA(output_size=feat_dim, embed_dim=embed_dim)
