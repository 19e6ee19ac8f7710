"""Feature pipeline: waveform batch -> CMN'd fbank features (eval).

Counterpart of `wespeaker_hubert_tpu/ops/pipeline.py`.  Only the eval
branch is ported; the training branch (dithered fbank, then SpecAug) is
queued.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .fbank import FbankConfig, fbank
from .feature_utils import apply_cmvn

__all__ = ["FeaturePipelineConfig", "wav_to_features"]


@dataclasses.dataclass(frozen=True)
class FeaturePipelineConfig:
    fbank: FbankConfig = FbankConfig(dither=1.0)
    cmvn_norm_mean: bool = True
    cmvn_norm_var: bool = False
    spec_aug: bool = True
    spec_aug_num_t_mask: int = 1
    spec_aug_num_f_mask: int = 1
    spec_aug_max_t: int = 10
    spec_aug_max_f: int = 8
    spec_aug_prob: float = 0.6


def wav_to_features(
    wav: torch.Tensor,
    cfg: FeaturePipelineConfig,
    lengths: Optional[torch.Tensor] = None,
    train: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(B, W) wav [-1,1] -> ((B, T, M) features, (B, T) bool mask or None).

    Eval only: no dither, no SpecAug, whatever `cfg` says about them.
    """
    if train:
        raise NotImplementedError(
            "the dithered-fbank training branch is not ported yet (ROADMAP.md queue 1a)"
        )
    feats, feat_lengths = fbank(wav, cfg.fbank, lengths=lengths)
    feats = apply_cmvn(
        feats,
        norm_mean=cfg.cmvn_norm_mean,
        norm_var=cfg.cmvn_norm_var,
        lengths=feat_lengths,
    )
    mask = None
    if feat_lengths is not None:
        t = feats.shape[1]
        mask = (
            torch.arange(t, device=feats.device)[None, :]
            < feat_lengths[:, None]
        )
    return feats, mask
