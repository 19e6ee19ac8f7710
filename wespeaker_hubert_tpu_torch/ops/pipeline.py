"""Feature pipeline: waveform batch -> fbank -> CMVN (-> SpecAug in training).

Counterpart of `wespeaker_hubert_tpu/ops/pipeline.py`.  The eval branch is
dither-free fbank (the CUDA kernel K1 on a CUDA batch) and CMVN.  The train
branch splits the step's generator in two, as the JAX function splits its
key: one stream dithers the frames (a dithered fbank takes the plain path,
as in JAX's `ops/fbank.py`; a dither of 0 goes through K1 on the card),
the other draws SpecAugment's masks after CMVN.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .fbank import FbankConfig, fbank
from .feature_utils import apply_cmvn, spec_aug

__all__ = ["FeaturePipelineConfig", "wav_to_features", "split_generator"]


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


def split_generator(generator: torch.Generator) -> Tuple[torch.Generator, torch.Generator]:
    """Two generators on `generator`'s device, seeded from its seed alone
    (no draw, no device synchronization): the same seed gives the same
    streams, and one stream's draws do not shift the other's."""
    base = generator.initial_seed()
    out = []
    for k in (1, 2):
        g = torch.Generator(device=generator.device)
        g.manual_seed((base * 1000003 + 7919 * k) % (1 << 63))
        out.append(g)
    return out[0], out[1]


def wav_to_features(
    wav: torch.Tensor,
    cfg: FeaturePipelineConfig,
    lengths: Optional[torch.Tensor] = None,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(B, W) wav [-1,1] -> ((B, T, M) features, (B, T) bool mask or None).

    Dither and SpecAug apply only when `train` is set and a `generator` (on
    wav's device) is given; eval takes neither, whatever `cfg` says.
    """
    gen_dither = gen_spec = None
    if train and generator is not None:
        gen_dither, gen_spec = split_generator(generator)
    feats, feat_lengths = fbank(wav, cfg.fbank, generator=gen_dither, lengths=lengths)
    feats = apply_cmvn(
        feats,
        norm_mean=cfg.cmvn_norm_mean,
        norm_var=cfg.cmvn_norm_var,
        lengths=feat_lengths,
    )
    if cfg.spec_aug and gen_spec is not None:
        feats = spec_aug(
            feats, gen_spec, num_t_mask=cfg.spec_aug_num_t_mask,
            num_f_mask=cfg.spec_aug_num_f_mask, max_t=cfg.spec_aug_max_t,
            max_f=cfg.spec_aug_max_f, prob=cfg.spec_aug_prob,
        )
    mask = None
    if feat_lengths is not None:
        t = feats.shape[1]
        mask = (
            torch.arange(t, device=feats.device)[None, :]
            < feat_lengths[:, None]
        )
    return feats, mask
