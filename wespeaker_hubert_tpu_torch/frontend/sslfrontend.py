"""SSL frontend with a layer-weighted featurizer (s3prl-equivalent).

Counterpart of `wespeaker_hubert_tpu/frontend/sslfrontend.py`: an upstream
encoder (WavLM / HuBERT / wav2vec2) whose 1 + N hidden states are mixed with
learned softmax weights (`featurizer_weights`), or one state selected by
`layer`.  `frozen` runs the upstream outside autograd (the featurizer
weights still train; bin/train also turns the upstream's `requires_grad`
off); `frozen=False` trains it, joint fine-tuning.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from .ssl_encoder import SSLEncoder, SSLEncoderConfig

__all__ = ["SSLFrontend"]


class SSLFrontend(nn.Module):
    """`layer` >= 0 selects a single hidden state; `multilayer_feature=False`
    uses only the last state; the default is the learned weighted mix of
    all of them."""

    def __init__(
        self,
        cfg: SSLEncoderConfig,
        frozen: bool = True,
        layer: int = -1,
        multilayer_feature: bool = True,
    ):
        super().__init__()
        self.cfg = cfg
        self.frozen = frozen
        self.layer = layer
        self.multilayer_feature = multilayer_feature
        self.upstream = SSLEncoder(cfg)
        n_states = cfg.num_hidden_layers + 1
        if layer >= n_states:
            raise ValueError(
                f"s3prl_args.layer={layer} out of range: upstream has "
                f"{n_states} hidden states (0..{n_states - 1})"
            )
        self.featurizer_weights = None
        if layer < 0:
            n = n_states if multilayer_feature else 1
            self.featurizer_weights = nn.Parameter(torch.zeros(n))

    @property
    def output_size(self) -> int:
        return self.cfg.hidden_size

    def forward(
        self, wav: torch.Tensor, lengths: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(B, W) raw wav [-1, 1] -> ((B, T, hidden) features, (B,) valid
        frames or None)."""
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.frozen):
            hidden_states, feat_lengths = self.upstream(wav, lengths=lengths)
        if self.layer >= 0:
            return hidden_states[self.layer], feat_lengths
        if not self.multilayer_feature:
            hidden_states = hidden_states[-1:]
        dt = hidden_states[0].dtype
        # the weights rounded to the hidden dtype, the sum in float32, the
        # result back in the hidden dtype (bf16 stays bf16 downstream)
        w = torch.softmax(self.featurizer_weights.float(), dim=0).to(dt).float()
        feats = w[0] * hidden_states[0].float()
        for i in range(1, len(hidden_states)):
            feats = feats + w[i] * hidden_states[i].float()
        return feats.to(dt), feat_lengths
