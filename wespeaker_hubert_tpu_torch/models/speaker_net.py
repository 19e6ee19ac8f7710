"""SpeakerNet: the backbone behind one embedding entry point.

Counterpart of `wespeaker_hubert_tpu/models/speaker_net.py`.  The
margin-softmax projection and the SSL / Whisper frontends are not ported
yet, so `embed` is the whole module.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .registry import embedding_from_outputs, get_speaker_model

__all__ = ["SpeakerNet", "build_speaker_net"]


class SpeakerNet(nn.Module):
    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.backbone = backbone

    def embed(
        self, feats: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        return embedding_from_outputs(self.backbone(feats, mask=mask))

    forward = embed


def build_speaker_net(config: dict) -> SpeakerNet:
    """Backbone from a training config (the YAML schema as a dict) with the
    fbank frontend."""
    frontend = config.get("dataset_args", {}).get("frontend", "fbank")
    if frontend != "fbank":
        raise NotImplementedError(
            f"frontend {frontend!r} is not ported yet (SSL / Whisper slice)"
        )
    model_args = dict(config.get("model_args", {}))
    return SpeakerNet(get_speaker_model(config["model"])(**model_args))
