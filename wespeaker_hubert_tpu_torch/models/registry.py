"""Model registry: name -> factory returning an nn.Module backbone.

Counterpart of `wespeaker_hubert_tpu/models/registry.py`, with the same
names: x-vector, ECAPA-TDNN, ResNet, Res2Net, ERes2Net, CAM++, Gemini
DF-ResNet, SimAM-ResNet, the xi-vectors, the Whisper-PMFA head, ReDimNet
B0-B6 and the 19 RepVGG variants.  Factories
share the signature (feat_dim, embed_dim, pooling_func, **kwargs), and the
module is called as module(x, mask=None) with x = (B, T, feat_dim)
features.
"""

from __future__ import annotations

from typing import Callable, Dict

from . import (
    campplus,
    ecapa_tdnn,
    eres2net,
    gemini_dfresnet,
    redimnet,
    repvgg,
    res2net,
    resnet,
    samresnet,
    tdnn,
    whisper_pmfa,
    xi_vector,
)

__all__ = ["get_speaker_model", "embedding_from_outputs", "MODEL_REGISTRY"]

MODEL_REGISTRY: Dict[str, Callable] = {
    "XVEC": tdnn.XVEC_factory,
    "ECAPA_TDNN_c512": ecapa_tdnn.ECAPA_TDNN_c512,
    "ECAPA_TDNN_GLOB_c512": ecapa_tdnn.ECAPA_TDNN_GLOB_c512,
    "ECAPA_TDNN_c1024": ecapa_tdnn.ECAPA_TDNN_c1024,
    "ECAPA_TDNN_GLOB_c1024": ecapa_tdnn.ECAPA_TDNN_GLOB_c1024,
    "ResNet18": resnet.ResNet18,
    "ResNet34": resnet.ResNet34,
    "ResNet50": resnet.ResNet50,
    "ResNet101": resnet.ResNet101,
    "ResNet152": resnet.ResNet152,
    "ResNet221": resnet.ResNet221,
    "ResNet293": resnet.ResNet293,
    "Res2Net34_Base": res2net.Res2Net34_Base,
    "Res2Net34_Large": res2net.Res2Net34_Large,
    "ERes2Net34_Base": eres2net.ERes2Net34_Base,
    "ERes2Net34_Large": eres2net.ERes2Net34_Large,
    "ERes2Net34_aug": eres2net.ERes2Net34_aug,
    "CAMPPlus": campplus.CAMPPlus,
    "Gemini_DF_ResNet60": gemini_dfresnet.Gemini_DF_ResNet60,
    "Gemini_DF_ResNet114": gemini_dfresnet.Gemini_DF_ResNet114,
    "Gemini_DF_ResNet183": gemini_dfresnet.Gemini_DF_ResNet183,
    "Gemini_DF_ResNet237": gemini_dfresnet.Gemini_DF_ResNet237,
    "SimAM_ResNet34_ASP": samresnet.SimAM_ResNet34_ASP,
    "SimAM_ResNet100_ASP": samresnet.SimAM_ResNet100_ASP,
    "XI_VEC_ECAPA_TDNN_c512": xi_vector.XI_VEC_ECAPA_TDNN_c512,
    "XI_VEC_ECAPA_TDNN_c1024": xi_vector.XI_VEC_ECAPA_TDNN_c1024,
    "XI_VEC_XVEC": xi_vector.XI_VEC_XVEC,
    "whisper_PMFA": whisper_pmfa.whisper_PMFA,
    "whisper_PMFA_large_v2": whisper_pmfa.whisper_PMFA_large_v2,
    **{f"ReDimNetB{i}": getattr(redimnet, f"ReDimNetB{i}") for i in range(7)},
    **repvgg.REPVGG_FACTORIES,
}


def get_speaker_model(model_name: str) -> Callable:
    try:
        return MODEL_REGISTRY[model_name]
    except KeyError:
        pass
    # case-insensitive fallback: reference configs are not consistent about
    # casing
    lowered = {k.lower(): v for k, v in MODEL_REGISTRY.items()}
    if model_name.lower() in lowered:
        return lowered[model_name.lower()]
    raise ValueError(
        f"unknown model {model_name!r}; available: "
        + ", ".join(sorted(MODEL_REGISTRY))
    ) from None


def embedding_from_outputs(outputs):
    """Backbones return either `embed` or `(..., embed)`; take the last."""
    if isinstance(outputs, (tuple, list)):
        return outputs[-1]
    return outputs
