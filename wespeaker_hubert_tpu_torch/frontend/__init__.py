"""Frontend registry (counterpart of `wespeaker_hubert_tpu/frontend/`):
{'fbank': None, 's3prl': SSLFrontend, 'whisper_encoder': not ported yet}.
'fbank' maps to None because the fbank path lives in ops/pipeline.py."""

from .convert import convert_hf_state_dict, load_hf_state_dict
from .ssl_encoder import SSLEncoder, SSLEncoderConfig, feat_extract_output_lengths
from .sslfrontend import SSLFrontend


def _whisper_encoder(*args, **kwargs):
    raise NotImplementedError(
        "the whisper_encoder frontend is not ported yet (ROADMAP.md queue 1)"
    )


frontend_class_dict = {
    "fbank": None,
    "s3prl": SSLFrontend,
    "whisper_encoder": _whisper_encoder,
}

__all__ = [
    "convert_hf_state_dict",
    "load_hf_state_dict",
    "SSLEncoder",
    "SSLEncoderConfig",
    "feat_extract_output_lengths",
    "SSLFrontend",
    "frontend_class_dict",
]
