"""Frontend registry (counterpart of `wespeaker_hubert_tpu/frontend/`):
{'fbank': None, 's3prl': SSLFrontend, 'whisper_encoder': WhisperEncoder}.
'fbank' maps to None because the fbank path lives in ops/pipeline.py."""

from .convert import convert_hf_state_dict, load_hf_state_dict
from .ssl_encoder import SSLEncoder, SSLEncoderConfig, feat_extract_output_lengths
from .sslfrontend import SSLFrontend
from .whisper import (
    WhisperEncoder,
    WhisperEncoderConfig,
    load_whisper_state_dict,
    read_whisper_checkpoint,
    whisper_encoder_state,
)

frontend_class_dict = {
    "fbank": None,
    "s3prl": SSLFrontend,
    "whisper_encoder": WhisperEncoder,
}

__all__ = [
    "convert_hf_state_dict",
    "load_hf_state_dict",
    "SSLEncoder",
    "SSLEncoderConfig",
    "feat_extract_output_lengths",
    "SSLFrontend",
    "WhisperEncoder",
    "WhisperEncoderConfig",
    "load_whisper_state_dict",
    "read_whisper_checkpoint",
    "whisper_encoder_state",
    "frontend_class_dict",
]
