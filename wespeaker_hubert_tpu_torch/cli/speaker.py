"""User-facing Speaker API on PyTorch.

Counterpart of `wespeaker_hubert_tpu/cli/speaker.py` (embedding extraction,
cosine similarity, in-memory enrollment; VAD and diarization are still to
be ported).

A model directory holds
  config.json   the training config (the YAML schema, as JSON): `model`,
                `model_args`, `dataset_args.fbank_args` and
                `dataset_args.resample_rate`;
  avg_model.pt  a torch state_dict with the WeSpeaker parameter names of
                the backbone (models/ecapa_tdnn.py, models/resnet.py).  Keys
                the backbone does not have, such as a WeSpeaker checkpoint's
                `projection.*`, are reported and skipped; a missing key
                raises.

bin/export_model.py writes such a directory (recipe stage 8), from the
port's experiment directory or a JAX one.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict

import numpy as np
import torch

from ..data.wav_io import read_wav
from ..models.speaker_net import build_speaker_net, load_speaker_state
from ..ops.fbank import FbankConfig
from ..ops.pipeline import FeaturePipelineConfig
from ..train.executor import make_eval_embed
from ..utils.device import resolve_device

__all__ = ["Speaker"]

logger = logging.getLogger(__name__)


def _pow2_bucket(n: int, floor: int = 1 << 14) -> int:
    """Smallest power-of-two >= n with a floor (~1 s at 16 kHz): the
    mask-aware path keeps results exact while shapes stay few."""
    return max(floor, 1 << (max(n, 2) - 1).bit_length())


class Speaker:
    def __init__(self, model_dir: str, device="cuda"):
        self.device = resolve_device(device)
        with open(os.path.join(model_dir, "config.json")) as f:
            config = json.load(f)
        ckpt = os.path.join(model_dir, "avg_model.pt")
        if not os.path.exists(ckpt):
            raise FileNotFoundError(f"no avg_model.pt under {model_dir}")

        self.config = config
        dataset_args = config.get("dataset_args", {})
        fb = dataset_args.get("fbank_args", {})
        # the served fbank is the hand-written CUDA kernel on a GPU
        self.fbank_cfg = FbankConfig(
            num_mel_bins=fb.get("num_mel_bins", 80),
            frame_shift_ms=fb.get("frame_shift", 10),
            frame_length_ms=fb.get("frame_length", 25),
            dither=0.0,
            spectrum_impl="kernel",
        )
        self.resample_rate = dataset_args.get("resample_rate", 16000)
        self.model_dir = model_dir
        self.net = build_speaker_net(config)
        self._load_weights(torch.load(ckpt, map_location="cpu", weights_only=True))
        self.net.to(self.device).eval()
        self._embed_fn = make_eval_embed(
            self.net,
            feature_cfg=FeaturePipelineConfig(fbank=self.fbank_cfg, spec_aug=False),
        )
        self.table: Dict[str, np.ndarray] = {}

    def _load_weights(self, state: Dict[str, torch.Tensor]) -> None:
        missing, unexpected = load_speaker_state(self.net, state)
        if missing:
            raise KeyError(f"checkpoint lacks backbone weights: {missing[:8]}")
        if unexpected:
            logger.warning(
                "skipping %d checkpoint keys the backbone does not have: %s",
                len(unexpected), unexpected[:8],
            )

    def _load_audio(self, audio_path: str) -> np.ndarray:
        wav, sr = read_wav(audio_path)
        if sr != self.resample_rate:
            raise ValueError(
                f"{audio_path}: {sr} Hz audio for a {self.resample_rate} Hz "
                "model (resampling is not ported yet)"
            )
        return wav

    def extract_embedding_from_pcm(self, wav: np.ndarray) -> np.ndarray:
        """Float samples at the model rate -> embedding.  The wav is padded
        to a power-of-two bucket (few distinct shapes) with its length, so
        CMN and pooling see only its valid frames."""
        wav = np.asarray(wav, np.float32).reshape(-1)
        n = len(wav)
        padded = np.zeros(_pow2_bucket(n), np.float32)
        padded[:n] = wav
        emb = self._embed_fn({
            "wav": torch.from_numpy(padded[None]).to(self.device),
            "length": torch.tensor([n], dtype=torch.int32, device=self.device),
        })
        return emb[0].cpu().numpy()

    def extract_embedding(self, audio_path: str) -> np.ndarray:
        return self.extract_embedding_from_pcm(self._load_audio(audio_path))

    def compute_similarity(self, audio_path1: str, audio_path2: str) -> float:
        e1 = self.extract_embedding(audio_path1)
        e2 = self.extract_embedding(audio_path2)
        return self.cosine_similarity(e1, e2)

    @staticmethod
    def cosine_similarity(e1: np.ndarray, e2: np.ndarray) -> float:
        """Cosine mapped from [-1,1] to [0,1]."""
        s = float(np.dot(e1, e2) / (np.linalg.norm(e1) * np.linalg.norm(e2)))
        return (s + 1.0) / 2.0

    def register(self, name: str, audio_path: str):
        if name in self.table:
            raise ValueError(f"speaker {name} already registered")
        self.table[name] = self.extract_embedding(audio_path)

    def recognize(self, audio_path: str):
        q = self.extract_embedding(audio_path)
        best_name, best_score = "", 0.0
        for name, e in self.table.items():
            score = self.cosine_similarity(q, e)
            if score > best_score:
                best_name, best_score = name, score
        return {"name": best_name, "confidence": best_score}
