"""Chunked embedding extraction: the fixed-shape serving path.

Counterpart of `wespeaker_hubert_tpu/train/chunked.py`, after the C++
SpeakerEngine of the reference runtime: every utterance is cut into
`chunk_frames`-frame feature chunks (the tail chunk re-reads the last
`chunk_frames` valid frames), each chunk gets its own CMN, the model embeds
all chunks of the batch in one call, and the chunk embeddings are averaged
over each utterance's valid chunks.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..models.registry import embedding_from_outputs
from ..ops.fbank import FbankConfig, fbank
from ..ops.feature_utils import apply_cmvn

__all__ = ["make_chunked_embed", "chunk_features"]


def chunk_features(
    feats: torch.Tensor,
    feat_len: torch.Tensor,
    chunk_frames: int,
    max_chunks: int,
) -> torch.Tensor:
    """(B, T, F) padded features + (B,) valid lengths ->
    (B, max_chunks, chunk_frames, F).

    Full chunks stride `chunk_frames`; no chunk starts later than
    feat_len - chunk_frames (clamped at 0), so the tail chunk is the last
    `chunk_frames` valid frames and chunks past the utterance repeat it
    (they are masked out of the average).  Indices are clamped to T - 1, so
    an utterance shorter than one chunk reads the padded frames after it.
    """
    b, t, _ = feats.shape
    dev = feats.device
    starts = torch.arange(max_chunks, device=dev) * chunk_frames  # (C,)
    tail_start = torch.clamp_min(feat_len.to(dev, torch.long) - chunk_frames, 0)
    starts = torch.minimum(starts[None, :], tail_start[:, None])  # (B, C)
    idx = starts[:, :, None] + torch.arange(chunk_frames, device=dev)
    idx = torch.clamp_max(idx, t - 1)  # (B, C, chunk)
    return feats[torch.arange(b, device=dev)[:, None, None], idx]


def make_chunked_embed(
    model: torch.nn.Module,
    fbank_cfg: FbankConfig = FbankConfig(),
    chunk_frames: int = 198,
    compute_dtype: Optional[torch.dtype] = None,
) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """Returns fn(batch) -> (B, D) float32 for batch = {'wav': (B, W),
    'length': (B,) optional}, both on the model's device.

    Per utterance: fbank -> ceil(T/chunk) chunks (tail re-read) -> per-chunk
    CMN -> model -> masked average of chunk embeddings.
    `compute_dtype=torch.bfloat16` runs the backbone in bf16; pass a model
    already cast to the same dtype (`cast_variables_bf16`)."""

    def embed_fn(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        wav = batch["wav"]
        lengths = batch.get("length")
        if lengths is None:
            lengths = torch.full(
                (wav.shape[0],), wav.shape[1], dtype=torch.int32,
                device=wav.device,
            )
        with torch.inference_mode():
            feats, feat_lens = fbank(wav, fbank_cfg, lengths=lengths)
            b, t, f = feats.shape
            max_chunks = max(1, -(-t // chunk_frames))
            chunks = chunk_features(feats, feat_lens, chunk_frames, max_chunks)
            flat = chunks.reshape(b * max_chunks, chunk_frames, f)
            flat = apply_cmvn(flat)  # per-chunk CMN
            if compute_dtype is not None:
                flat = flat.to(compute_dtype)
            if hasattr(model, "embed"):  # SpeakerNet
                emb = model.embed(flat)
            else:  # bare backbone
                emb = embedding_from_outputs(model(flat))
            emb = emb.float().reshape(b, max_chunks, -1)

            n_chunks = torch.clamp_min(
                torch.div(feat_lens + chunk_frames - 1, chunk_frames,
                          rounding_mode="floor"),
                1,
            )
            mask = (
                torch.arange(max_chunks, device=wav.device)[None, :]
                < n_chunks[:, None]
            ).float()
            return (emb * mask[:, :, None]).sum(dim=1) / torch.clamp_min(
                mask.sum(dim=1, keepdim=True), 1.0
            )

    return embed_fn
