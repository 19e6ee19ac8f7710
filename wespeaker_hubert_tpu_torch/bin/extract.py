"""Batch embedding extraction on PyTorch.

Counterpart of `wespeaker_hubert_tpu/bin/extract.py`: bucketed
whole-utterance batches with masks (data/dataset.py:EvalPipeline), the
fbank + CMVN frontend, an SSL frontend or the Whisper encoder on the
device, embeddings written as an .npz set (utils/embeddings.py).  A
frontend's valid frames mask CMVN and the pooling; the Whisper encoder
takes utterances past 30 s and keeps their first 1,500 tokens, as the JAX
package's does.

    python -m wespeaker_hubert_tpu_torch.bin.extract --config conf.json \\
        --data_list wav.jsonl --checkpoint avg_model.pt --output emb.npz \\
        [--batch_size 32] [--data_type raw|feat] [--device cuda|cpu]

The config is the training config (JSON or YAML, utils/config.py's
reader); `compute_dtype: bf16` runs the model in bf16.  The checkpoint is a
torch state_dict in the port's names (models/speaker_net.py:
load_speaker_state) or a JAX package `.ckpt` (utils/checkpoint.py:
load_state).
The device is CUDA unless the caller asks for the CPU.  Rows are not padded
to the full batch: eager PyTorch compiles nothing per shape, and rows are
independent.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Dict, Union

import numpy as np
import torch

from ..data.dataset import EvalPipeline, load_data_list
from ..models.speaker_net import build_speaker_net, load_speaker_state
from ..ops.fbank import FbankConfig
from ..ops.pipeline import FeaturePipelineConfig
from ..train.executor import cast_variables_bf16, make_eval_embed
from ..utils.checkpoint import load_state
from ..utils.config import parse_config_or_kwargs
from ..utils.device import resolve_device
from ..utils.embeddings import save_embeddings

__all__ = ["extract", "main"]

logger = logging.getLogger("extract")


def extract(
    config: Union[str, Dict],
    data_list: str,
    checkpoint: str,
    output: str,
    batch_size: int = 32,
    data_type: str = "raw",
    device="cuda",
    **overrides,
):
    """Extract embeddings for every utterance in `data_list` (raw JSONL
    {key, wav} or feat JSONL {key, feat}) and save them to `output` (.npz,
    skipped when empty).  Returns (keys, embeddings)."""
    config = parse_config_or_kwargs(config, **overrides)
    device = resolve_device(device)

    dataset_args = config.get("dataset_args", {})
    # fbank_args nested (train-config style) or top-level
    fb = dataset_args.get("fbank_args", config.get("fbank_args", {}))
    # the wavs' rate (SRE's telephone speech: 8000); the pipeline does not resample
    sample_rate = dataset_args.get("resample_rate", 16000)
    feature_cfg = FeaturePipelineConfig(
        fbank=FbankConfig(
            num_mel_bins=fb.get("num_mel_bins", 80),
            frame_shift_ms=fb.get("frame_shift", 10),
            frame_length_ms=fb.get("frame_length", 25),
            dither=0.0,  # eval: no dither
            sample_rate=sample_rate,
            spectrum_impl="kernel",  # the CUDA fbank kernel on a GPU
        ),
        spec_aug=False,
    )

    net = build_speaker_net(config)
    if data_type == "feat" and net.frontend is not None:
        # precomputed features would silently bypass a wav-domain frontend
        raise ValueError(
            "data_type=feat requires frontend=fbank (precomputed features "
            "cannot feed a wav-domain frontend)"
        )
    state = load_state(checkpoint, config["model"], getattr(net.backbone, "feat_dim", 80))
    missing, unexpected = load_speaker_state(net, state)
    if missing:
        logger.info("missing keys in checkpoint: %d", len(missing))
    if unexpected:
        logger.info("checkpoint keys the model does not have: %d", len(unexpected))
    # a checkpoint that matches no backbone weights would silently extract
    # random-init embeddings: refuse
    n_backbone = sum(1 for k in net.backbone.state_dict() if not k.endswith("num_batches_tracked"))
    n_missing = sum(1 for k in missing if not k.startswith("frontend."))
    if n_backbone and n_missing >= n_backbone:
        raise RuntimeError(
            f"checkpoint {checkpoint!r} matched no backbone parameters "
            "(wrong model/config or prefixed names?)"
        )

    compute_dtype = None
    if str(config.get("compute_dtype", "")).lower() in ("bf16", "bfloat16"):
        compute_dtype = torch.bfloat16
        cast_variables_bf16(net)
        logger.info("bf16 inference enabled")
    net.to(device).eval()
    embed_fn = make_eval_embed(net, feature_cfg=feature_cfg, compute_dtype=compute_dtype)

    pipe = EvalPipeline(load_data_list(data_list), data_type=data_type, batch_size=batch_size,
                        sample_rate=sample_rate)
    frame_shift_s = fb.get("frame_shift", 10) / 1000.0

    # host decode and batching overlap device compute: a producer thread
    # fills a bounded queue while this thread drives the device
    q: "queue.Queue" = queue.Queue(maxsize=4)
    failure = []

    def produce():
        try:
            for b in pipe:
                q.put(b)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            failure.append(e)
        finally:
            q.put(None)

    producer = threading.Thread(target=produce, daemon=True)
    producer.start()

    keys, embs = [], []
    audio_seconds = 0.0
    t0 = time.time()
    pending = None  # the previous batch's result, fetched after the next launch
    while True:
        batch = q.get()
        if batch is None:
            break
        if "feat" in batch:
            x, length, unit = batch["feat"], batch["feat_length"], frame_shift_s
            names = ("feat", "feat_length")
        else:
            x, length, unit = batch["wav"], batch["length"], 1.0 / sample_rate
            names = ("wav", "length")
        dev_batch = {
            names[0]: torch.from_numpy(x).to(device, non_blocking=True),
            names[1]: torch.from_numpy(length).to(device, non_blocking=True),
        }
        e = embed_fn(dev_batch)
        if pending is not None:
            embs.append(pending.cpu().numpy())
        pending = e
        keys += batch["keys"]
        audio_seconds += float(length.sum()) * unit
    if pending is not None:
        embs.append(pending.cpu().numpy())
    producer.join()
    if failure:
        raise failure[0]
    dt = time.time() - t0
    emb = np.concatenate(embs) if embs else np.zeros((0, 0), np.float32)
    logger.info(
        "extracted %d embeddings; %.1f audio-s in %.1fs (%.1f audio-s/s)",
        len(keys), audio_seconds, dt, audio_seconds / max(dt, 1e-9),
    )
    if not keys:
        # every sample was skipped (corrupt wavs / bad list): an empty
        # output would poison downstream scoring
        raise RuntimeError(
            f"extracted 0 embeddings from {data_list!r}; "
            "check the data list format and per-sample warnings above"
        )
    if output:
        os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
        save_embeddings(output, keys, emb)
    return keys, emb


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--data_list", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--data_type", default="raw", choices=("raw", "feat"))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args()
    logging.basicConfig(level=logging.INFO)
    # float32 means float32: no TF32 in cuDNN convolutions or matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    extract(args.config, args.data_list, args.checkpoint, args.output,
            args.batch_size, data_type=args.data_type, device=args.device)


if __name__ == "__main__":
    main()
