"""DINO self-supervised training on one GPU.

Counterpart of `wespeaker_hubert_tpu/bin/train_dino.py`, with its config
keys and defaults:

    python -m wespeaker_hubert_tpu_torch.bin.train_dino --config conf.yaml \\
        [--device cuda|cpu] [a.b.c=value ...]

`dataset_args` sets the crops (`global_chunk_len` / `_num`, `local_chunk_len`
/ `_num`), `aug_prob`, the aug stores (`reverb_data`, `noise_data`) and
`fbank_args` (80 mels, dither 1.0); `dino_args` the head (`out_dim`,
`hidden_dim`, `bottleneck_dim`, `use_bn_in_head`, `norm_last_layer`), the
temperatures, the teacher momentum, weight decay, clipping and
`freeze_last_layer_epochs`; `scheduler_args` the cosine LR (`base_lr` x
batch / 256 to `final_lr` after `warmup_epochs`).  `optimizer` is SGD
(momentum 0.9) or ADAMW (ssl/dino.py:make_dino_optimizer); LARS is refused.
The host pipeline (ssl/dataset.py:SSLPipeline) runs on one prefetch thread;
reverb / noise and the dithered fbank of every crop run on the device.
`enable_amp` on CUDA (or `compute_dtype: bf16`) runs the forwards in bf16.

Every `save_epoch_interval` epochs it saves the *teacher* backbone, the
network that is evaluated, as `exp_dir/models/model_N.pt` in the port's
SpeakerNet format (backbone keys unprefixed), which bin/average_model,
bin/extract and bin/train's `model_init` (utils/checkpoint.py:load_partial)
take unchanged.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional, Tuple, Union

import torch

from ..data.aug_store import AugStore
from ..data.dataset import load_data_list
from ..models.registry import get_speaker_model
from ..ops.augment import add_reverb_noise
from ..ops.fbank import FbankConfig
from ..ops.pipeline import FeaturePipelineConfig, split_generator, wav_to_features
from ..ssl import (
    DINOHead,
    DINONet,
    DINOState,
    SSLPipeline,
    cosine_schedule,
    create_dino_state,
    make_dino_train_step,
)
from ..utils.checkpoint import save_checkpoint
from ..utils.config import parse_config_or_kwargs
from ..utils.device import resolve_device
from ..utils.observability import MetricsLogger
from .train import _prefetch, _to_device

__all__ = ["crops_to_features", "make_dino_preprocess", "ssl_feature_cfg", "ssl_compute_dtype",
           "train_dino", "main"]

logger = logging.getLogger("train_dino")


def ssl_feature_cfg(dataset_args: Dict) -> FeaturePipelineConfig:
    """The SSL trainers' features: dithered fbank and CMVN, no SpecAug."""
    fb = dataset_args.get("fbank_args", {})
    return FeaturePipelineConfig(
        fbank=FbankConfig(num_mel_bins=fb.get("num_mel_bins", 80), dither=fb.get("dither", 1.0)),
        spec_aug=False)


def ssl_compute_dtype(config: Dict, device: torch.device) -> Optional[torch.dtype]:
    """bf16 under `enable_amp` on CUDA (the JAX trainers': accelerator
    only), or as `compute_dtype` says; else None (float32)."""
    default = "bf16" if config.get("enable_amp", False) and device.type == "cuda" else "f32"
    name = str(config.get("compute_dtype", default)).lower()
    return torch.bfloat16 if name in ("bf16", "bfloat16") else None


def crops_to_features(batch: Dict[str, torch.Tensor], prefix: str, fcfg: FeaturePipelineConfig,
                      generator: Optional[torch.Generator]) -> Optional[torch.Tensor]:
    """One crop group of an SSLPipeline batch on the device -> (B, n, T, F)
    features: each crop's reverb / noise, then the dithered fbank and CMVN;
    None for an empty group."""
    wav = batch[f"{prefix}_wav"]
    b, n, length = wav.shape
    if n == 0:
        return None
    flat = add_reverb_noise(
        wav.reshape(b * n, length), batch[f"{prefix}_rir"].reshape(b * n, -1),
        batch[f"{prefix}_noise"].reshape(b * n, length),
        batch[f"{prefix}_aug_type"].reshape(-1), batch[f"{prefix}_snr"].reshape(-1))
    feats, _ = wav_to_features(flat, fcfg, train=True, generator=generator)
    return feats.reshape(b, n, feats.shape[1], feats.shape[2])


def make_dino_preprocess(fcfg: FeaturePipelineConfig):
    """The DINO step's preprocess_fn: (SSLPipeline batch on the device,
    generator) -> (global, local) features, each group with its own stream
    split off the step's generator."""

    def preprocess(batch, generator):
        gen_g, gen_l = split_generator(generator)
        return (crops_to_features(batch, "global", fcfg, gen_g),
                crops_to_features(batch, "local", fcfg, gen_l))

    return preprocess


def _step_generator(device: torch.device, seed: int, step: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 1000003 + step)
    return gen


def _stores(dataset_args: Dict) -> Tuple[Optional[AugStore], Optional[AugStore]]:
    return tuple(AugStore(root=dataset_args[k]) if dataset_args.get(k) else None
                 for k in ("reverb_data", "noise_data"))


def train_dino(config: Union[str, dict], device="cuda", **overrides) -> DINOState:
    """Run DINO training; returns the final DINOState."""
    config = parse_config_or_kwargs(config, **overrides)
    device = resolve_device(device)
    exp_dir = config.get("exp_dir", "exp/dino")
    os.makedirs(os.path.join(exp_dir, "models"), exist_ok=True)
    dataset_args = config.get("dataset_args", {})
    dino_args = config.get("dino_args", {})
    batch_size = config.get("dataloader_args", {}).get("batch_size", 64)
    num_epochs = config.get("num_epochs", 150)
    epoch_iter = config.get("epoch_iter", 1000)
    total = num_epochs * epoch_iter
    n_global = dataset_args.get("global_chunk_num", 2)
    n_local = dataset_args.get("local_chunk_num", 4)
    seed = config.get("seed", 42)

    # ---- model and state (the optimizer refuses LARS before any data is read)
    torch.manual_seed(seed)
    model_args = dict(config.get("model_args", {}))
    backbone = get_speaker_model(config["model"])(**model_args)
    out_dim = dino_args.get("out_dim", 65536)
    head = DINOHead(
        in_dim=model_args.get("embed_dim", 192),
        out_dim=out_dim,
        hidden_dim=dino_args.get("hidden_dim", 2048),
        bottleneck_dim=dino_args.get("bottleneck_dim", 256),
        use_bn=dino_args.get("use_bn_in_head", False),
        norm_last_layer=dino_args.get("norm_last_layer", True),
    )
    net = DINONet(backbone, head).to(device)
    state = create_dino_state(net, out_dim, config.get("optimizer", "SGD"))

    # ---- data
    reverb_store, noise_store = _stores(dataset_args)
    pipe = SSLPipeline(
        load_data_list(config["train_data"]),
        data_type=config.get("data_type", "raw"),
        global_frames=dataset_args.get("global_chunk_len", 200),
        global_num=n_global,
        local_frames=dataset_args.get("local_chunk_len", 100),
        local_num=n_local,
        batch_size=batch_size,
        aug_prob=dataset_args.get("aug_prob", 0.6),
        reverb_store=reverb_store,
        noise_store=noise_store,
        seed=seed,
    )
    preprocess = make_dino_preprocess(ssl_feature_cfg(dataset_args))

    # ---- schedules (the JAX trainer's)
    sched = config.get("scheduler_args", {})
    lr_schedule = cosine_schedule(
        sched.get("base_lr", 0.2) * batch_size / 256.0, sched.get("final_lr", 1e-5), total,
        warmup_steps=sched.get("warmup_epochs", 10) * epoch_iter)
    wd_schedule = cosine_schedule(dino_args.get("weight_decay", 1e-4),
                                  dino_args.get("weight_decay_end", 1e-4), total)
    momentum_schedule = cosine_schedule(dino_args.get("momentum_teacher", 0.996), 1.0, total)
    t_temp_schedule = cosine_schedule(
        dino_args.get("warmup_teacher_temp", 0.04), dino_args.get("teacher_temp", 0.07),
        int(total * dino_args.get("warmup_teacher_temp_epochs_ratio", 0.2)))
    compute_dtype = ssl_compute_dtype(config, device)
    step_fn = make_dino_train_step(
        lr_schedule, wd_schedule, momentum_schedule, t_temp_schedule,
        n_global=n_global, n_local=n_local,
        student_temp=dino_args.get("student_temp", 0.1),
        center_momentum=dino_args.get("center_momentum", 0.9),
        clip_grad=dino_args.get("clip_grad", 3.0),
        freeze_last_layer_steps=dino_args.get("freeze_last_layer_epochs", 1) * epoch_iter,
        preprocess_fn=preprocess, compute_dtype=compute_dtype)

    with open(os.path.join(exp_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=1, default=str)
    log_interval = int(config.get("log_batch_interval", 100))
    save_interval = int(config.get("save_epoch_interval", 5))
    mlog = MetricsLogger(os.path.join(exp_dir, "metrics.jsonl"))
    logger.info("DINO on %s: %s, %d global + %d local crops of batch %d, out_dim %d, compute %s",
                device, config["model"], n_global, n_local, batch_size, out_dim,
                "bf16" if compute_dtype else "float32")
    try:
        for epoch in range(num_epochs):
            pipe.set_epoch(epoch)
            t0, it = time.time(), 0
            batches = _prefetch(pipe)
            for batch in batches:
                metrics = step_fn(state, _to_device(batch, device),
                                  _step_generator(device, seed, state.step))
                it += 1
                if it % log_interval == 0:
                    loss = float(metrics["loss"])
                    logger.info("epoch %d iter %d loss %.4f lr %.5f m %.5f", epoch, it, loss,
                                metrics["lr"], metrics["teacher_momentum"])
                    mlog.log(state.step, epoch=epoch, loss=loss, lr=metrics["lr"],
                             wd=metrics["wd"], teacher_momentum=metrics["teacher_momentum"],
                             teacher_temp=metrics["teacher_temp"])
                if it >= epoch_iter:
                    break
            batches.close()
            logger.info("epoch %d: %d iters in %.1fs", epoch, it, time.time() - t0)
            if (epoch + 1) % save_interval == 0:
                path = os.path.join(exp_dir, "models", f"model_{epoch + 1}.pt")
                save_checkpoint(path, state.teacher.backbone.state_dict(),
                                meta={"epoch": epoch + 1, "step": state.step})
                logger.info("saved the teacher backbone to %s", path)
    finally:
        mlog.close()
    return state


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*", help="a.b.c=value config overrides")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    # float32 means float32: no TF32 in cuDNN convolutions or matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train_dino(parse_config_or_kwargs(args.config, overrides=args.overrides), device=args.device)


if __name__ == "__main__":
    main()
