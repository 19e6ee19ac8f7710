"""MoCo / SimCLR self-supervised training on one GPU.

Counterpart of `wespeaker_hubert_tpu/bin/train_contrastive.py`, with its
config keys and defaults:

    python -m wespeaker_hubert_tpu_torch.bin.train_contrastive \\
        --config conf.yaml [--device cuda|cpu] [a.b.c=value ...]

`ssl_method` is `moco` (`moco_args`: K, m, T) or `simclr` (`simclr_args`:
T).  The two views of an utterance are SSLPipeline's two global crops of
`dataset_args.chunk_len` frames (`local_num` 0): the first is the query,
the second the key, each with its own reverb / noise draw, then the
dithered fbank on the device.  The update is SGD with
`optimizer_args.momentum` / `nesterov` at `scheduler_args.initial_lr`,
constant, and no weight decay: like the JAX trainer, this one ignores
`optimizer_args.weight_decay` (both v3 configs set 1e-4).  The queue's
first keys are drawn from a torch.Generator seeded with `seed`.

Every `save_epoch_interval` epochs it saves the query encoder's backbone
as `exp_dir/models/model_N.pt` in the port's SpeakerNet format.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Union

import torch
import torch.nn as nn

from ..data.dataset import load_data_list
from ..models.registry import embedding_from_outputs, get_speaker_model
from ..ssl import (
    SSLPipeline,
    create_moco_state,
    create_simclr_state,
    make_moco_train_step,
    make_simclr_train_step,
)
from ..utils.checkpoint import save_checkpoint
from ..utils.config import parse_config_or_kwargs
from ..utils.device import resolve_device
from ..utils.observability import MetricsLogger
from .train import _prefetch, _to_device
from .train_dino import (
    _step_generator,
    _stores,
    crops_to_features,
    ssl_compute_dtype,
    ssl_feature_cfg,
)

__all__ = ["train_contrastive", "main"]

logger = logging.getLogger("train_contrastive")


class _Encoder(nn.Module):
    """backbone -> embedding."""

    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.backbone = backbone

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return embedding_from_outputs(self.backbone(feats))


def train_contrastive(config: Union[str, dict], device="cuda", **overrides):
    """Run MoCo or SimCLR training; returns the final MoCoState or
    SimCLRState."""
    config = parse_config_or_kwargs(config, **overrides)
    device = resolve_device(device)
    method = config.get("ssl_method", "moco")
    if method not in ("moco", "simclr"):
        raise ValueError(f"ssl_method {method!r}: moco or simclr")
    exp_dir = config.get("exp_dir", f"exp/{method}")
    os.makedirs(os.path.join(exp_dir, "models"), exist_ok=True)
    dataset_args = config.get("dataset_args", {})
    batch_size = config.get("dataloader_args", {}).get("batch_size", 64)
    num_epochs = config.get("num_epochs", 100)
    epoch_iter = config.get("epoch_iter", 1000)
    seed = config.get("seed", 42)

    torch.manual_seed(seed)
    model_args = dict(config.get("model_args", {}))
    net = _Encoder(get_speaker_model(config["model"])(**model_args)).to(device)
    embed_dim = model_args.get("embed_dim", 256)

    reverb_store, noise_store = _stores(dataset_args)
    pipe = SSLPipeline(
        load_data_list(config["train_data"]),
        data_type=config.get("data_type", "raw"),
        global_frames=dataset_args.get("chunk_len", 200),
        global_num=2,  # query + key views
        local_num=0,
        batch_size=batch_size,
        aug_prob=dataset_args.get("aug_prob", 0.6),
        reverb_store=reverb_store,
        noise_store=noise_store,
        seed=seed,
    )
    fcfg = ssl_feature_cfg(dataset_args)

    lr = config.get("scheduler_args", {}).get("initial_lr", 0.05)
    opt_args = config.get("optimizer_args", {})
    sgd = dict(lr=lr, momentum=opt_args.get("momentum", 0.9),
               nesterov=opt_args.get("nesterov", False))
    compute_dtype = ssl_compute_dtype(config, device)
    if method == "moco":
        moco_args = config.get("moco_args", {})
        state = create_moco_state(net, embed_dim, K=moco_args.get("K", 65536),
                                  generator=torch.Generator().manual_seed(seed), **sgd)
        step_fn = make_moco_train_step(m=moco_args.get("m", 0.999), T=moco_args.get("T", 0.07),
                                       compute_dtype=compute_dtype)
        query = state.encoder_q
    else:
        state = create_simclr_state(net, **sgd)
        step_fn = make_simclr_train_step(T=config.get("simclr_args", {}).get("T", 0.07),
                                         compute_dtype=compute_dtype)
        query = state.encoder

    with open(os.path.join(exp_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=1, default=str)
    log_interval = int(config.get("log_batch_interval", 100))
    save_interval = int(config.get("save_epoch_interval", 5))
    mlog = MetricsLogger(os.path.join(exp_dir, "metrics.jsonl"))
    logger.info("%s on %s: %s, batch %d x 2 views, compute %s", method, device, config["model"],
                batch_size, "bf16" if compute_dtype else "float32")
    try:
        for epoch in range(num_epochs):
            pipe.set_epoch(epoch)
            t0, it = time.time(), 0
            batches = _prefetch(pipe)
            for batch in batches:
                feats = crops_to_features(_to_device(batch, device), "global", fcfg,
                                          _step_generator(device, seed, state.step))
                metrics = step_fn(state, {"query_feat": feats[:, 0], "key_feat": feats[:, 1]})
                it += 1
                if it % log_interval == 0:
                    loss, acc = float(metrics["loss"]), float(metrics["acc"])
                    logger.info("epoch %d iter %d loss %.4f acc %.4f", epoch, it, loss, acc)
                    mlog.log(state.step, epoch=epoch, loss=loss, acc=acc)
                if it >= epoch_iter:
                    break
            batches.close()
            logger.info("epoch %d: %d iters in %.1fs", epoch, it, time.time() - t0)
            if (epoch + 1) % save_interval == 0:
                path = os.path.join(exp_dir, "models", f"model_{epoch + 1}.pt")
                save_checkpoint(path, query.backbone.state_dict(),
                                meta={"epoch": epoch + 1, "step": state.step})
                logger.info("saved the query encoder's backbone to %s", path)
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
    train_contrastive(parse_config_or_kwargs(args.config, overrides=args.overrides),
                      device=args.device)


if __name__ == "__main__":
    main()
