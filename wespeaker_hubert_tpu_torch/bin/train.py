"""Supervised training on one GPU.

Counterpart of `wespeaker_hubert_tpu/bin/train.py`:

    python -m wespeaker_hubert_tpu_torch.bin.train --config conf.yaml \\
        [--device cuda|cpu] [a.b.c=value ...]

The config is the training config, YAML (utils/config.py's reader) or JSON;
`a.b.c=value` overrides set dotted paths, values parsed as YAML scalars.
One process drives one device, CUDA unless the caller asks for the CPU.  The
host pipeline (data/dataset.py:TrainPipeline: `raw` JSONL lists, `shard` tar
lists or `feat` lists) runs on one prefetch thread;
`dataloader_args.num_workers` is logged and ignored.  The frontend is
fbank, an SSL encoder (`s3prl`) or Whisper's encoder (`whisper_encoder`,
frozen or trained jointly; `whisper_encoder_args.checkpoint` imports an
OpenAI encoder state dict converted to `.npz`).  `num_class` is
speakers x 3 with speed perturbation.  The LR schedule is scaled by batch /
64 as in the JAX package (one host).  `enable_amp` on CUDA (or
`compute_dtype: bf16`) trains in bf16 mixed precision.  `loop_steps: N`
groups N batches into one call of an N-step train step, as JAX scans them;
the tail of an epoch that does not fill a group runs as single steps.

Checkpoints are the port's `.pt` files (utils/checkpoint.py):
`exp_dir/models/model_N.pt` per saved epoch, loadable by bin/extract and
bin/serve, and with `save_optimizer` a full `train_state.pt` (model,
optimizer, step, data position) from which a later run resumes at the same
step.  `model_init` and `checkpoint` take port `.pt` files or the JAX
package's `.ckpt` files (utils/checkpoint.py:load_state).  The configs'
`loss: CrossEntropyLoss` and `projection_args.do_lm` are accepted: the loss
is cross-entropy (or a head's own), and `arc_margin` ignores `do_lm`, as
the JAX package's does (its large-margin fine-tune is the margin schedule's
fixed 0.5 and the longer chunks).  Multi-host,
mesh, FSDP, pipeline and sequence parallelism are not ported yet and raise.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from typing import Dict, List, Union

import numpy as np
import torch

from ..data.aug_store import AugStore
from ..data.dataset import TrainPipeline, TrainPipelineConfig, load_data_list
from ..models.speaker_net import (
    build_speaker_net,
    load_speaker_state,
    refuse_model_parallel,
    speaker_state_dict,
)
from ..ops.fbank import FbankConfig
from ..ops.pipeline import FeaturePipelineConfig
from ..train.executor import make_train_step
from ..train.schedulers import MarginSchedule, get_lr_schedule
from ..train.state import TrainState, freeze_paths, make_optimizer
from ..utils.checkpoint import latest_checkpoint, load_checkpoint, load_partial, save_checkpoint
from ..utils.config import parse_config_or_kwargs
from ..utils.device import resolve_device
from ..utils.observability import MetricsLogger, ThroughputMeter

__all__ = ["read_spk2id", "train", "main"]

logger = logging.getLogger("train")


def read_spk2id(train_label_path: str) -> Dict[str, int]:
    """utt spk table -> sorted spk -> id."""
    spks = set()
    with open(train_label_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                spks.add(parts[1])
    return {s: i for i, s in enumerate(sorted(spks))}


def _feature_cfg(dataset_args: dict) -> FeaturePipelineConfig:
    fb = dataset_args.get("fbank_args", {})
    sa = dataset_args.get("spec_aug_args", {})
    return FeaturePipelineConfig(
        fbank=FbankConfig(
            num_mel_bins=fb.get("num_mel_bins", 80),
            frame_shift_ms=fb.get("frame_shift", 10),
            frame_length_ms=fb.get("frame_length", 25),
            dither=fb.get("dither", 1.0),
            sample_rate=dataset_args.get("resample_rate", 16000),
        ),
        spec_aug=dataset_args.get("spec_aug", False),
        spec_aug_num_t_mask=sa.get("num_t_mask", 1),
        spec_aug_num_f_mask=sa.get("num_f_mask", 1),
        spec_aug_max_t=sa.get("max_t", 10),
        spec_aug_max_f=sa.get("max_f", 8),
        spec_aug_prob=sa.get("prob", 0.6),
    )


def _refuse_unported(config: dict, fe_args: dict) -> None:
    refusals = {
        "coordinator_address / num_processes (multi-host)": config.get("coordinator_address")
        or int(config.get("num_processes", 1) or 1) > 1,
        "model_parallel > 1": int(config.get("model_parallel", 1)) > 1,
        "fsdp": bool(config.get("fsdp")),
    }
    for what, asked in refusals.items():
        if asked:
            raise NotImplementedError(f"{what} is not ported yet (one device)")
    refuse_model_parallel(fe_args)


def _to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device, non_blocking=True)
            for k, v in batch.items() if k != "keys"}


def _stack(pending: List[Dict]) -> Dict:
    return {k: np.stack([p[k] for p in pending]) for k in pending[0] if k != "keys"}


def train(config: Union[str, dict], device="cuda", **overrides) -> TrainState:
    """Run supervised training; returns the final TrainState."""
    config = parse_config_or_kwargs(config, **overrides)
    device = resolve_device(device)
    dataset_args = config.get("dataset_args", {})
    frontend_name = dataset_args.get("frontend", "fbank")
    fe_args = dataset_args.get(f"{frontend_name}_args", {}) if frontend_name in (
        "s3prl", "whisper_encoder") else {}
    _refuse_unported(config, fe_args)
    exp_dir = config.get("exp_dir", "exp/default")
    os.makedirs(exp_dir, exist_ok=True)
    seed = int(config.get("seed", 42))
    dataloader_args = config.get("dataloader_args", {})
    batch_size = int(dataloader_args.get("batch_size", 64))
    if dataloader_args.get("num_workers"):
        logger.info("num_workers=%s ignored: one host prefetch thread",
                    dataloader_args["num_workers"])

    # ---- data
    spk2id = read_spk2id(config["train_label"])
    data_list = load_data_list(config["train_data"])
    data_type = config.get("data_type", "raw")
    speed_perturb = dataset_args.get("speed_perturb", True)
    if data_type == "feat":
        speed_perturb = False  # no waveform to perturb
        if dataset_args.get("frontend", "fbank") != "fbank":
            raise ValueError(
                "data_type=feat requires frontend=fbank (precomputed features "
                "cannot feed a wav-domain frontend)"
            )
    num_class = len(spk2id) * (3 if speed_perturb else 1)
    reverb_store = AugStore(root=dataset_args["reverb_data"]) if dataset_args.get("reverb_data") else None
    noise_store = AugStore(root=dataset_args["noise_data"]) if dataset_args.get("noise_data") else None
    filter_args = dataset_args.get("filter_args", {})
    pipe_cfg = TrainPipelineConfig(
        data_type=data_type,
        num_frms=dataset_args.get("num_frms", 200),
        sample_rate=dataset_args.get("resample_rate", 16000),
        shuffle=dataset_args.get("shuffle", True),
        shuffle_size=dataset_args.get("shuffle_args", {}).get("shuffle_size", 2500),
        filter_min_frames=filter_args.get("min_num_frames", 100),
        filter_max_frames=filter_args.get("max_num_frames", 800),
        speed_perturb=speed_perturb,
        aug_prob=dataset_args.get("aug_prob", 0.6),
        batch_size=batch_size,
        seed=seed,
        packed_aug=dataset_args.get("packed_aug", True),
    )
    pipe = TrainPipeline(data_list, spk2id, pipe_cfg, reverb_store=reverb_store,
                         noise_store=noise_store)

    # ---- model
    torch.manual_seed(seed)
    net = build_speaker_net(config, num_class)
    if net.frontend is not None and fe_args.get("hf_checkpoint"):
        import numpy as np

        from ..frontend import load_hf_state_dict

        sd = np.load(fe_args["hf_checkpoint"], allow_pickle=True)
        sd = dict(sd.item()) if hasattr(sd, "item") else dict(sd)
        load_hf_state_dict(net.frontend.upstream, sd)
        logger.info("imported SSL frontend weights from %s", fe_args["hf_checkpoint"])
    if frontend_name == "whisper_encoder" and fe_args.get("checkpoint"):
        # an OpenAI Whisper encoder state dict, converted offline to .npz
        from ..frontend import load_whisper_state_dict, read_whisper_checkpoint

        load_whisper_state_dict(net.frontend, read_whisper_checkpoint(fe_args["checkpoint"]))
        logger.info("imported Whisper encoder weights from %s", fe_args["checkpoint"])

    # ---- schedules (LR scaled by batch / 64)
    num_epochs = int(config.get("num_epochs", 150))
    epoch_iter = config.get("epoch_iter")
    if epoch_iter is None:
        epoch_iter = max(1, len(data_list) * 8 // batch_size)
    epoch_iter = int(epoch_iter)
    sched_args = dict(config.get("scheduler_args", {}))
    sched_args.setdefault("initial_lr", 0.1)
    sched_args.setdefault("final_lr", 5e-5)
    lr_schedule = get_lr_schedule(
        config.get("scheduler", "ExponentialDecrease"), num_epochs=num_epochs,
        epoch_iter=epoch_iter, scale_ratio=max(1.0, batch_size / 64), **sched_args,
    )
    m_args = config.get("margin_update", {})
    margin_schedule = MarginSchedule(
        epoch_iter=epoch_iter,
        increase_start_epoch=m_args.get("increase_start_epoch", 20),
        fix_start_epoch=m_args.get("fix_start_epoch", 40),
        initial_margin=m_args.get("initial_margin", 0.0),
        final_margin=m_args.get("final_margin", 0.2),
        increase_type=m_args.get("increase_type", "exp"),
        update_margin=m_args.get("update_margin", True),
    )

    # ---- state (+ resume / partial init)
    if net.frontend is not None and getattr(net.frontend, "frozen", False):
        # an SSL frontend's pretrained weights sit under `upstream` (its
        # featurizer weights train); a Whisper encoder freezes whole,
        # `ln_post2` included
        freeze_paths(net, (("frontend", "upstream"),) if hasattr(net.frontend, "upstream")
                     else (("frontend",),))
    start_epoch, start_batch = 0, 0
    full_state_path = os.path.join(exp_dir, "models", "train_state.pt")
    resume_full = config.get("save_optimizer", False) and os.path.exists(full_state_path)
    ckpt = None if resume_full else (
        config.get("checkpoint") or latest_checkpoint(os.path.join(exp_dir, "models")))
    init = ckpt or (None if resume_full else config.get("model_init"))
    if init:
        missing, unexpected = load_partial(init, net, config["model"])
        if ckpt and os.path.exists(ckpt + ".json"):
            with open(ckpt + ".json") as f:
                start_epoch = json.load(f).get("epoch", 0)
        logger.info("%s from %s (epoch %d, %d missing, %d unexpected)",
                    "resumed" if ckpt else "model_init", init, start_epoch, len(missing),
                    len(unexpected))
    net.to(device)
    opt_args = config.get("optimizer_args", {})
    optimizer = make_optimizer(
        net, config.get("optimizer", "SGD"), momentum=opt_args.get("momentum", 0.9),
        nesterov=opt_args.get("nesterov", True), weight_decay=opt_args.get("weight_decay", 1e-4),
    )
    state = TrainState(net, optimizer, lr_schedule)
    if resume_full:
        full = load_checkpoint(full_state_path)
        load_speaker_state(net, full["model"])
        state.load_state_dict(full)
        with open(full_state_path + ".json") as f:
            meta = json.load(f)
        start_epoch, start_batch = meta.get("epoch", 0), meta.get("batch_in_epoch", 0)
        logger.info("resumed the full train state from %s (epoch %d, batch %d, step %d)",
                    full_state_path, start_epoch, start_batch, state.step)

    amp_default = "bf16" if config.get("enable_amp", False) and device.type == "cuda" else "f32"
    cd_name = str(config.get("compute_dtype", amp_default)).lower()
    compute_dtype = torch.bfloat16 if cd_name in ("bf16", "bfloat16") else None
    loop_steps = max(1, int(config.get("loop_steps", 1)))
    step_kwargs = dict(feature_cfg=_feature_cfg(dataset_args), chunk_samples=pipe.chunk_samples,
                       compute_dtype=compute_dtype, seed=seed + 1)
    step_fn = make_train_step(net, lr_schedule, margin_schedule, num_steps=loop_steps,
                              **step_kwargs)
    # the single step for an epoch's tail that does not fill a group
    flush_fn = step_fn if loop_steps == 1 else make_train_step(
        net, lr_schedule, margin_schedule, **step_kwargs)
    with open(os.path.join(exp_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=1, default=str)
    mlog = MetricsLogger(os.path.join(exp_dir, "metrics.jsonl"))
    meter = ThroughputMeter()
    audio_s_per_batch = batch_size * pipe_cfg.num_frms * 0.01
    log_interval = int(config.get("log_batch_interval", 100))
    save_interval = int(config.get("save_epoch_interval", 5))
    save_batch_interval = int(config.get("save_batch_interval", 0))
    stop_at_step = config.get("stop_at_step")
    logger.info("training on %s: %d classes, %d steps per epoch in calls of %d, compute %s",
                device, num_class, epoch_iter, loop_steps, "bf16" if compute_dtype else "float32")

    def save_full_state(epoch, batch_in_epoch):
        save_checkpoint(
            full_state_path,
            {"model": speaker_state_dict(net), **state.state_dict()},
            meta={"epoch": epoch, "batch_in_epoch": batch_in_epoch, "step": state.step},
        )

    try:
        for epoch in range(start_epoch, num_epochs):
            pipe.set_epoch(epoch)
            t0 = time.time()
            n_iter = 0
            batches = _prefetch(pipe)
            if epoch == start_epoch and start_batch:
                # the pipeline is deterministic given (seed, epoch): skipping
                # the consumed batches reproduces the stream
                for _ in range(start_batch):
                    next(batches, None)
                n_iter = start_batch
                logger.info("fast-forwarded %d batches (mid-epoch resume)", start_batch)
            stopped = False
            pending: List[Dict] = []
            for batch in batches:
                if loop_steps > 1:
                    pending.append(batch)
                    if len(pending) < loop_steps:
                        continue
                    metrics = step_fn(state, _to_device(_stack(pending), device))
                    # the group's metrics: report the last step's
                    metrics = {k: v[-1] for k, v in metrics.items()}
                    pending = []
                    n_iter += loop_steps
                else:
                    metrics = step_fn(state, _to_device(batch, device))
                    n_iter += 1
                if n_iter % log_interval < loop_steps:
                    loss, acc = float(metrics["loss"]), float(metrics["acc"])
                    meter.update(audio_s_per_batch * log_interval, log_interval)
                    logger.info(
                        "epoch %d iter %d loss %.4f acc %.4f lr %.6f margin %.3f (%.0f audio-s/s)",
                        epoch, n_iter, loss, acc, metrics["lr"], metrics["margin"],
                        meter.audio_seconds_per_s,
                    )
                    mlog.log(state.step, epoch=epoch, loss=loss, acc=acc, lr=metrics["lr"],
                             margin=metrics["margin"], audio_s_per_s=meter.audio_seconds_per_s)
                if save_batch_interval and config.get("save_optimizer", False) \
                        and n_iter % save_batch_interval < loop_steps:
                    save_full_state(epoch, n_iter)
                if stop_at_step is not None and state.step >= int(stop_at_step):
                    stopped = True
                    if config.get("save_optimizer", False):
                        save_full_state(epoch, n_iter)
                    logger.info("stop_at_step %d reached (epoch %d batch %d)",
                                int(stop_at_step), epoch, n_iter)
                    break
                if n_iter >= epoch_iter:
                    break
            batches.close()
            if stopped:
                return state
            for tail in pending:  # the batches left over (< loop_steps)
                flush_fn(state, _to_device(tail, device))
                n_iter += 1
            logger.info("epoch %d done: %d iters in %.1fs", epoch, n_iter, time.time() - t0)
            if (epoch + 1) % save_interval == 0 or epoch + 1 == num_epochs:
                path = os.path.join(exp_dir, "models", f"model_{epoch + 1}.pt")
                save_checkpoint(path, speaker_state_dict(net),
                                meta={"epoch": epoch + 1, "step": state.step})
                logger.info("saved %s", path)
                if config.get("save_optimizer", False):
                    save_full_state(epoch + 1, 0)
    finally:
        mlog.close()
    return state


def _prefetch(pipe, depth: int = 4):
    """Iterate `pipe` on a host thread through a bounded queue; a failure in
    the thread is raised here.  Closing the generator stops the thread."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    failure = []
    done = object()

    def produce():
        try:
            for b in pipe:
                while not stop.is_set():
                    try:
                        q.put(b, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised below
            failure.append(e)
        finally:
            while True:
                try:
                    q.put(done, timeout=0.1)
                    return
                except queue.Full:
                    if stop.is_set():
                        return

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    try:
        while True:
            b = q.get()
            if b is done:
                break
            yield b
        if failure:
            raise failure[0]
    finally:
        stop.set()
        thread.join()


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*", help="a.b.c=value config overrides")
    args = p.parse_args()
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    # float32 means float32: no TF32 in cuDNN convolutions or matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train(parse_config_or_kwargs(args.config, overrides=args.overrides), device=args.device)


if __name__ == "__main__":
    main()
