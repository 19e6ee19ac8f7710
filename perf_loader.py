"""What the host loader costs stage 3 of the flagship recipe, at the
config's own loop_steps, and where that cost comes from.

On chip_smoke.py's recipe data (1,536 utterances of 2.5-7.95 s in two
shards, phase_recipe's), with examples/voxceleb/v2/conf/ecapa_tdnn.yaml at
full width (ECAPA_TDNN_GLOB_c512, 3 x 5,994 classes, 128 x 2 s, float32):

- host only, no training: one epoch of bin/train's pipeline for each
  `num_workers` in WORKERS (8, 4, 2: the C++ loader in that many threads;
  0: TrainPipeline), ms per batch, and for the C++ loader the same epoch of
  its bare C++ batches (decode, filter, chunk, speed draw) without the
  Python draws of the packed augmentation rows;
- training: bin/train for TRAIN_EPOCHS epochs of one call of loop_steps 8
  steps (the config's loop_steps) for each `num_workers` in TRAIN_WORKERS,
  the same seed; over calls 2 to TRAIN_EPOCHS (from the end of call 1 to
  the end of the last, no synchronize between): ms per step, the device's
  idle share (torch.profiler's busy time over the window's wall), and the
  seconds the training thread waited on the loader's queue.

    python3 perf_loader.py

needs one H100; prints one JSON line per measurement and writes
chiprun_out/loader_cost.json.  Imports no JAX.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

import chip_smoke

WORKERS = (8, 4, 2, 0)
TRAIN_WORKERS = (8, 2, 0)
TRAIN_EPOCHS = 5  # 4 timed calls of 8 steps: 32 steps
OUT = Path(__file__).resolve().parent / "chiprun_out" / "loader_cost.json"


def config_for(data, exp, workers, extra=()):
    from wespeaker_hubert_tpu_torch.utils.config import apply_overrides, load_config

    return apply_overrides(load_config(str(chip_smoke.RECIPE_CONFIG)), [
        f"exp_dir={exp}", f"train_data={data}/vox2_dev/shard.list",
        f"train_label={data}/vox2_dev/utt2spk",
        f"dataset_args.reverb_data={data}/rirs_aug_store",
        f"dataset_args.noise_data={data}/musan_aug_store",
        f"dataloader_args.num_workers={workers}", *extra])


def host_only(data, root, workers):
    from wespeaker_hubert_tpu_torch.bin.train import train_pipeline

    pipe, _, _ = train_pipeline(config_for(data, os.path.join(root, "host"), workers))
    out = {"num_workers": workers, "pipeline": type(pipe).__name__}
    for epoch in (0, 1):  # epoch 0 warms the file cache; epoch 1 is kept
        pipe.set_epoch(epoch)
        t0 = time.perf_counter()
        n = sum(1 for _ in pipe)
        out["batches"], out["ms_per_batch"] = n, 1e3 * (time.perf_counter() - t0) / n
    if hasattr(pipe, "_loader"):
        t0 = time.perf_counter()
        n = sum(1 for _ in pipe._loader.epoch(1))
        out["cxx_only_ms_per_batch"] = 1e3 * (time.perf_counter() - t0) / n
        pipe.close()
    return out


def training(data, root, workers, run):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from wespeaker_hubert_tpu_torch.bin import train as bin_train

    config = config_for(data, os.path.join(root, f"exp_{run}_{workers}"), workers, [
        f"num_epochs={TRAIN_EPOCHS}", "epoch_iter=8", "loop_steps=8",
        "save_epoch_interval=1000", "log_batch_interval=1000"])
    marks, waits = {"calls": 0}, []
    make, prefetch = bin_train.make_train_step, bin_train._prefetch

    def timed_make(*args, **kwargs):
        fn = make(*args, **kwargs)
        if kwargs.get("num_steps", 1) == 1:
            return fn  # the tail step: no epoch here leaves a tail

        def step(state, batch):
            got = fn(state, batch)
            marks["calls"] += 1
            if marks["calls"] == 1:
                torch.cuda.synchronize()
                marks["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                    ProfilerActivity.CUDA])
                marks["prof"].__enter__()
                marks["t0"] = time.perf_counter()
            elif marks["calls"] == TRAIN_EPOCHS:
                torch.cuda.synchronize()
                marks["t1"] = time.perf_counter()
                marks["prof"].__exit__(None, None, None)
            return got
        return step

    def timed_prefetch(pipe, *args, **kwargs):
        it = prefetch(pipe, *args, **kwargs)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    b = next(it)
                except StopIteration:
                    return
                if "t0" in marks and "t1" not in marks:
                    waits.append(time.perf_counter() - t0)
                yield b
        finally:
            it.close()

    bin_train.make_train_step, bin_train._prefetch = timed_make, timed_prefetch
    try:
        bin_train.train(config, device="cuda")
    finally:
        bin_train.make_train_step, bin_train._prefetch = make, prefetch
    window_us = (marks["t1"] - marks["t0"]) * 1e6
    busy, _ = chip_smoke.device_busy_us(marks["prof"])
    steps = 8 * (TRAIN_EPOCHS - 1)
    return {"num_workers": workers, "steps": steps, "step_ms": window_us / 1e3 / steps,
            "device_idle_share": 1 - busy / window_us, "loader_wait_s": sum(waits),
            "window_s": window_us / 1e6}


def main():
    import torch

    if not torch.cuda.is_available():
        print("perf_loader: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.phase_build({})
    from wespeaker_hubert_tpu_torch.recipes import voxceleb_v2

    results = {"device": chip_smoke.nvidia_smi_line(), "host_cpus": os.cpu_count(),
               "torch_threads": torch.get_num_threads(), "host_only": [], "training": []}
    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "data")
        chip_smoke.write_recipe_data(data)
        voxceleb_v2.main(["--stage", "1", "--stop_stage", "2", "--config",
                          str(chip_smoke.RECIPE_CONFIG), "--data_root", data, "--device", "cuda"])
        for workers in WORKERS:
            r = host_only(data, root, workers)
            results["host_only"].append(r)
            print("LOADER_HOST " + json.dumps(r), flush=True)
        for run, order in enumerate((TRAIN_WORKERS, TRAIN_WORKERS[::-1])):  # both orders
            for workers in order:
                r = training(data, root, workers, run)
                results["training"].append(r)
                print("LOADER_TRAIN " + json.dumps(r), flush=True)
                torch.cuda.empty_cache()
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
