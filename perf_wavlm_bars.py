"""The readings behind chip_smoke.py's WavLM bf16 bars, over both batch
orders and two training seeds.

For each (num_workers, seed) in RUNS, `chip_smoke.phase_wavlm_recipe` runs
recipes.voxceleb_v2_wavlm stages 1-3 at full width on the card
(ecapa_tdnn_wavlm_frozen.yaml; num_workers 8 trains on the C++ loader, as
the config asks, 0 on TrainPipeline) with `seed=<seed>`, then its checks on
the stage-3 embeddings and a bf16 stage-2 step against the float32 one, for
the batches of STEP_SEEDS.  Each reading is kept beside its control,
whether or not the phase's bars held:

- 1 - cosine, bf16 on the card against float32 on the CPU (worst of 16
  utterances), bf16 with K2 against bf16 with plain attention, and bf16
  with plain attention against the CPU; controls: K2 with each row's last
  1, 8 or 32 valid keys masked, against plain attention and against the
  CPU;
- the stage-2 loss, bf16 against float32 (relative); control: the norm
  statistics in bf16;
- the stage-2 update, relative L2; control: no float32 master weights.

    python3 perf_wavlm_bars.py [WORKERS:SEED ...]

(default: every run of RUNS) needs one H100, prints a JSON line per run and
a summary line, and writes chiprun_out/wavlm_bars.json.  A run writes about
11 GB of WavLM-Large checkpoints, and the card's machine stops a command
past 45 GiB written, so give it at most three runs a call.  Imports no JAX.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

import chip_smoke

RUNS = ((8, 42), (8, 7), (0, 42), (0, 7))  # (num_workers, the config's seed)
STEP_SEEDS = (7, 11, 13)
MASKED_KEYS = (1, 8, 32)  # K2's control: the last 1, 8 or 32 valid keys of each row masked
OUT = Path(__file__).resolve().parent / "chiprun_out" / "wavlm_bars.json"


def readings(report):
    emb = report["wavlm_recipe"]["stage3_embeddings"]
    step = report["wavlm_recipe"]["bf16_vs_f32_step"]
    gap = {k: 1.0 - emb[k]["min_cosine"] for k in (
        "bf16", "bf16_k2_vs_plain", "bf16_plain_vs_cpu", "f32",
        *(f"control_keys_masked_{n}{v}" for n in MASKED_KEYS for v in ("", "_vs_cpu")))}
    return {"emb_1_minus_cos": gap,
            "steps": [{k: r[k] for k in ("seed", "loss", "loss_rel", "control_loss_rel",
                                         "updates_rel_l2", "control_updates_rel_l2")}
                      for r in step["steps"]]}


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("perf_wavlm_bars: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.phase_build({})
    chip_smoke.WAVLM_STEP_SEEDS = STEP_SEEDS
    chip_smoke.WAVLM_MASKED_KEYS = MASKED_KEYS
    results = {"device": chip_smoke.nvidia_smi_line(), "runs": []}
    from wespeaker_hubert_tpu_torch.recipes import voxceleb_v2

    with tempfile.TemporaryDirectory() as top:
        data = os.path.join(top, "data")  # phase_recipe's data, shared by the runs
        chip_smoke.write_recipe_data(data)
        voxceleb_v2.main(["--stage", "1", "--stop_stage", "2", "--config",
                          str(chip_smoke.RECIPE_CONFIG), "--data_root", data, "--device", "cuda"])
        runs = [tuple(int(x) for x in a.split(":")) for a in argv] or RUNS
        for workers, seed in runs:
            root = os.path.join(top, f"w{workers}_s{seed}")
            os.makedirs(root)
            os.symlink(data, os.path.join(root, "data"))
            chip_smoke.WAVLM_EXTRA = [f"seed={seed}", f"dataloader_args.num_workers={workers}"]
            report, t0 = {}, time.perf_counter()
            try:
                chip_smoke.phase_wavlm_recipe(report, root)
                failed = None
            except Exception as e:  # noqa: BLE001 — the readings taken so far are kept
                failed = f"{type(e).__name__}: {str(e)[:400]}"
            try:
                got = readings(report)
            except KeyError as e:
                got = {"emb_1_minus_cos": {}, "steps": [], "missing": str(e)}
            run = {"num_workers": workers, "seed": seed, "phase_failed": failed,
                   "s": time.perf_counter() - t0, **got}
            results["runs"].append(run)
            print("WAVLM_BARS " + json.dumps(run), flush=True)
            chip_smoke.NET_TEMPLATES.clear()
    runs = [r for r in results["runs"] if r["steps"]]
    results["summary"] = {
        **{f"emb_bf16_vs_cpu_masked_{n}": [
            max(r["emb_1_minus_cos"]["bf16"] for r in runs),
            min(r["emb_1_minus_cos"][f"control_keys_masked_{n}_vs_cpu"] for r in runs)]
           for n in MASKED_KEYS},
        **{f"emb_k2_vs_plain_masked_{n}": [
            max(r["emb_1_minus_cos"]["bf16_k2_vs_plain"] for r in runs),
            min(r["emb_1_minus_cos"][f"control_keys_masked_{n}"] for r in runs)]
           for n in MASKED_KEYS},
        "step_loss": [max(s["loss_rel"] for r in runs for s in r["steps"]),
                      min(s["control_loss_rel"] for r in runs for s in r["steps"])],
        "step_updates": [max(s["updates_rel_l2"] for r in runs for s in r["steps"]),
                         min(s["control_updates_rel_l2"] for r in runs for s in r["steps"])],
        "form": "[largest sound reading, smallest control]"}
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(results, indent=1))
    print("WAVLM_BARS_SUMMARY " + json.dumps(results["summary"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
