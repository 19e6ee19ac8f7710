#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (wespeaker_hubert_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases:
  1. the card: `nvidia-smi` name and power limit, torch.cuda device name;
  2. build every CUDA kernel of the served path from the sources in
     wespeaker_hubert_tpu_torch/csrc (nvcc, at first use);
  3. each kernel against its plain PyTorch version on the card, at the
     served shapes, with the stated tolerance, and both timed (CUDA events,
     warm, median of 25); K1 also against the plain rFFT path (cuFFT and the
     mel matmul), its yardstick, timed beside it;
  4. the served slice at full width: ECAPA_TDNN_GLOB_c512 (80 mels, 192-d)
     with seeded random weights behind the port's EmbeddingService and HTTP
     server, in bf16 and in float32.  Requests: /embed at 1.3, 5, 12 and
     30 s, 8 concurrent /similarity, KServe WAV infer, feature_extractor,
     speaker_model and /stats.  Every result is held against the port's
     plain path on the CPU in float32 with the same weights, and the kernel
     launch counters must have grown during the requests;
  5. timings of the served path: bursts of 64 concurrent 10 s requests
     (audio-s/s, and the device's idle share of one burst from a
     torch.profiler trace), make_chunked_embed at 16 x 30 s with the fbank
     kernel and with the plain fbank, and a torch.profiler breakdown of one
     batch;
  6. the bf16 margin: cosines of 1.3 s utterances over 16 audio seeds and 3
     weight seeds, bf16 on the card against float32 on the CPU;
  7. K2, the flash-attention kernel, against its plain version on the card
     at the SSL path's shapes ((16, 499, 16, 64) with WavLM's gated bias in
     factored form, an (h, T, T) table and a (B, h, T) gate, the 32 s bucket
     (16, 1599, 16, 64), the training shape (64, 75), no bias with key
     lengths, odd T, a broadcast bias), bf16 and float32, timed (the kernel's
     device time from torch.profiler, events around the wrapper, the
     wrapper's host time) beside its plain version and beside
     scaled_dot_product_attention on the materialized bias (the library
     yardstick, which the port never calls) and the materialization;
  8. the SSL extraction slice at full width: WavLM-Large (24 layers, 1024
     wide, 16 heads, flash attention) + ECAPA_TDNN_GLOB_c512 with seeded
     random weights through bin/extract.extract on 24 seeded wavs of
     1.5-20 s, bf16 and float32.  K2 must launch 24 times per device batch;
     float32 on the card is held against the port on the CPU, and bf16 with
     K2 against bf16 with plain attention;
  9. timings of that slice: the entry point's audio-s/s, make_eval_embed at
     16 x 10 s in bf16 with K2 and with plain attention, and a
     torch.profiler breakdown of one batch;
 10. K2's backward kernels (dK/dV, dQ + dBias) against their plain version
     at the training shape (64, 75, 16, 64) with the factored gated bias,
     the extraction shape (16, 499, 16, 64), no bias with key lengths, a
     broadcast (B, 1, 1, T) bias, odd T and the 32 s bucket, bf16 and
     float32, timed beside the plain backward and
     scaled_dot_product_attention's forward + backward;
 11. the joint fine-tuning slice at full width: bin/train.train on
     examples/voxceleb/v2/conf/ecapa_tdnn_wavlm_joint_ft.yaml (WavLM-Large
     unfrozen + ECAPA_TDNN_GLOB_c512 + ArcMargin, batch 64, 1.5 s chunks,
     speed perturbation, packed reverb / noise, SpecAug, bf16, flash
     attention) on seeded wavs for 6 steps: K2's forward, dK/dV and dQ
     launch 24 times per step, the losses are finite, LR and margin follow
     their schedules, models/model_1.pt loads into bin/extract.  Then one
     float32 step with K2 against one with plain attention (batch 64), one
     on the card against the CPU (batch 2), and a profile of 3 bf16 steps;
 12. the flagship speaker-verification recipe at full width:
     recipes.voxceleb_v2 stages 1-7 on examples/voxceleb/v2/conf/
     ecapa_tdnn.yaml as the port's YAML reader parses it
     (ECAPA_TDNN_GLOB_c512, ArcMargin over 3 x 5,994 classes, batch 128 x
     2 s, loop_steps 8, tar shards, dither 1.0, float32), overriding only the
     paths and the run's length (2 epochs of 12 steps, a checkpoint per
     epoch, 2 averaged), on seeded wavs: aug stores, shards and lists,
     training, averaging and extraction (K1 launches in stage 4 only),
     cosine scores, AS-Norm and QMF, each printing its EER and minDCF; K1
     on every input stage 4 gave it against its plain version, 16 of the
     stage-4 embeddings against bin/extract on the CPU and the stage 5 / 6
     score files recomputed on the CPU; then 3 profiled float32 steps of
     that config;
 13. one float32 step of that model (17,982 classes, batch 32 x 2 s, dither
     0, SpecAug off) on the card against the CPU, and a 2-step call against
     two single steps on the card;
 14. the ResNet34 recipe: recipes.voxceleb_v2 stages 1-9 on
     examples/voxceleb/v2/conf/resnet34.yaml and resnet_lm.yaml as the
     port's reader parses them (ResNet34, 32 channels, 80 mels, 256-d,
     TSTP, ArcMargin over 3 x 5,994 classes, batch 128 x 2 s, float32; the
     large-margin fine-tune at batch 64 x 6 s, margin 0.5, from the base
     run's averaged model), overriding only the paths and the run's length
     (2 epochs of 2 steps; lm 1 epoch of 2 steps), on phase 12's data:
     training, averaging, extraction (K1 on every stage-4 input against its
     plain version), scoring, export of the model directory and its
     torch.export program (stage 8), each twice; 16 stage-4 embeddings
     and the score files against the CPU, the program against the eager
     model on the card, the exported directory through cli.speaker.Speaker,
     and 3 profiled base steps;
 15. one float32 ResNet34 step (batch 16 x 2 s) on the card against the
     CPU;
 16. bin/score at VoxCeleb1-O's and VoxCeleb1-H's sizes on seeded
     embeddings (5,994-speaker cohort, top 300), card against CPU, timed;
 17. the Whisper-PMFA recipe: recipes.voxceleb_v1_whisper_pmfa stages 2-7
     on examples/voxceleb/v1/Whisper-PMFA/conf/whisper_pmfa_stage0.yaml and
     whisper_pmfa_stage1.yaml as the port's reader parses them
     (Whisper-large-v2 as the JAX package defines it: 24 blocks of 1,280,
     20 heads of 64, layers 16-23 concatenated, ln_post2; the PMFA head,
     ArcMargin over 3 x 1,211 classes, SGD with Nesterov momentum, float32)
     with attn_impl flash, overriding only the paths, a seeded 32-block
     OpenAI-layout checkpoint for stage 3 and the run's length (3 frozen
     steps at batch 64 x 5 s, 4 joint steps at batch 16), on seeded
     speech-like wavs: K2's float32 kernels launch 24 times per step and
     per extraction batch (asserted per stage); the frozen encoder stays
     bitwise as imported; 3 stage-5 embeddings (one past the 30 s cut)
     against bin/extract on the CPU; a profile of stage 5's extraction; one
     stage-4 step (batch 4) on the card against the CPU and a float64 step;
     3 profiled stage-4 steps.  Phases 7 and 10 also hold K2 at Whisper's
     shapes ((16, 1500) and (64, 251) forward, (16, 251) backward; 20 heads,
     scale 1.0, no bias, float32 and bf16), timed beside
     scaled_dot_product_attention (the backward also alone, its backend
     pinned), and in float32 with the logits scaled to max |S| = 40: the
     forward against the plain version, the backward as a whole (kernel
     pipeline and plain pipeline each against float64, 3 seeds).  K2's
     float32 forward, dK/dV and dQ run 3xTF32 on wgmma.
 18. the CAM++ recipe: recipes.voxceleb_v2 stages 1-9 on
     examples/voxceleb/v2/conf/campplus.yaml and campplus_lm.yaml (CAMPPlus,
     80 mels, 512-d, TSTP, batch 128 x 2 s, loop_steps 8, float32; the lm
     fine-tune at 64 x 6 s, margin 0.5) with phase 14's checks (2 epochs of
     8 steps, 2 lm steps), on
     phase 12's data;
 19. the WavLM staged recipe: recipes.voxceleb_v2_wavlm stages 1-3 on
     ecapa_tdnn_wavlm_frozen.yaml (WavLM-Large + ECAPA_TDNN_GLOB_c512,
     batch 64 x 3 s, 6 s in stage 3, bf16 through enable_amp, flash
     attention) for 6 frozen, 4 joint and 2 large-margin steps on phase 12's
     shards: K2's bf16 launches per stage, the frozen encoder bitwise
     through stage 1, each stage from the previous average (stage 3's head
     fresh), 16 stage-3 embeddings through bin/extract (float32 on the card
     against the CPU, bf16 against the CPU's float32 at cosine 0.9998, bf16
     with K2 against bf16 with plain attention), a bf16 stage-2 step against
     the float32 step with a fault control for each bar, and 3 profiled
     stage-3 steps;
 20. ERes2Net34_Base and Res2Net34_Base at full width: one float32 step on
     the card against the CPU, eval embeddings through K1 against the CPU,
     and 2 timed steps at 128 x 2 s; also REPVGG_TINY_A0 (with its
     deploy form from convert_repvgg_params against the training form),
     XVEC, XI_VEC_ECAPA_TDNN_c512, Gemini_DF_ResNet114 with its AdamW, and
     SimAM_ResNet34_ASP (resnet34.yaml with the model swapped: no config
     names it), the timed steps at each config's batch;
 21. the ReDimNet recipe: recipes.voxceleb_v2 stages 1-8 on redimnet.yaml
     (ReDimNetB2, 72 mels, ASTP, 192-d, batch 256 x 2 s, loop_steps 8,
     float32; no lm config) with phase 14's checks (2 epochs), K1 at 72 mels
     (phase 3 holds it at ReDimNet's stage-4 shapes too);
 22. the Gemini recipe: stages 1-9 on gemini_dfresnet_adam.yaml (AdamW,
     weight decay 0.05, batch 128 x 2 s, margin 0.2) and
     gemini_dfresnet_sgd_lm.yaml (SGD from the AdamW run's average, 32 x 6
     s, margin 0.5) with phase 14's checks (2 epochs of 8 steps, 4 lm
     steps);
 23. DINO: recipes.voxceleb_v3_dino (examples/voxceleb/v3/dino/run.py) with
     --model ECAPA_TDNN_GLOB_c1024, batch 64 of 2 x 200 + 4 x 100-frame
     crops, the 65,536-way head, SGD, float32, both aug stores, 2 epochs of
     4 steps (the first inside the last layer's freeze) on phase 12's data:
     finite losses, the four schedules, the freeze's closed form, the
     teacher's and the centre's EMA, the epoch checkpoints into bin/extract's
     net and the fine-tune's, a step card against CPU (batch 2), 3 profiled
     steps, the peak memory, and bench.py's DINO row (ECAPA_TDNN_c512,
     batch 64) in bf16 and float32;
 24. the CN-Celeb fine-tune: recipes.cnceleb_v3_finetune stages 2-6 on
     examples/cnceleb/v3_finetune/conf/ecapa_tdnn_ft.yaml
     (ECAPA_TDNN_GLOB_c1024, ArcMargin over 3 x 2,800 classes, batch 128 x
     2 s) from phase 23's averaged teacher, on phase 12's wavs laid out as
     cnceleb_train / eval with the two trial files: only `projection.*`
     missing at load, K1 on every stage-4 input, embeddings and score files
     against the CPU;
 25. MoCo and SimCLR: recipes.voxceleb_v3_contrastive stages 2-6 on
     examples/voxceleb/v3/{moco,simclr}/conf/ecapa_tdnn.yaml
     (ECAPA_TDNN_GLOB_c512, batch 128 x 2 views x 2 s, K 65,536), 2 epochs
     of 2 steps each: MoCo's pointer and queue rows per step, K1 on every
     stage-4 input, embeddings and score files against the CPU, a step of
     each card against CPU (batch 4, the full queue), 3 profiled steps of
     each.
 26. diarization at ResNet34's full width (resnet34.yaml: 80 mels, TSTP,
     256-d, float32) with seeded weights and seeded Silero parameters
     (the model directory's vad.npz), on constructed conversations of 2-4
     speakers (alternating tones of 1-3 s, zero gaps of 0.4-0.9 s) with
     exact reference RTTMs: recipes.voxconverse_v2 (spectral and density)
     and recipes.voxconverse_v1 (oracle and Silero SAD) over 4
     conversations of 120-600 s, printing DER at collar 0.25 (reported, not
     gated: the weights are random); K1 on every segment bucket of one
     conversation against its plain version; window embeddings and labels
     of a 60 s conversation card against CPU; Silero card against CPU
     within 1e-5; 8 concurrent /diarize posts of 60-300 s and a KServe
     `run` infer equal to a direct diarize_pcm_batch, that equal to
     sequential diarize_pcm (energy VAD, then Silero); a 2,700 s
     conversation (>= 2,000 windows) through the spectral path on the card
     and on the host at its 4 speakers, eigh timed on both.

 27. the NIST SRE recipes at ResNet34's full width on 8 kHz audio with 64
     mels (resnet34.yaml + dataset_args.resample_rate 8000): recipes.sre_v2
     stages 1-7 (2 epochs of 2 steps of 128 x 200 frames; extraction of the
     four sets, cosine, PLDA and adapted PLDA scores, the export and its
     torch.export program), bin/infer_export on that program against
     bin/extract (cosine >= 0.99999), bin/tools compute_feats, and
     recipes.sre_v3 stages 1-2 and 4-8 (CTS key, energy-VAD system SAD,
     voiced-duration filter, aug copies; the chain, the in-domain mean,
     adaptation) on seeded speech-like wavs, K1 counted in each stage 4,
     compute_feats and infer_export and held to its plain version on every
     input there; then the float64 PLDA back end at the SRE16 /
     CTS-superset size (1,817,280 x 256 training rows of 6,867 speakers,
     2,272 in-domain rows, 1,200 models, 9,300 test segments, 2,000,000
     trials) on seeded Gaussian embeddings, each step timed with its peak
     memory and host share, adaptation lowering the EER on the shifted
     set; and at a cut size (700 speakers, 60,900 rows, 200,000 trials) on
     the card against the CPU.

A kernel's bound is the least time the card could take for the work the
function needs (for log-mel: an FFT and a sparse mel product; for
attention: the valid keys of each row), against the H100 SXM's published
peaks.

It prints one JSON line of kernels, the card's name and power limit, and as
its last line {"ok": true, "device": {...}}; details go to
chiprun_out/chip_smoke.json.  It exits non-zero, and prints no result, when
there is no CUDA device, when the port is not importable, or when any phase
fails.  TF32 is off for every phase (cuDNN convolutions default to it).
"""

import copy
import json
import logging
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

SR = 16000
FBANK_TOL = dict(rtol=1e-4, atol=2e-3)
COS_MIN = {"f32": 0.99999, "bf16": 0.9999}
# H100 SXM published peaks (dense): float32 outside the tensor cores, bf16
# on the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
MODEL = "ECAPA_TDNN_GLOB_c512"
WEIGHT_SEED = 20251016
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    lines = proc.stdout.strip().splitlines()
    return lines[0].strip() if proc.returncode == 0 and lines else "nvidia-smi unavailable"


def cuda_median_ms(fn, reps=25, warmup=3):
    """Median of per-call device times (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def host_median_ms(fn, reps=10, warmup=2):
    """Median wall time of fn() followed by a device synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# K1's earlier (dense-DFT) kernel at (16, 480000), from PERF.md's kernel table
# (H100 80GB HBM3, 700.00 W): not measured by this script.  Printed in the [K1] log line and kept under report["k1_history"],
# never in the kernels line.
K1_DENSE_DFT_MS = {(16, 480000): 1.1598}


def fbank_bound(b, w, cfg):
    """The least time log-mel of (b, w) can take, from the work the function
    needs (an rFFT and the sparse mel product).

    Operations per frame: the preprocessing (int16 scale, DC mean and
    removal, pre-emphasis, window: 5 per sample), a real FFT of
    N = fft_size (2.5 N log2 N), the power (3 per bin), the mel product over
    the filters' nonzeros (2 each) and the log (1 per mel), in float32.
    Bytes: the wav read once, the filters' nonzeros read once, the log-mel
    written once.  Returns (bound_ms, bound_by, flop, bytes, dense_flop),
    where dense_flop is the dense-DFT work the earlier kernel did."""
    from wespeaker_hubert_tpu_torch.ops.signal import mel_banks

    L, n, m = cfg.frame_length, cfg.fft_size, cfg.num_mel_bins
    nb = n // 2 + 1
    nnz = int(np.count_nonzero(mel_banks(m, n, float(cfg.sample_rate),
                                         cfg.low_freq, cfg.high_freq)))
    t = 1 + (w - L) // cfg.frame_shift
    flop = b * t * (5 * L + 2.5 * n * math.log2(n) + 3 * nb + 2 * nnz + m)
    dense_flop = b * t * (2 * L * nb * 2 + 2 * nb * m)
    nbytes = 4 * (b * w + nnz + b * t * m)
    ops_ms = flop / PEAK_F32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    return max(ops_ms, bytes_ms), bound_by, flop, nbytes, dense_flop


def fbank_float64(wav, cfg):
    """Log-mel of (B, W) in float64 on the card, the plain rFFT path's steps
    (int16 scale, DC removal, pre-emphasis, window, rFFT, power, mel, log):
    the yardstick of K1's, the plain version's and the rFFT path's float32
    errors."""
    from wespeaker_hubert_tpu_torch.ops.fbank import frame_signal
    from wespeaker_hubert_tpu_torch.ops.signal import mel_banks, window_function

    x = frame_signal(wav.double() * 32768.0, cfg.frame_length, cfg.frame_shift)
    x = x - x.mean(-1, keepdim=True)
    x = x - cfg.preemph_coeff * torch.cat([x[..., :1], x[..., :-1]], -1)
    x = x * torch.from_numpy(window_function(cfg.window_type, cfg.frame_length)).to(x)
    spec = torch.fft.rfft(x, n=cfg.fft_size)
    mel = torch.from_numpy(mel_banks(cfg.num_mel_bins, cfg.fft_size, float(cfg.sample_rate),
                                     cfg.low_freq, cfg.high_freq).astype(np.float64)).to(x)
    power = spec.real ** 2 + spec.imag ** 2
    return torch.log(torch.clamp_min(power @ mel, float(np.finfo(np.float32).eps)))


def device_events(prof):
    """(name, start us, end us) of a torch.profiler run's device events
    (kernels, copies, memsets; not the ranges that record_function marks on
    the device's timeline), read from its Kineto results: prof.events() and
    key_averages() first build the whole host-side event tree, many seconds
    of host time for a model of many small kernels."""
    cached = getattr(prof, "_device_events", None)
    if cached is None:
        cached = [(ev.name(), ev.start_ns() / 1e3, (ev.start_ns() + ev.duration_ns()) / 1e3)
                  for ev in prof.profiler.kineto_results.events()
                  if ev.device_type() == torch.autograd.DeviceType.CUDA
                  and not ev.is_user_annotation()]
        prof._device_events = cached
    return cached


def device_busy_us(prof):
    """Union of the device-event intervals of a torch.profiler run (us)."""
    spans = sorted((s, e) for _, s, e in device_events(prof) if e > s)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, len(spans)


def audio(seed, seconds):
    """Seeded tones + noise on the int16 grid (a PCM16 WAV round trip is
    exact), float32 in [-1, 1]."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    x = 0.02 * rng.standard_normal(n)
    for f in rng.uniform(80, 3000, 4):
        x += 0.1 * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
    return (np.round(np.clip(x, -1, 1) * 32767) / 32768).astype(np.float32)


def wav_bytes(x):
    import io
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(np.round(x * 32768).astype("<i2").tobytes())
    return buf.getvalue()


def seeded_state_dict(model, seed):
    """Random weights from a numpy generator: lecun-normal conv / linear
    weights, small biases, BN statistics and affine parameters near 0 / 1."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros_like(v)
            continue
        if k.endswith("running_var"):
            x = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("running_mean") or k.endswith(".bias"):
            x = rng.normal(0.0, 0.1, shape)
        elif len(shape) == 1:  # BN weight
            x = rng.uniform(0.8, 1.2, shape)
        else:
            x = rng.normal(0.0, float(np.prod(shape[1:])) ** -0.5, shape)
        sd[k] = torch.from_numpy(x.astype(np.float32))
    return sd


def cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def post(url, data, timeout=600):
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


# --------------------------------------------------------------- phases
def phase_build(report):
    """The kernels' nvcc runs start together (one thread each)."""
    from wespeaker_hubert_tpu_torch.ops import fbank_kernel
    from wespeaker_hubert_tpu_torch.ops import flash_attention as k2
    from wespeaker_hubert_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:  # builds csrc/*.cu unless already built
        for f in [pool.submit(fbank_kernel._library), pool.submit(k2._library),
                  pool.submit(k2._bwd_library)]:
            f.result()
    report["build_s"] = {"wall": time.perf_counter() - t0}
    report["ptxas"] = {}
    for name, (secs, out) in cuda_build.BUILD_LOG.items():
        report["build_s"][name] = secs
        lines, fn = [], ""
        for line in out.splitlines():  # each kernel's lines follow its entry
            if "Compiling entry function" in line:
                fn = _demangle(line.split("'")[1]) if "'" in line else ""
            elif ("registers" in line or "smem" in line or "spill" in line
                  or "warning" in line.lower()):
                lines.append(f"{fn}: {line.strip()}" if fn else line.strip())
        report["ptxas"][name] = lines
    # what the kernels compiled to: wgmma (HGMMA), mma.sync (HMMA), TMA loads
    # and stores (UTMALDG, UTMASTG), mbarrier waits (SYNCS) and cp.async
    # (LDGSTS) in the SASS
    report["sass"] = {}
    cuobjdump = Path("/usr/local/cuda/bin/cuobjdump")
    for name, sources in (("fbank", fbank_kernel._SOURCES), ("flash_attention", k2._SOURCES),
                          ("flash_attention_bwd", k2._BWD_SOURCES)):
        if not cuobjdump.exists():
            continue
        path = cuda_build.build_library(name, sources)  # built above: returns its path
        sass = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True,
                              text=True, timeout=120).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = {"HGMMA": 0, "HMMA": 0, "UTMALDG": 0, "UTMASTG": 0, "SYNCS": 0,
                              "LDGSTS": 0}
            elif fn is not None:
                for op in counts[fn]:
                    if op in line:
                        counts[fn][op] += 1
        report["sass"][name] = counts
        for fn, c in counts.items():
            log(f"[build]   {name} SASS {_demangle(fn)}: "
                + ", ".join(f"{k} {v}" for k, v in c.items()))
    log(f"[build] {report['build_s']['wall']:.1f} s wall for "
        + ", ".join(f"{n} {t:.1f} s" for n, t in report["build_s"].items() if n != "wall")
        + f" (nvcc {cuda_build.NVCC_FLAGS[1]}, in parallel)")
    for name, lines in report["ptxas"].items():
        for line in lines:
            log(f"[build]   {name}: {line}")


def _demangle(fn):
    """A kernel's name (and template argument) from its mangled SASS name."""
    for name in ("fbank_fft_kernel", "flash_fwd_bf16_sm90", "flash_fwd_f32_sm90",
                 "flash_bwd_dkv_bf16_sm90", "flash_bwd_dq_bf16_sm90", "flash_bwd_dkv_f32_sm90",
                 "flash_bwd_dq_f32_sm90"):
        if name in fn:
            tail = fn.split(name, 1)[1]
            arg = tail[tail.find("ILi") + 3:].split("E", 1)[0] if "ILi" in tail else ""
            return f"{name}<{arg}>" if arg else name
    return fn[:60]


def phase_kernel_checks(report):
    """K1 against its plain version and against the plain rFFT path (cuFFT
    and the dense mel product: K1's yardstick, not one PyTorch call), all
    timed."""
    from wespeaker_hubert_tpu_torch.ops import fbank_kernel
    from wespeaker_hubert_tpu_torch.ops.fbank import FbankConfig, fbank

    # the served shapes, then the recipe's stage-4 extraction shapes (full
    # batches of 32 in EvalPipeline's 400- and 800-frame buckets), then 40
    # mels, then ReDimNet's stage-4 shapes at its 72 mels, then the SRE
    # recipes' at 8 kHz (a 256-point FFT) and 64 mels; (b, w, mels, rate)
    cases = [(16, 480000, 80, SR), (16, 32000, 80, SR), (1, 32240, 80, SR),
             (32, 64240, 80, SR), (32, 128240, 80, SR), (16, 32000, 40, SR),
             (32, 64240, 72, SR), (32, 128240, 72, SR), (32, 32120, SRE_MELS, SRE_SR),
             (32, 64120, SRE_MELS, SRE_SR)]
    rows = []
    for i, (b, w, m, sr) in enumerate(cases):
        cfg = FbankConfig(num_mel_bins=m, sample_rate=sr, spectrum_impl="kernel")
        rng = np.random.default_rng(100 + i)
        wav = torch.from_numpy(
            (rng.standard_normal((b, w)) * 0.1).astype(np.float32)
        ).cuda()
        fft_cfg = FbankConfig(num_mel_bins=m, sample_rate=sr, spectrum_impl="fft")
        got = fbank_kernel.fbank_kernel(wav, cfg)
        torch.cuda.synchronize()
        want = fbank_kernel.fbank_kernel_reference(wav, cfg)
        fft = fbank(wav, fft_cfg)[0]
        err = float((got - want).abs().max())
        fft_err = float((got - fft).abs().max())
        # the rFFT path forms the pre-emphasized frame in float32, whose
        # rounding can move a rare low-energy filter past the bar against the
        # plain version (csrc/fbank.cu); K1 is held to the bar against it on
        # every element where that path itself meets it
        fft_off = ~torch.isclose(fft, want, **FBANK_TOL)
        k1_off_fft = ~torch.isclose(got, fft, **FBANK_TOL)
        ok = (bool(torch.allclose(got, want, **FBANK_TOL)) and bool(torch.isfinite(got).all())
              and not bool((k1_off_fft & ~fft_off).any()))
        fft_off_n = int(fft_off.sum())
        truth = fbank_float64(wav, cfg)
        vs64 = {name: float((x.double() - truth).abs().max())
                for name, x in (("kernel", got), ("plain", want), ("fft_path", fft))}
        del truth
        k_ms = cuda_median_ms(lambda: fbank_kernel.fbank_kernel(wav, cfg))
        p_ms = cuda_median_ms(lambda: fbank_kernel.fbank_kernel_reference(wav, cfg))
        l_ms = cuda_median_ms(lambda: fbank(wav, fft_cfg))
        bound_ms, bound_by, flop, nbytes, dense_flop = fbank_bound(b, w, cfg)
        row = dict(shape=[b, w], mels=m, sample_rate=sr, max_abs_err=err,
                   max_abs_err_vs_fft_path=fft_err,
                   fft_path_off_plain=fft_off_n,
                   fft_path_max_abs_err=float((fft - want).abs().max()),
                   max_abs_err_vs_float64=vs64, ok=ok, ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound_ms,
                   bound_by=bound_by, needed_gflop=flop / 1e9, mbytes=nbytes / 1e6,
                   earlier_dense_dft_gflop=dense_flop / 1e9, roofline_share=bound_ms / k_ms)
        rows.append(row)
        earlier = K1_DENSE_DFT_MS.get((b, w))
        log(f"[K1] ({b}, {w}) mels={m} rate={sr}: max|err|={err:.3e} against the plain version, "
            f"{fft_err:.3e} against the rFFT path {'ok' if ok else 'FAIL'} (rtol 1e-4, "
            f"atol 2e-3; the rFFT path {row['fft_path_max_abs_err']:.3e} from the plain "
            f"version, {fft_off_n} elements past the bar, where K1 is not held to it; "
            f"against float64: kernel {vs64['kernel']:.3e}, plain {vs64['plain']:.3e}, rFFT "
            f"path {vs64['fft_path']:.3e}); kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, cuFFT path (not one "
            f"call) {l_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: {flop / 1e9:.3f} "
            f"GFLOP needed, {nbytes / 1e6:.2f} MB), roofline share {bound_ms / k_ms:.4f}, "
            f"{flop / k_ms / 1e9:.2f} TFLOP/s of the work needed"
            + (f"; the earlier dense-DFT kernel ({dense_flop / 1e9:.2f} GFLOP) {earlier} ms "
               f"(PERF.md, not this run)" if earlier else ""))
        del wav, got, want, fft, fft_off, k1_off_fft
    report["fbank_checks"] = rows
    check(all(r["ok"] for r in rows), "fbank kernel disagrees with its plain version")
    return rows[0]


def write_model_dir(root, seed=WEIGHT_SEED):
    from wespeaker_hubert_tpu_torch.models.registry import get_speaker_model

    config = {
        "model": MODEL,
        "model_args": {"feat_dim": 80, "embed_dim": 192, "pooling_func": "ASTP"},
        "dataset_args": {"resample_rate": SR, "frontend": "fbank",
                         "fbank_args": {"num_mel_bins": 80, "frame_shift": 10,
                                        "frame_length": 25}},
    }
    model = get_speaker_model(MODEL)(**config["model_args"])
    sd = seeded_state_dict(model, seed=seed)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(config, f)
    torch.save(sd, os.path.join(root, "avg_model.pt"))
    return config


class CpuReference:
    """The port's plain path on the CPU in float32, same weights."""

    def __init__(self, model_dir):
        from wespeaker_hubert_tpu_torch.cli.speaker import Speaker
        from wespeaker_hubert_tpu_torch.train.chunked import make_chunked_embed
        from wespeaker_hubert_tpu_torch.train.executor import make_eval_embed

        self.speaker = Speaker(model_dir, device="cpu")
        self._chunked = make_chunked_embed(self.speaker.net, self.speaker.fbank_cfg, 198)
        self._eval = make_eval_embed(self.speaker.net)
        self._cache = {}

    def embed(self, wav, bucket):
        key = (wav.tobytes(), bucket)
        if key not in self._cache:
            padded = np.zeros((1, bucket), np.float32)
            padded[0, : len(wav)] = wav
            self._cache[key] = self._chunked({
                "wav": torch.from_numpy(padded),
                "length": torch.tensor([len(wav)], dtype=torch.int32),
            })[0].numpy()
        return self._cache[key]

    def features(self, wav, bucket):
        from wespeaker_hubert_tpu_torch.ops.fbank import fbank
        from wespeaker_hubert_tpu_torch.ops.feature_utils import apply_cmvn

        padded = np.zeros((1, bucket), np.float32)
        padded[0, : len(wav)] = wav
        feats, lens = fbank(torch.from_numpy(padded), self.speaker.fbank_cfg,
                            lengths=torch.tensor([len(wav)]))
        return apply_cmvn(feats, lengths=lens)[0, : int(lens[0])].numpy()

    def embed_feats(self, feats):
        t = len(feats)
        bucket = max(128, 1 << max(t - 1, 1).bit_length())
        pad = np.zeros((1, bucket, feats.shape[1]), np.float32)
        pad[0, :t] = feats
        return self._eval({"feat": torch.from_numpy(pad),
                           "feat_length": torch.tensor([t], dtype=torch.int32)})[0].numpy()


def drive_service(service, url, ref, tag, report):
    """The served requests of one service; returns the kernel launches they
    made.  Raises PhaseFailed when a result disagrees with the reference."""
    from wespeaker_hubert_tpu_torch.bin.serve import BOUNDARY
    from wespeaker_hubert_tpu_torch.ops import fbank_kernel

    cos_min = COS_MIN[tag]
    out = {"embed": [], "similarity": [], "kserve": {}}
    fbank_kernel.LAUNCHES = 0
    # /embed at 1.3, 5, 12 and 30 s
    for i, sec in enumerate((1.3, 5.0, 12.0, 30.0)):
        x = audio(1000 + i, sec)
        emb = np.asarray(post(url + "/embed", wav_bytes(x))["embedding"], np.float32)
        want = ref.embed(x, service.bucket_for(len(x)))
        c = cosine(emb, want)
        out["embed"].append({"seconds": sec, "cosine": c, "finite": bool(np.isfinite(emb).all())})
        check(emb.shape == (192,) and np.isfinite(emb).all(), f"{tag} /embed {sec}s: bad output")
        check(c >= cos_min, f"{tag} /embed {sec}s: cosine {c} < {cos_min}")
    # 8 concurrent /similarity
    pairs = [(audio(2000 + 2 * i, 2.0 + 0.5 * i), audio(2001 + 2 * i, 3.0)) for i in range(8)]
    with ThreadPoolExecutor(8) as pool:
        sims = list(pool.map(
            lambda p: post(url + "/similarity", wav_bytes(p[0]) + BOUNDARY + wav_bytes(p[1]))["similarity"],
            pairs,
        ))
    # the score's error follows from the embeddings' cosine bar
    sim_tol = 2 * math.sqrt(2 * (1 - cos_min))
    for (a, b), s in zip(pairs, sims):
        s_ref = (cosine(ref.embed(a, service.bucket_for(len(a))),
                        ref.embed(b, service.bucket_for(len(b)))) + 1) / 2
        out["similarity"].append({"served": s, "reference": s_ref})
        check(abs(s - s_ref) <= sim_tol, f"{tag} /similarity {s} vs {s_ref}")
    # KServe: WAV model
    x = audio(3000, 5.0)
    body = {"inputs": [{"name": "WAV", "shape": [1, len(x)], "datatype": "FP32",
                        "data": x.tolist()}]}
    r = post(url + "/v2/models/speaker/infer", json.dumps(body).encode())
    emb = np.asarray(r["outputs"][0]["data"], np.float32)
    c = cosine(emb, ref.embed(x, service.bucket_for(len(x))))
    out["kserve"]["speaker"] = c
    check(c >= cos_min, f"{tag} KServe speaker: cosine {c}")
    # feature_extractor: the CMN'd fbank through the kernel
    body = {"inputs": [{"name": "wav", "shape": [1, len(x)], "datatype": "FP32",
                        "data": x.tolist()}]}
    r = post(url + "/v2/models/feature_extractor/infer", json.dumps(body).encode())
    sp = r["outputs"][0]
    feats = np.asarray(sp["data"], np.float32).reshape(sp["shape"])
    want = ref.features(x, service.bucket_for(len(x)))
    ferr = float(np.abs(feats - want).max()) if feats.shape == want.shape else float("inf")
    out["kserve"]["feature_extractor_max_abs_err"] = ferr
    check(feats.shape == want.shape and np.allclose(feats, want, **FBANK_TOL),
          f"{tag} feature_extractor: max|err| {ferr}")
    # speaker_model: features -> embedding
    body = {"inputs": [{"name": "feats", "shape": list(feats.shape), "datatype": "FP32",
                        "data": feats.ravel().tolist()}]}
    r = post(url + "/v2/models/speaker_model/infer", json.dumps(body).encode())
    emb = np.asarray(r["outputs"][0]["data"], np.float32)
    c = cosine(emb, ref.embed_feats(want))
    out["kserve"]["speaker_model"] = c
    check(c >= cos_min, f"{tag} KServe speaker_model: cosine {c}")
    stats = get(url + "/stats")
    launches = fbank_kernel.LAUNCHES
    out["stats"] = stats
    out["fbank_launches"] = launches
    check(stats["total_steps"] >= 4 + 16 + 1, f"{tag} /stats: {stats}")
    check(launches > 0, f"{tag}: the served requests never launched the fbank kernel")
    log(f"[serve {tag}] /embed cosines "
        + ", ".join(f"{e['seconds']}s {e['cosine']:.7f}" for e in out["embed"])
        + f"; similarity max|d| {max(abs(s['served'] - s['reference']) for s in out['similarity']):.2e}"
        + f"; kserve speaker {out['kserve']['speaker']:.7f}, speaker_model "
        + f"{out['kserve']['speaker_model']:.7f}, features max|err| {ferr:.2e}"
        + f"; fbank kernel launches {launches}; device {stats['device']}")
    report[f"serve_{tag}"] = out
    return launches


def burst(url, n=64, seconds=10.0):
    """n concurrent /embed requests of `seconds` each -> served audio-s/s."""
    bodies = [wav_bytes(audio(5000 + i, seconds)) for i in range(n)]
    with ThreadPoolExecutor(n) as pool:
        t0 = time.perf_counter()
        outs = list(pool.map(lambda b: post(url + "/embed", b), bodies))
        wall = time.perf_counter() - t0
    check(all(len(o["embedding"]) == 192 for o in outs), "burst: bad embeddings")
    return n * seconds / wall, wall


def device_rows(prof):
    """(name, device us, calls) of the device events by name, largest
    first."""
    totals = {}
    for name, s, e in device_events(prof):
        us, n = totals.get(name, (0.0, 0))
        totals[name] = (us + e - s, n + 1)
    return sorted(((k, us, n) for k, (us, n) in totals.items() if us > 0),
                  key=lambda r: -r[1])


def profiled_burst(url, tag, bucket):
    """One burst under torch.profiler: the device's busy and idle share of
    the burst's wall time, from the union of the traced device intervals,
    checked against the fbank launches the burst made (one per batch)."""
    from torch.profiler import ProfilerActivity, profile

    from wespeaker_hubert_tpu_torch.ops import fbank_kernel

    launches0 = fbank_kernel.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rate, wall = burst(url)
        torch.cuda.synchronize()
    batches = fbank_kernel.LAUNCHES - launches0
    busy_us, n_events = device_busy_us(prof)
    rows = device_rows(prof)
    traced_fbank = sum(c for k, _, c in rows if "fbank" in k)
    out = {"audio_s_per_s_profiled": rate, "wall_s": wall, "batches": batches,
           "batch_shape": [16, bucket], "device_events": n_events,
           "traced_fbank_launches": traced_fbank}
    if n_events == 0 or traced_fbank != batches:
        out["device_busy_share"] = "not measured"
        log(f"[serve {tag}] profiled burst: the trace holds {n_events} device events "
            f"and {traced_fbank} of {batches} fbank launches: idle share not measured")
        return out
    out["device_busy_ms"] = busy_us / 1e3
    out["device_busy_share"] = busy_us / (wall * 1e6)
    out["device_idle_share"] = 1 - out["device_busy_share"]
    out["top"] = [{"name": k[:90], "ms": d / 1e3, "calls": c} for k, d, c in rows[:8]]
    log(f"[serve {tag}] profiled burst of 64 x 10 s: {wall:.4f} s wall, {rate:.1f} "
        f"audio-s/s with the profiler on; {batches} device batches (16 x {bucket} "
        f"samples each); device busy {busy_us / 1e3:.3f} ms, idle share "
        f"{out['device_idle_share']:.4f}")
    return out


def phase_serve(report, model_dir):
    from wespeaker_hubert_tpu_torch.bin.serve import EmbeddingService, make_http_server

    ref = CpuReference(model_dir)
    launches = {}
    for tag in ("bf16", "f32"):
        t0 = time.perf_counter()
        service = EmbeddingService(model_dir, device="cuda", bf16=(tag == "bf16"))
        startup = time.perf_counter() - t0
        httpd = make_http_server(service, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            log(f"[serve {tag}] EmbeddingService up in {startup:.1f} s on {url}")
            launches[tag] = drive_service(service, url, ref, tag, report)
            for rep in range(2):
                rate, wall = burst(url)
                report[f"serve_{tag}"][f"burst{rep}_audio_s_per_s"] = rate
                report[f"serve_{tag}"][f"burst{rep}_wall_s"] = wall
                log(f"[serve {tag}] burst {rep} of 64 x 10 s: {wall:.4f} s wall, "
                    f"{rate:.1f} audio-s/s")
            report[f"serve_{tag}"]["burst_profile"] = profiled_burst(
                url, tag, service.bucket_for(10 * SR))
        finally:
            httpd.shutdown()
            httpd.server_close()
            service.close()
            thread.join(timeout=10)
    return launches


def phase_bf16_margin(report):
    """The bf16 service's bar (cosine >= 0.9999 against the CPU float32
    path) is tightest for utterances shorter than one chunk, whose chunk
    reads padded frames.  Its margin over inputs and weights: 16 utterances
    of 1.3 s from 16 audio seeds in one served batch of 16 x 2 s, for the
    served weights and two other weight seeds; a measurement, not a bar."""
    import copy

    from wespeaker_hubert_tpu_torch.cli.speaker import Speaker
    from wespeaker_hubert_tpu_torch.train.chunked import make_chunked_embed
    from wespeaker_hubert_tpu_torch.train.executor import cast_variables_bf16

    n, bucket = int(1.3 * SR), 2 * SR
    wav = np.zeros((16, bucket), np.float32)
    for i in range(16):
        wav[i, :n] = audio(6000 + i, 1.3)
    batch = {"wav": torch.from_numpy(wav), "length": torch.full((16,), n, dtype=torch.int32)}
    per_seed = {}
    for seed in (WEIGHT_SEED, WEIGHT_SEED + 1, WEIGHT_SEED + 2):
        with tempfile.TemporaryDirectory() as d:
            write_model_dir(d, seed)
            gpu, cpu = Speaker(d, device="cuda"), Speaker(d, device="cpu")
        net = cast_variables_bf16(copy.deepcopy(gpu.net))
        got = make_chunked_embed(net, gpu.fbank_cfg, 198, compute_dtype=torch.bfloat16)(
            {k: v.cuda() for k, v in batch.items()}).cpu().numpy()
        want = make_chunked_embed(cpu.net, cpu.fbank_cfg, 198)(batch).numpy()
        check(np.isfinite(got).all(), f"bf16 margin: non-finite embeddings (seed {seed})")
        per_seed[str(seed)] = [cosine(g, w) for g, w in zip(got, want)]
        del gpu, cpu, net
    allc = [c for v in per_seed.values() for c in v]
    report["bf16_margin_1p3s"] = {"cosines": per_seed, "min": min(allc),
                                 "median": statistics.median(allc), "bar": COS_MIN["bf16"]}
    log(f"[bf16 margin] 1.3 s, 16 audio seeds x 3 weight seeds: cosine min "
        f"{min(allc):.7f}, median {statistics.median(allc):.7f}, "
        f"{sum(c < COS_MIN['bf16'] for c in allc)} of {len(allc)} below the "
        f"{COS_MIN['bf16']} bar; per weight seed min "
        + ", ".join(f"{min(v):.7f}" for v in per_seed.values()))


def phase_chunked_timing(report, model_dir):
    """make_chunked_embed at the served 16 x 30 s bucket: f32 and bf16, with
    the fbank kernel and with the plain fbank, in turns; then a profile."""
    import copy
    import dataclasses

    from wespeaker_hubert_tpu_torch.cli.speaker import Speaker
    from wespeaker_hubert_tpu_torch.train.chunked import make_chunked_embed
    from wespeaker_hubert_tpu_torch.train.executor import cast_variables_bf16

    spk = Speaker(model_dir, device="cuda")
    nets = {"f32": spk.net, "bf16": cast_variables_bf16(copy.deepcopy(spk.net))}
    rng = np.random.default_rng(7)
    wav = torch.from_numpy((rng.standard_normal((16, 30 * SR)) * 0.1).astype(np.float32)).cuda()
    batch = {"wav": wav, "length": torch.full((16,), 30 * SR, dtype=torch.int32, device="cuda")}
    plain_cfg = dataclasses.replace(spk.fbank_cfg, spectrum_impl="matmul")
    fns = {}
    for tag, net in nets.items():
        dt = torch.bfloat16 if tag == "bf16" else None
        fns[(tag, "kernel")] = make_chunked_embed(net, spk.fbank_cfg, 198, compute_dtype=dt)
        fns[(tag, "plain")] = make_chunked_embed(net, plain_cfg, 198, compute_dtype=dt)
    times = {k: [] for k in fns}
    for order in (("kernel", "plain"), ("plain", "kernel")):
        for tag in ("f32", "bf16"):
            for impl in order:
                times[(tag, impl)].append(host_median_ms(lambda: fns[(tag, impl)](batch), reps=8))
    res = {f"{tag}_{impl}_ms": statistics.mean(v) for (tag, impl), v in times.items()}
    n_chunks = -(-(1 + (30 * SR - 400) // 160) // 198)
    res["batch"] = f"16 x 30 s ({16 * n_chunks} chunks of 198 frames)"
    for tag in ("f32", "bf16"):
        res[f"{tag}_audio_s_per_s"] = 16 * 30 / (res[f"{tag}_kernel_ms"] / 1e3)
    report["chunked_embed"] = res
    log(f"[chunked] {res['batch']}: " + ", ".join(
        f"{k} {v:.2f}" for k, v in res.items() if k.endswith("_ms")))
    check(all(math.isfinite(v) for k, v in res.items() if k.endswith("_ms")), "timing")

    # where the time goes in one bf16 batch
    from torch.profiler import ProfilerActivity, profile

    fn = fns[("bf16", "kernel")]
    fn(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            fn(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): the operator rows above
    # them repeat the same time
    rows = device_rows(prof)
    total = sum(r[1] for r in rows)
    busy_us, _ = device_busy_us(prof)
    prof_out = {
        "window": "3 x make_chunked_embed bf16 16 x 30 s",
        "wall_ms": wall_us / 1e3,
        "device_ms": total / 1e3,
        "device_busy_share": busy_us / wall_us if total else "not measured",
        "top": [{"name": k[:90], "ms": d / 1e3, "calls": c, "share": d / total}
                for k, d, c in rows[:12]] if total else [],
    }
    report["profile"] = prof_out
    if total:
        fb = sum(d for k, d, _ in rows if "fbank" in k)
        prof_out["fbank_share"] = fb / total
        log(f"[profile] device {total / 1e3:.2f} ms over {wall_us / 1e3:.2f} ms wall "
            f"(busy {busy_us / wall_us:.4f}); fbank kernel share {fb / total:.4f}")
        for r in prof_out["top"][:8]:
            log(f"[profile]   {r['share']:.3f} {r['ms']:.3f} ms x{r['calls']} {r['name']}")
    else:
        log("[profile] torch.profiler reported no device time: not measured")


# ------------------------------------------------------ K2 and the SSL slice
# bf16: every element within max(atol, one bf16 spacing of the plain
# output) of it (an output >= 4 has a spacing of 3.1e-2, so two bf16 paths
# that round once apart differ by more than 2e-2 there), cosine >= cos, and
# against the float32 function of the same inputs an error no larger than
# f32_ratio x the plain bf16 path's
K2_TOL = {"f32": dict(atol=1e-4), "bf16": dict(atol=2e-2, cos=0.9999, f32_ratio=1.25)}
SSL_SECONDS = [1.5, 2.2, 3.1, 3.9, 4.6, 5.5, 6.3, 7.2, 8.0, 8.8, 9.7, 10.5,
               11.3, 12.1, 13.0, 13.8, 14.6, 15.5, 16.3, 17.1, 18.0, 18.7, 19.4, 20.0]
SSL_WEIGHT_SEED = 20251017


# The times of K2's last mma.sync bf16 kernels at these shapes, from
# PERF.md's kernel table (H100 80GB HBM3, 700.00 W): not measured by this
# script.  The forward's and dK/dV's read the materialized (B, h, T, T)
# gated bias; dQ + dBias's read the factored bias, while the wrapper computed
# D and torch the gate's gradient.  Printed in the [K2]
# log lines and kept under report["k2_history"], never in the kernels line.
MMA_SYNC_MS = {("fwd", 16, 499): 0.4524, ("fwd", 16, 1599): 2.7143,
               ("dkv", 64, 75): 0.2169, ("dkv", 16, 499): 1.0274, ("dkv", 16, 131): 0.0973,
               ("dq", 64, 75): 0.1237, ("dq", 16, 499): 0.7846}


def k2_bound(b, t, h, key_len, dtype, bias_kind):
    """The least time attention over these inputs can take: operations
    4 h hd T sum_b(valid keys) (QK^T and PV) on the dtype's peak, against
    bytes: q and out (every query row), k and v (valid keys), and the bias
    read once: the factored gated bias its (h, T, T) table and (B, h, T)
    gate, a (B, h, T, T) bias its valid (query, key) pairs, a (B, 1, 1, T)
    bias its valid keys.  Also returns the bound with the gated bias
    materialized (B, h, T, T), as the earlier kernels were called."""
    hd = 64
    elem = 2 if dtype == torch.bfloat16 else 4
    valid = int(key_len.sum()) if key_len is not None else b * t
    flop = 4 * h * hd * t * valid
    nbytes = elem * (2 * b * t * h * hd + 2 * valid * h * hd) + (4 * b if key_len is not None else 0)
    pairs = elem * h * t * valid
    bias_bytes = {"gated": elem * (h * t * t + b * h * t), "full": pairs,
                  "broadcast": elem * valid, None: 0}[bias_kind]
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    ops_ms = flop / peak * 1e3

    def bound(n):
        bytes_ms = n / PEAK_BYTES * 1e3
        return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")

    ms, by = bound(nbytes + bias_bytes)
    materialized_bound = bound(nbytes + (pairs if bias_kind == "gated" else bias_bytes))[0]
    return ms, by, flop, nbytes + bias_bytes, materialized_bound


def k2_inputs(b, t, h, dtype, bias_kind, len_kind, seed):
    """Seeded inputs made on the card: q, k, v, the bias (the factored gated
    bias: an (h, T, T) table with rows padded to 16 bytes, as the encoder
    builds it, and a (B, h, T) gate in [1, 3): WavLM's gate
    gate_a * (gate_b * gru_rel_pos_const - 1) + 2 spans (1, 1 + const), and
    the constant, 1 at initialization, is trained; or a (B, 1, 1, T) bias),
    key lengths."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, t, h, 64), generator=gen, device=dev).to(dtype) for _ in range(3))
    bias = gate = None
    if bias_kind == "gated":
        tp = t + (-t % 8)
        bias = torch.randn((h, t, tp), generator=gen, device=dev).to(dtype)[..., :t]
        gate = (1.0 + 2.0 * torch.rand((b, h, t), generator=gen, device=dev)).to(dtype)
    elif bias_kind == "broadcast":
        bias = torch.randn((b, 1, 1, t), generator=gen, device=dev).to(dtype)
    if len_kind == "full":
        key_len = torch.full((b,), t, dtype=torch.int32, device=dev)
    else:
        key_len = torch.randint(t // 2, t + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    return q, k, v, bias, gate, key_len


def bf16_spacing(x):
    """The distance between adjacent bf16 values at |x| (8 significant
    bits), elementwise in float32."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def host_us_per_call(fn, n=100):
    """Host time per call of a wrapper (checks, tensor maps, launch): the
    wall time of n calls issued back to back, before the synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def phase_k2_checks(report):
    """K2's forward against its plain version; timed (the kernel's device
    time from the profiler, and events around each wrapper call) beside the
    plain version, SDPA on the materialized bias, and the materialization
    itself."""
    from wespeaker_hubert_tpu_torch.ops import flash_attention as k2

    F = torch.nn.functional
    # (B, T, bias, key lengths): the 10 s batch of bench_all's SSL row (every
    # row full, the gated bias in factored form as the encoder passes it),
    # the 32 s bucket, the training shape (one 80-key tile), no bias with
    # key lengths, odd T, a broadcast (B, 1, 1, T) bias
    cases = [(16, 499, "gated", "full"), (16, 1599, "gated", "random"),
             (64, 75, "gated", "full"), (16, 499, None, "random"), (16, 131, "gated", "random"),
             (16, 99, "gated", "random"), (16, 75, "broadcast", "random")]
    rows = []
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for i, (b, t, bias_kind, len_kind) in enumerate(cases):
            h = 16
            q, k, v, bias, gate, key_len = k2_inputs(b, t, h, dtype, bias_kind, len_kind, 300 + i)
            relayouts = k2.BIAS_RELAYOUTS
            got = k2.flash_attention(q, k, v, bias=bias, key_len=key_len, bias_gate=gate)
            torch.cuda.synchronize()
            want = k2.flash_attention_reference(q, k, v, bias, key_len, bias_gate=gate)
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            cos = float(F.cosine_similarity(got.float().flatten(), want.float().flatten(), dim=0))
            exact_err = {}
            if tag == "bf16":
                excess = float((diff - bf16_spacing(want).clamp_min(K2_TOL[tag]["atol"])).max())
                # both bf16 paths against the float32 function of the same
                # bf16 inputs (the effective bias rounded as the kernel does)
                exact = k2.flash_attention_reference(
                    q.float(), k.float(), v.float(),
                    None if bias is None else k2.effective_bias(bias, gate).float(), key_len)
                exact_err = {"kernel": float((got.float() - exact).abs().max()),
                             "plain": float((want.float() - exact).abs().max())}
                del exact
                ok = (excess <= 0 and cos >= K2_TOL[tag]["cos"] and exact_err["kernel"]
                      <= K2_TOL[tag]["f32_ratio"] * exact_err["plain"])
            else:
                ok = err <= K2_TOL[tag]["atol"]
            ok = ok and bool(torch.isfinite(got).all())
            del diff
            if bias_kind == "gated":  # the table goes in as it is: no copy
                ok = ok and k2.BIAS_RELAYOUTS == relayouts
            # SDPA computes the same function from (B, h, T, 64) views and
            # one additive mask: the materialized bias plus -inf past each
            # row's key length
            valid = torch.arange(t, device=q.device)[None, :] < key_len[:, None]
            materialize = lambda: k2.effective_bias(bias, gate).expand(b, h, t, t)  # noqa: E731
            mask = (materialize().masked_fill(~valid[:, None, None, :], float("-inf"))
                    if bias is not None else valid[:, None, None, :])
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

            def call():
                return k2.flash_attention(q, k, v, bias=bias, key_len=key_len, bias_gate=gate)

            wrapper_ms = cuda_median_ms(call)
            dev_ms = kernel_device_ms(call, ("flash_fwd",))["flash_fwd"]
            g_ms = graph_ms(call)
            k_ms = dev_ms if dev_ms is not None else wrapper_ms
            host_us = host_us_per_call(call)
            p_ms = cuda_median_ms(lambda: k2.flash_attention_reference(
                q, k, v, bias, key_len, bias_gate=gate), reps=10)
            l_ms = cuda_median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
            mat_ms = cuda_median_ms(materialize) if bias_kind == "gated" else None
            bound_ms, bound_by, flop, nbytes, materialized_bound = k2_bound(
                b, t, h, key_len if len_kind != "full" else None, dtype, bias_kind)
            row = dict(dtype=tag, shape=[b, t, h, 64], bias=bias_kind, key_len=len_kind,
                       tile_n=k2.key_tile(t) if tag == "bf16" else 32,
                       valid_keys=int(key_len.sum()), max_abs_err=err, cosine=cos, ok=ok,
                       max_abs_err_vs_f32=exact_err,
                       ms=k_ms, ms_scope="profiler device time" if dev_ms is not None
                       else "events around each wrapper call", wrapper_ms=wrapper_ms,
                       graph_ms=g_ms,
                       host_us=host_us, plain_ms=p_ms, library_ms=l_ms,
                       materialize_bias_ms=mat_ms, bound_ms=bound_ms, bound_by=bound_by,
                       gflop=flop / 1e9, mbytes=nbytes / 1e6, roofline_share=bound_ms / k_ms,
                       materialized_bias_bound_ms=materialized_bound)
            mma_sync_ms = MMA_SYNC_MS.get(("fwd", b, t)) if tag == "bf16" and bias_kind \
                else None
            rows.append(row)
            log(f"[K2] {tag} ({b}, {t}, {h}, 64) bias={bias_kind} key_len={len_kind} "
                f"tile {row['tile_n']}: max|err|={err:.3e} cos={cos:.7f} {'ok' if ok else 'FAIL'} "
                f"({'atol max(2e-2, one bf16 spacing), cos >= 0.9999, against float32 at most '
                   '1.25 x plain' if tag == 'bf16' else 'atol 1e-4'})"
                + (f" [against float32: kernel {exact_err['kernel']:.3e}, plain "
                   f"{exact_err['plain']:.3e}]" if exact_err else "")
                + f"; kernel {k_ms:.4f} ms ({row['ms_scope']}; {g_ms:.4f} ms per call in a CUDA "
                f"graph; wrapper {wrapper_ms:.4f} ms, host "
                f"{host_us:.1f} us per call), plain {p_ms:.4f} ms, SDPA {l_ms:.4f} ms"
                + (f" + materializing the bias {mat_ms:.4f} ms" if mat_ms is not None else "")
                + f", bound {bound_ms:.5f} ms ({bound_by}: {flop / 1e9:.2f} GFLOP, "
                f"{nbytes / 1e6:.1f} MB), roofline share {bound_ms / k_ms:.4f}"
                + (f"; the earlier mma.sync kernel {mma_sync_ms} ms (PERF.md, not this run) "
                   f"against a bound of "
                   f"{materialized_bound:.5f} ms with the bias materialized"
                   if mma_sync_ms else ""))
            del q, k, v, bias, gate, got, want, mask
            torch.cuda.empty_cache()
    report["k2_checks"] = rows
    whisper = report["k2_whisper_checks"] = [
        whisper_k2_row(b, t, tag, dtype) for tag, dtype in (("f32", torch.float32),
                                                            ("bf16", torch.bfloat16))
        for b, t in WHISPER_K2_FWD] + [
        whisper_k2_row(b, t, "f32", torch.float32, K2_LARGE_LOGIT) for b, t in WHISPER_K2_FWD]
    check(all(r["ok"] for r in rows), "the flash-attention kernel disagrees with its plain version")
    check(all(r["ok"] for r in whisper),
          "the flash-attention kernel disagrees with its plain version at Whisper's shapes")
    return rows[0]


# Whisper-large-v2's attention (frontend/whisper.py): 20 heads of 64, q and k
# each scaled by 64^-0.25 before the call, scale 1.0, no bias, no key
# lengths.  Forward at the extraction batch of the 32-40 s buckets (T cut at
# 1,500) and the stage-3 training batch (64 x 5 s: T = 251); backward at
# stage 4's (16, 251).
WHISPER_HEADS = 20
WHISPER_K2_FWD = ((16, 1500), (64, 251))
WHISPER_K2_BWD = ((16, 251),)
# The large-logit rows: q and k scaled alike to max |q k^T| = 40, where
# 3xTF32's relative error (about 2^-21 per product) is largest in absolute
# terms.  The forward is held to the plain version (K2_TOL).  The gradients
# reach |dK| of 30-50 there, and any float32 pipeline is about 1e-4 from
# float64: the plain backward given the kernel forward's out and lse is
# 2.7e-4 from it in dK, as it rounds S otherwise than the forward that made
# lse.  So the backward is held as a whole function: the kernel pipeline
# (the kernel forward, then the kernel backward on its out and lse) against
# float64, at most K2_LARGE_LOGIT_RATIO x the plain pipeline's distance (the
# plain forward, then the plain backward) or K2_BWD_TOL's atol, per
# gradient, on each of K2_LARGE_LOGIT_SEEDS.  Neither reading depends on
# the kernel forward's output.
K2_LARGE_LOGIT = 40.0
K2_LARGE_LOGIT_RATIO = 2.0
K2_LARGE_LOGIT_SEEDS = (0, 1, 2)


def tf32x3_bound(flop, nbytes):
    """The least time of float32 products run as three tf32 products each
    on the tensor cores (the float32 kernels' design): 3 x flop at the tf32
    peak, against the bytes."""
    ops_ms = 3 * flop / PEAK_TF32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def scale_logits(q, k, s_max):
    """q and k scaled alike so that max |q k^T| is s_max."""
    peak = max(float(torch.einsum("qhd,khd->hqk", q[i], k[i]).abs().max())
               for i in range(q.shape[0]))
    f = (s_max / peak) ** 0.5
    return q * f, k * f


def attention_f64(q, k, v, scale, dout=None):
    """Attention and, with dout, its gradients in float64 on the card, one
    batch row at a time: out, lse and (dq, dk, dv) or None."""
    outs = {"out": [], "lse": [], "dq": [], "dk": [], "dv": []}
    for i in range(q.shape[0]):
        qi, ki, vi = (x[i].double() for x in (q, k, v))
        s = torch.einsum("qhd,khd->hqk", qi, ki) * scale
        lse = torch.logsumexp(s, -1)
        p = torch.exp(s - lse[..., None])
        out = torch.einsum("hqk,khd->qhd", p, vi)
        outs["out"].append(out)
        outs["lse"].append(lse)
        if dout is not None:
            do = dout[i].double()
            delta = (out * do).sum(-1).transpose(0, 1)[..., None]
            ds = p * (torch.einsum("qhd,khd->hqk", do, vi) - delta)
            outs["dq"].append(torch.einsum("hqk,khd->qhd", ds, ki) * scale)
            outs["dk"].append(torch.einsum("hqk,qhd->khd", ds, qi) * scale)
            outs["dv"].append(torch.einsum("hqk,qhd->khd", p, do))
        del s, p
    return {key: torch.stack(x) for key, x in outs.items() if x}


def sdpa_backward(qt, kt, vt, do_t, backend, scale=None, mask=None):
    """SDPA's backward alone (q, k and v's gradients; no mask gradient), its
    backend pinned: the gradients of a retained graph timed (events, median
    of 10), and the names of the kernels it launches."""
    from torch.nn.attention import sdpa_kernel

    F = torch.nn.functional
    leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    with sdpa_kernel([backend]):
        o = F.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=scale)
    grad = lambda: torch.autograd.grad(o, leaves, do_t, retain_graph=True)  # noqa: E731
    ms = cuda_median_ms(grad, reps=10)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        grad()
        torch.cuda.synchronize()
    names = [n[:90] for n, _, _ in device_rows(prof)][:3]
    del o, leaves
    return ms, names


def whisper_qkv(b, t, dtype, seed):
    """Seeded q, k, v (B, T, 20, 64) on the card, q and k at the scale
    64^-0.25 gives them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    s = 64 ** -0.25
    q, k, v = (torch.randn((b, t, WHISPER_HEADS, 64), generator=gen, device="cuda")
               for _ in range(3))
    return (q * s).to(dtype), (k * s).to(dtype), v.to(dtype)


def whisper_k2_row(b, t, tag, dtype, s_max=None):
    """K2's forward at a Whisper shape against its plain version (K2_TOL),
    timed (profiler device time, events around the wrapper) beside the
    plain version and scaled_dot_product_attention on the same inputs.  With
    `s_max` (float32), q and k scaled to max |S| = s_max, untimed: the
    kernel's and the plain version's errors against float64 side by side."""
    from wespeaker_hubert_tpu_torch.ops import flash_attention as k2

    F = torch.nn.functional
    h = WHISPER_HEADS
    q, k, v = whisper_qkv(b, t, dtype, 700 + b + t)
    if s_max is not None:
        q, k = scale_logits(q, k, s_max)
        got, lse = k2.flash_attention_fwd(q, k, v, None, None, 1.0, return_lse=True)
        torch.cuda.synchronize()
        want, lse_ref = k2.flash_attention_reference(q, k, v, None, None, 1.0, return_lse=True)
        exact = attention_f64(q, k, v, 1.0)
        err = float((got - want).abs().max())
        lse_err = float((lse - lse_ref).abs().max())
        vs64 = {"kernel": float((got.double() - exact["out"]).abs().max()),
                "plain": float((want.double() - exact["out"]).abs().max()),
                "kernel_lse": float((lse.double() - exact["lse"]).abs().max()),
                "plain_lse": float((lse_ref.double() - exact["lse"]).abs().max())}
        ok = (err <= K2_TOL[tag]["atol"] and lse_err <= K2_TOL[tag]["atol"]
              and bool(torch.isfinite(got).all()))
        row = dict(dtype=tag, shape=[b, t, h, 64], bias=None, key_len=None, scale=1.0,
                   max_abs_s=s_max, kernel="flash_fwd_f32_sm90", max_abs_err=err,
                   lse_max_abs_err=lse_err, max_abs_err_vs_f64=vs64, ok=ok)
        log(f"[K2 whisper] f32 ({b}, {t}, {h}, 64) large logits (max |S| = {s_max:g}): "
            f"max|err|={err:.3e}, lse {lse_err:.3e} against the plain version "
            f"{'ok' if ok else 'FAIL'} (atol 1e-4); against float64: kernel {vs64['kernel']:.3e} "
            f"(lse {vs64['kernel_lse']:.3e}), plain {vs64['plain']:.3e} "
            f"(lse {vs64['plain_lse']:.3e})")
        del q, k, v, got, want, lse, lse_ref, exact
        torch.cuda.empty_cache()
        return row

    def call():
        return k2.flash_attention(q, k, v, bias=None, key_len=None, scale=1.0)

    got = call()
    torch.cuda.synchronize()
    want = k2.flash_attention_reference(q, k, v, None, None, 1.0)
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    cos = float(F.cosine_similarity(got.float().flatten(), want.float().flatten(), dim=0))
    exact_err = {}
    if tag == "bf16":
        excess = float((diff - bf16_spacing(want).clamp_min(K2_TOL[tag]["atol"])).max())
        exact = k2.flash_attention_reference(q.float(), k.float(), v.float(), None, None, 1.0)
        exact_err = {"kernel": float((got.float() - exact).abs().max()),
                     "plain": float((want.float() - exact).abs().max())}
        del exact
        ok = (excess <= 0 and cos >= K2_TOL[tag]["cos"]
              and exact_err["kernel"] <= K2_TOL[tag]["f32_ratio"] * exact_err["plain"])
    else:
        ok = err <= K2_TOL[tag]["atol"]
    ok = ok and bool(torch.isfinite(got).all())
    del diff, got, want
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    wrapper_ms = cuda_median_ms(call, reps=10)
    dev_ms = kernel_device_ms(call, ("flash_fwd",), reps=5)["flash_fwd"]
    k_ms = dev_ms if dev_ms is not None else wrapper_ms
    p_ms = cuda_median_ms(lambda: k2.flash_attention_reference(q, k, v, None, None, 1.0),
                          reps=3, warmup=1)
    l_ms = cuda_median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=1.0), reps=10)
    bound_ms, bound_by, flop, nbytes, _ = k2_bound(b, t, h, None, dtype, None)
    x3_ms, x3_by = tf32x3_bound(flop, nbytes)
    row = dict(dtype=tag, shape=[b, t, h, 64], bias=None, key_len=None, scale=1.0,
               kernel="flash_fwd_f32_sm90" if tag == "f32" else "flash_fwd_bf16_sm90",
               max_abs_err=err, cosine=cos, ok=ok, max_abs_err_vs_f32=exact_err, ms=k_ms,
               ms_scope="profiler device time" if dev_ms is not None
               else "events around each wrapper call", wrapper_ms=wrapper_ms, plain_ms=p_ms,
               library_ms=l_ms, bound_ms=bound_ms, bound_by=bound_by, gflop=flop / 1e9,
               mbytes=nbytes / 1e6, roofline_share=bound_ms / k_ms)
    if tag == "f32":
        row.update(tf32x3_bound_ms=x3_ms, tf32x3_bound_by=x3_by,
                   tf32x3_roofline_share=x3_ms / k_ms)
    log(f"[K2 whisper] {tag} ({b}, {t}, {h}, 64) no bias, no key lengths, scale 1.0: max|err|="
        f"{err:.3e} cos={cos:.7f} {'ok' if ok else 'FAIL'} "
        f"({'atol 1e-4' if tag == 'f32' else 'atol max(2e-2, one bf16 spacing), cos >= 0.9999'})"
        + (f" [against float32: kernel {exact_err['kernel']:.3e}, plain "
           f"{exact_err['plain']:.3e}]" if exact_err else "")
        + f"; kernel {k_ms:.4f} ms ({row['ms_scope']}; wrapper {wrapper_ms:.4f} ms), plain "
        f"{p_ms:.4f} ms, SDPA {l_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
        f"{flop / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), roofline share {bound_ms / k_ms:.4f}"
        + (f"; 3xTF32 bound {x3_ms:.5f} ms ({x3_by}), share {x3_ms / k_ms:.4f}"
           if tag == "f32" else ""))
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return row


def whisper_k2_bwd_row(b, t, tag, dtype, s_max=None, seed=0):
    """K2's dQ and dK/dV kernels at a Whisper shape through the wrapper,
    against the plain backward (K2_BWD_TOL), each kernel's device time
    beside its bound, the plain backward, SDPA's backward alone (its backend
    pinned) and SDPA's forward + backward.  With `s_max` (float32), q and k
    scaled to max |S| = s_max, untimed: the kernel pipeline and the plain
    pipeline against float64 (K2_LARGE_LOGIT_RATIO), and each gradient's
    distance from the plain backward on the kernel forward's out and lse."""
    from torch.nn.attention import SDPBackend

    from wespeaker_hubert_tpu_torch.ops import flash_attention as k2

    F = torch.nn.functional
    h = WHISPER_HEADS
    q, k, v = whisper_qkv(b, t, dtype, 800 + b + t + 1000 * seed)
    dout = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(801 + seed),
                       device="cuda").to(dtype)
    if s_max is not None:
        q, k = scale_logits(q, k, s_max)
    out, lse = k2.flash_attention_fwd(q, k, v, None, None, 1.0, return_lse=True)
    args = (q, k, v, None, None, 1.0, out, lse, dout)
    call = lambda: k2.flash_attention_bwd(*args)  # noqa: E731
    got = call()
    torch.cuda.synchronize()
    want = k2.flash_attention_bwd_reference(*args)
    if s_max is not None:
        # the plain pipeline (its own forward, then its backward), and float64
        p_out, p_lse = k2.flash_attention_reference(q, k, v, None, None, 1.0, return_lse=True)
        own = k2.flash_attention_bwd_reference(q, k, v, None, None, 1.0, p_out, p_lse, dout)
        exact = attention_f64(q, k, v, 1.0, dout)
        atol = K2_BWD_TOL["f32"]["atol"]
        errs, vs64, bars = {}, {}, {}
        ok = got.dbias is None and got.dgate is None
        for name in ("dq", "dk", "dv", "delta"):
            g, w = getattr(got, name), getattr(want, name)
            errs[name] = float((g - w).abs().max())
            ok = ok and bool(torch.isfinite(g).all())
            if name == "delta":  # rowsum(out * dO) of the same inputs
                ok = ok and errs[name] <= atol
                continue
            pipe = getattr(own, name)
            vs64[name] = {"kernel": float((g.double() - exact[name]).abs().max()),
                          "plain_pipeline": float((pipe.double() - exact[name]).abs().max()),
                          "plain_same_inputs": float((w.double() - exact[name]).abs().max()),
                          "kernel_vs_plain_pipeline": float((g - pipe).abs().max())}
            bars[name] = max(atol, K2_LARGE_LOGIT_RATIO * vs64[name]["plain_pipeline"])
            ok = ok and vs64[name]["kernel"] <= bars[name]
        row = dict(dtype=tag, shape=[b, t, h, 64], bias=None, key_len=None, scale=1.0,
                   max_abs_s=s_max, seed=seed, max_abs_err=errs, max_abs_err_vs_f64=vs64,
                   bar_vs_f64=bars, ok=ok,
                   kernels={"dkv": "flash_bwd_dkv_f32_sm90", "dq": "flash_bwd_dq_f32_sm90"})
        log(f"[K2 bwd whisper] f32 ({b}, {t}, {h}, 64) large logits (max |S| = {s_max:g}, seed "
            f"{seed}), against float64 (kernel pipeline / plain pipeline, bar "
            f"max(1e-4, {K2_LARGE_LOGIT_RATIO:g} x plain)): "
            + "; ".join(f"{n} {vs64[n]['kernel']:.2e} / {vs64[n]['plain_pipeline']:.2e} "
                        f"(bar {bars[n]:.2e}; the plain backward on the kernel forward's out "
                        f"and lse {vs64[n]['plain_same_inputs']:.2e}, the kernel {errs[n]:.2e} "
                        f"from it)" for n in vs64)
            + f"; delta {errs['delta']:.2e} {'ok' if ok else 'FAIL'}")
        del q, k, v, dout, out, lse, got, want, p_out, p_lse, own, exact
        torch.cuda.empty_cache()
        return row
    errs, coss, ok = {}, {}, got.dbias is None and got.dgate is None
    for name in ("dq", "dk", "dv", "delta"):
        g, w = getattr(got, name), getattr(want, name)
        errs[name] = float((g.float() - w.float()).abs().max())
        coss[name] = float(F.cosine_similarity(g.float().flatten(), w.float().flatten(), dim=0))
        ok = ok and g.shape == w.shape and g.dtype == w.dtype and bool(torch.isfinite(g).all())
        ok = ok and (errs[name] <= K2_BWD_TOL["f32"]["atol"] if tag == "f32"
                     else coss[name] >= K2_BWD_TOL["bf16"]["cos"])
    del got, want
    k_ms = cuda_median_ms(call, reps=10)
    per = kernel_device_ms(call, ("flash_bwd_dkv", "flash_bwd_dq"), reps=5)
    p_ms = cuda_median_ms(lambda: k2.flash_attention_bwd_reference(*args), reps=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    do_t = dout.transpose(1, 2)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, scale=1.0)
        return torch.autograd.grad(o, (qt, kt, vt), do_t)

    # SDPA's forward + backward as PyTorch dispatches it, and its backward
    # alone with the backend pinned: memory-efficient attention for float32
    # (flash attention takes no float32), flash for bf16
    l_ms = cuda_median_ms(sdpa_fwd_bwd, reps=10)
    backend = SDPBackend.EFFICIENT_ATTENTION if tag == "f32" else SDPBackend.FLASH_ATTENTION
    bwd_ms, bwd_kernels = sdpa_backward(qt, kt, vt, do_t, backend, scale=1.0)
    sdpa = {"backend": backend.name, "bwd_ms": bwd_ms, "bwd_kernels": bwd_kernels,
            "fwd_bwd_dispatched_ms": l_ms}
    bounds = k2_bwd_bounds(b, t, h, None, dtype, None)
    kernel = {"dkv": "flash_bwd_dkv", "dq": "flash_bwd_dq"}
    names = {"dkv": "flash_bwd_dkv_f32_sm90", "dq": "flash_bwd_dq_f32_sm90"} if tag == "f32" else {
        key: f"{name}_bf16_sm90" for key, name in kernel.items()}
    row = dict(dtype=tag, shape=[b, t, h, 64], bias=None, key_len=None, scale=1.0,
               max_abs_err=errs, cosine=coss, ok=ok, ms=k_ms, plain_ms=p_ms,
               library_ms=bwd_ms, library_fwd_bwd_ms=l_ms, sdpa=sdpa,
               dkv_ms=per["flash_bwd_dkv"], dq_ms=per["flash_bwd_dq"],
               bound_ms=bounds["function"][0], bound_by=bounds["function"][1],
               dkv_bound_ms=bounds["dkv"][0], dkv_bound_by=bounds["dkv"][1],
               dq_bound_ms=bounds["dq"][0], dq_bound_by=bounds["dq"][1], kernels=names)
    if tag == "f32":
        for key in ("dkv", "dq"):
            ms_x3, by_x3 = tf32x3_bound(bounds[key][2], bounds[key][3])
            row[key + "_tf32x3_bound_ms"], row[key + "_tf32x3_bound_by"] = ms_x3, by_x3
    log(f"[K2 bwd whisper] {tag} ({b}, {t}, {h}, 64) no bias, no key lengths, scale 1.0: "
        + " ".join(f"{n} err {errs[n]:.2e} cos {coss[n]:.7f}" for n in errs)
        + f" {'ok' if ok else 'FAIL'} ({'atol 1e-4' if tag == 'f32' else 'cos >= 0.9999'}); "
        f"backward {k_ms:.4f} ms (events around the wrapper), dK/dV {row['dkv_ms']} ms against "
        f"{row['dkv_bound_ms']:.5f} ({row['dkv_bound_by']})"
        + (f" / 3xTF32 {row['dkv_tf32x3_bound_ms']:.5f}" if tag == "f32" else "")
        + f", dQ {row['dq_ms']} ms against {row['dq_bound_ms']:.5f} ({row['dq_bound_by']})"
        + (f" / 3xTF32 {row['dq_tf32x3_bound_ms']:.5f}" if tag == "f32" else "")
        + f", plain {p_ms:.4f} ms; SDPA backward alone ({backend.name}) {bwd_ms:.4f} ms "
        f"[{'; '.join(bwd_kernels)}], SDPA fwd+bwd as dispatched {l_ms:.4f} ms; the "
        f"backward's bound {row['bound_ms']:.5f} ms ({row['bound_by']})")
    del q, k, v, dout, out, lse, qt, kt, vt
    torch.cuda.empty_cache()
    return row


def ssl_config(attn_impl="flash", compute_dtype=None):
    """examples/voxceleb/v2/conf/ecapa_tdnn_wavlm_frozen.yaml's model, with
    the flash-attention knob."""
    cfg = {
        "model": "ECAPA_TDNN_GLOB_c512",
        "model_args": {"feat_dim": 1024, "embed_dim": 192, "pooling_func": "ASTP"},
        "dataset_args": {
            "resample_rate": SR,
            "frontend": "s3prl",
            "s3prl_args": {"upstream": "wavlm_large", "frozen": True, "attn_impl": attn_impl},
        },
    }
    if compute_dtype:
        cfg["compute_dtype"] = compute_dtype
    return cfg


def ssl_state_dict(net, seed):
    """Seeded random weights in the port's names: the frontend HF-like
    (dense weights normal(0, 0.02), conv extractor He-normal, the
    positional conv normal(0, 2 / sqrt(k * C)) as HF initializes it, norms
    near 1, small biases), the ECAPA backbone as seeded_state_dict."""
    rng = np.random.default_rng(seed)
    sd = seeded_state_dict(net.backbone, seed)
    for k, v in net.frontend.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("featurizer_weights"):
            x = rng.normal(0.0, 0.1, shape)
        elif k.endswith("gru_rel_pos_const"):
            x = np.ones(shape)
        elif "pos_conv_embed.conv.weight" in k:
            x = rng.normal(0.0, 2.0 / math.sqrt(shape[2] * shape[0]), shape)
        elif "feature_extractor" in k and k.endswith("conv.weight"):
            x = rng.normal(0.0, math.sqrt(2.0 / (shape[1] * shape[2])), shape)
        elif "layer_norm" in k and k.endswith("weight"):
            x = 1.0 + rng.normal(0.0, 0.02, shape)
        elif k.endswith("bias"):
            x = rng.normal(0.0, 0.02, shape)
        else:  # linears, rel_attn_embed
            x = rng.normal(0.0, 0.02, shape)
        sd["frontend." + k] = torch.from_numpy(x.astype(np.float32))
    return sd


def write_ssl_dir(root):
    """24 seeded wavs of 1.5-20 s, their raw JSONL list, the config as JSON
    and a seeded .pt; returns (list path, {key: seconds})."""
    from wespeaker_hubert_tpu_torch.data.wav_io import write_wav
    from wespeaker_hubert_tpu_torch.models.speaker_net import build_speaker_net

    lines, seconds = [], {}
    for i, sec in enumerate(SSL_SECONDS):
        path = os.path.join(root, f"utt{i:02d}.wav")
        write_wav(path, audio(8000 + i, sec))
        lines.append(json.dumps({"key": f"utt{i:02d}", "wav": path}))
        seconds[f"utt{i:02d}"] = sec
    with open(os.path.join(root, "wav.jsonl"), "w") as f:
        f.write("\n".join(lines) + "\n")
    small = [ln for ln, sec in zip(lines, SSL_SECONDS) if sec <= 4.0][:4]
    with open(os.path.join(root, "wav_cpu.jsonl"), "w") as f:
        f.write("\n".join(small) + "\n")
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(ssl_config(), f)
    net = build_speaker_net(ssl_config())
    torch.save(ssl_state_dict(net, SSL_WEIGHT_SEED), os.path.join(root, "model.pt"))
    return os.path.join(root, "wav.jsonl"), seconds


class ExtractLog(logging.Handler):
    """Catches bin/extract's "extracted ... audio-s/s" record."""

    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        if record.getMessage().startswith("extracted"):
            self.records.append(record.args)


def phase_ssl_extract(report, root):
    """The extraction entry point on the card; returns K2's launches in the
    bf16 run (the main path)."""
    from wespeaker_hubert_tpu_torch.bin.extract import extract
    from wespeaker_hubert_tpu_torch.data.dataset import EvalPipeline, load_data_list
    from wespeaker_hubert_tpu_torch.ops import flash_attention as k2

    lst, _ = write_ssl_dir(root)
    ckpt = os.path.join(root, "model.pt")
    n_batches = sum(1 for _ in EvalPipeline(load_data_list(lst), batch_size=16))
    catcher = ExtractLog()
    logging.getLogger("extract").addHandler(catcher)
    logging.getLogger("extract").setLevel(logging.INFO)
    out = {"utterances": len(SSL_SECONDS), "audio_s": sum(SSL_SECONDS),
           "device_batches": n_batches, "batch_size": 16}
    runs = {}
    try:
        # warm-up: the first pass over the buckets pays cuDNN's and cuBLAS's
        # first-call costs; the timed runs below follow it
        extract(ssl_config(compute_dtype="bf16"), lst, ckpt, "", batch_size=16, device="cuda")
        for tag, cfg in (("bf16", ssl_config(compute_dtype="bf16")),
                         ("f32", ssl_config()),
                         ("bf16_plain_attention", ssl_config("einsum", "bf16"))):
            k2.LAUNCHES = k2.BIAS_RELAYOUTS = 0
            t0 = time.perf_counter()
            keys, emb = extract(cfg, lst, ckpt, os.path.join(root, f"{tag}.npz"),
                                batch_size=16, device="cuda")
            wall = time.perf_counter() - t0
            launches = k2.LAUNCHES
            # the gated bias went to K2 factored and TMA-readable: no copy
            check(k2.BIAS_RELAYOUTS == 0, f"ssl {tag}: {k2.BIAS_RELAYOUTS} bias copies")
            n, audio_s, loop_s, rate = catcher.records[-1]
            runs[tag] = dict(zip(keys, emb))
            out[tag] = {"launches": launches, "entry_wall_s": wall, "loop_s": loop_s,
                        "audio_s_per_s": rate, "finite": bool(np.isfinite(emb).all())}
            log(f"[ssl {tag}] bin/extract: {n} utterances, {audio_s:.1f} audio-s in "
                f"{loop_s:.3f} s = {rate:.1f} audio-s/s (entry point {wall:.1f} s with "
                f"model load); K2 launches {launches} over {n_batches} device batches")
            check(emb.shape == (len(SSL_SECONDS), 192) and np.isfinite(emb).all(),
                  f"ssl {tag}: bad embeddings {emb.shape}")
            want = 24 * n_batches if tag != "bf16_plain_attention" else 0
            check(launches == want, f"ssl {tag}: K2 launched {launches} times, want {want}")
        # float32 on the CPU: the subset of <= 4 utterances of <= 4 s
        t0 = time.perf_counter()
        keys, emb = extract(ssl_config(), os.path.join(root, "wav_cpu.jsonl"), ckpt, "",
                            batch_size=16, device="cpu")
        cpu = dict(zip(keys, emb))
        out["cpu_f32_s"] = time.perf_counter() - t0
    finally:
        logging.getLogger("extract").removeHandler(catcher)
    cos_f32 = {k: cosine(runs["f32"][k], e) for k, e in cpu.items()}
    cos_bf16_cpu = {k: cosine(runs["bf16"][k], e) for k, e in cpu.items()}
    cos_plain = {k: cosine(runs["bf16"][k], runs["bf16_plain_attention"][k]) for k in runs["bf16"]}
    cos_bf16_f32 = {k: cosine(runs["bf16"][k], runs["f32"][k]) for k in runs["bf16"]}
    out.update(cos_f32_card_vs_cpu=cos_f32, cos_bf16_vs_cpu_f32=cos_bf16_cpu,
               cos_bf16_k2_vs_plain=cos_plain, cos_bf16_vs_f32_card=cos_bf16_f32)
    below = sorted(c for c in cos_bf16_f32.values() if c < COS_MIN["bf16"])
    out["bf16_vs_f32_below_bar"] = len(below)
    report["ssl_extract"] = out
    log(f"[ssl] f32 card vs CPU ({len(cpu)} utterances <= 4 s): cosine min "
        f"{min(cos_f32.values()):.7f}; bf16 K2 vs bf16 plain attention ({len(cos_plain)}): min "
        f"{min(cos_plain.values()):.7f}; bf16 vs CPU f32: min {min(cos_bf16_cpu.values()):.7f}; "
        f"bf16 vs card f32 ({len(cos_bf16_f32)}): min {min(cos_bf16_f32.values()):.7f}, median "
        f"{statistics.median(cos_bf16_f32.values()):.7f}, {len(below)} of {len(cos_bf16_f32)} below "
        f"{COS_MIN['bf16']}")
    check(min(cos_f32.values()) >= COS_MIN["f32"], f"ssl f32 card vs CPU: {cos_f32}")
    check(min(cos_plain.values()) >= COS_MIN["bf16"], f"ssl bf16 K2 vs plain: {cos_plain}")
    if min(cos_bf16_cpu.values()) < COS_MIN["bf16"]:
        log(f"[ssl] NOTE: bf16 vs CPU f32 falls below the {COS_MIN['bf16']} bar "
            "(recorded in PERF.md, not a pass)")
    return out["bf16"]["launches"]


def phase_ssl_timing(report, root):
    """make_eval_embed at bench_all's SSL shape (16 x 10 s, bf16) with K2 and
    with plain attention, in turns; then a profile of one K2 batch."""
    from torch.profiler import ProfilerActivity, profile

    from wespeaker_hubert_tpu_torch.models.speaker_net import build_speaker_net, load_speaker_state
    from wespeaker_hubert_tpu_torch.train.executor import cast_variables_bf16, make_eval_embed

    state = torch.load(os.path.join(root, "model.pt"), map_location="cpu", weights_only=True)
    fns = {}
    for impl in ("flash", "einsum"):
        net = build_speaker_net(ssl_config(impl))
        load_speaker_state(net, state)
        net = cast_variables_bf16(net).to("cuda").eval()
        fns[impl] = make_eval_embed(net, compute_dtype=torch.bfloat16)
    del state
    rng = np.random.default_rng(7)
    batch = {"wav": torch.from_numpy((rng.standard_normal((16, 10 * SR)) * 0.1).astype(np.float32)).cuda(),
             "length": torch.full((16,), 10 * SR, dtype=torch.int32, device="cuda")}
    times = {k: [] for k in fns}
    for order in (("flash", "einsum"), ("einsum", "flash")):
        for impl in order:
            times[impl].append(host_median_ms(lambda: fns[impl](batch), reps=6))
    res = {f"{impl}_ms": statistics.mean(v) for impl, v in times.items()}
    res["batch"] = "16 x 10 s bf16 (499 frames)"
    res["audio_s_per_s_flash"] = 160 / (res["flash_ms"] / 1e3)
    fn = fns["flash"]
    fn(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            fn(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    total = sum(r[1] for r in rows)
    busy_us, _ = device_busy_us(prof)
    # first match wins (lower-case names): cuDNN's convolutions are CUTLASS
    # kernels too, and a dtype cast is an elementwise kernel
    groups = {"K2 flash_fwd": ("flash_fwd",),
              "conv": ("fprop", "cudnn", "convol", "winograd", "implicit_gemm"),
              "GEMM": ("nvjet", "gemm", "cutlass", "xmma", "cublas"),
              "layer/group norm": ("layer_norm", "group_norm", "batch_norm"),
              "copies and casts": ("copy", "memcpy", "memset", "catarray"),
              "elementwise": ("elementwise", "reduce", "softmax", "gelu", "index")}
    shares = {g: 0.0 for g in groups}
    shares["other"] = 0.0
    members = {g: [] for g in shares}
    for name, d, _ in rows:
        group = next((g for g, keys in groups.items()
                      if any(key in name.lower() for key in keys)), "other")
        shares[group] += d
        members[group].append((d, name[:120]))
    res["profile"] = {
        "window": "3 x make_eval_embed bf16 16 x 10 s, K2",
        "wall_ms": wall_us / 1e3, "device_ms": total / 1e3,
        "device_busy_share": busy_us / wall_us if total else "not measured",
        "device_idle_share": 1 - busy_us / wall_us if total else "not measured",
        "shares": {g: d / total for g, d in shares.items()} if total else "not measured",
        "group_top": {g: [f"{d / 1e3:.3f} ms {n}" for d, n in sorted(m, reverse=True)[:4]]
                      for g, m in members.items()},
        "top": [{"name": k[:90], "ms": d / 1e3, "calls": c, "share": d / total}
                for k, d, c in rows[:12]] if total else [],
    }
    report["ssl_timing"] = res
    log(f"[ssl timing] make_eval_embed {res['batch']}: K2 {res['flash_ms']:.2f} ms, plain "
        f"attention {res['einsum_ms']:.2f} ms ({res['audio_s_per_s_flash']:.1f} audio-s/s with K2)")
    if total:
        log(f"[ssl profile] device {total / 1e3:.2f} ms over {wall_us / 1e3:.2f} ms wall "
            f"(idle share {1 - busy_us / wall_us:.4f}); shares "
            + ", ".join(f"{g} {d / total:.3f}" for g, d in shares.items()))
        for r in res["profile"]["top"][:8]:
            log(f"[ssl profile]   {r['share']:.3f} {r['ms']:.3f} ms x{r['calls']} {r['name']}")
    else:
        log("[ssl profile] torch.profiler reported no device time: not measured")
    check(all(math.isfinite(res[k]) for k in ("flash_ms", "einsum_ms")), "ssl timing")


# --------------------------------------- K2's backward and the training slice
K2_BWD_TOL = {"f32": dict(atol=1e-4), "bf16": dict(cos=0.9999)}
TRAIN_WEIGHT_SEED = 20251018
TRAIN_SPEAKERS = 20
TRAIN_STEPS = 6
DEVICE = "cuda"  # the training phases' device; a CPU rehearsal sets "cpu"


def sync():
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def k2_bwd_bounds(b, t, h, key_len, dtype, bias_kind, bias_grad=True):
    """The least time each backward kernel, and the whole backward, can take
    on these inputs: bytes each input read once and each output written
    once (q, dO and the row statistics for every row, k and v for the valid
    keys, the bias as `k2_bound` counts it, dq / dk / dv for every row; the
    dQ kernel reads out (not D) and writes D, the gate's gradient (B, h, T)
    and dS (B, h, T, T), counted at T x T, not its padded rows; the function
    the bias's own gradient: the table's and the gate's for the factored
    bias), operations 2 h hd T sum_b(valid keys) per product on the dtype's
    peak: dK/dV needs 4 products (S, dP, dV, dK), dQ 3 (S, dP, dQ), the
    function 5 (S and dP once).  Returns {name: (ms, by, flop, bytes)}; under
    "dq_earlier" the bound of the earlier dQ kernel, which read D and wrote dS
    alone; under "materialized_dkv" / "materialized_dq" /
    "materialized_function" the bounds with the gated bias materialized, as
    the first kernels were called."""
    hd = 64
    elem = 2 if dtype == torch.bfloat16 else 4
    valid = int(key_len.sum()) if key_len is not None else b * t
    rows = elem * b * t * h * hd          # one (B, T, h, 64) tensor, every row
    keys = elem * valid * h * hd          # one over the valid keys
    stats = 4 * b * h * t                 # lse or D
    pairs_in = elem * h * t * valid
    ds_out = elem * b * h * t * t if bias_kind and bias_grad else 0
    bias_in, bias_grad_out = {
        "gated": (elem * (h * t * t + b * h * t),) * 2,
        "full": (pairs_in, ds_out),
        "broadcast": (elem * valid, elem * b * t),
        None: (0, 0)}[bias_kind]
    if not bias_grad:
        bias_grad_out = 0
    gate_grad_out = elem * b * h * t if bias_kind == "gated" else 0
    pair = 2 * h * hd * t * valid
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    base = {
        # q, dO, k, v, lse, D in; dk, dv out
        "dkv": (4 * pair, 2 * rows + 2 * keys + 2 * stats + 2 * rows),
        # q, dO, out, k, v, lse in; dq, D out
        "dq": (3 * pair, 3 * rows + 2 * keys + stats + rows + stats),
        # the earlier dQ kernel: q, dO, k, v, lse, D in; dq out
        "dq_earlier": (3 * pair, 2 * rows + 2 * keys + 2 * stats + rows),
        # q, k, v, out, dO, lse in; dq, dk, dv out
        "function": (5 * pair, 3 * rows + 2 * keys + stats + 3 * rows),
    }
    bias_terms = {"dkv": bias_in, "dq": bias_in + ds_out + gate_grad_out,
                  "dq_earlier": bias_in + ds_out, "function": bias_in + bias_grad_out}
    mat_in = pairs_in if bias_kind == "gated" else bias_in
    mat_out = ds_out if bias_kind == "gated" else bias_grad_out
    mat_terms = {"dkv": mat_in, "dq": mat_in + ds_out, "function": mat_in + mat_out}
    out = {}
    for name, (flop, nbytes) in base.items():
        ops_ms = flop / peak * 1e3
        variants = [(name, bias_terms[name])]
        mat = "dq" if name == "dq_earlier" else name  # the first dQ moved the earlier's rows
        if name != "dq":
            variants.append(("materialized_" + mat, mat_terms[mat]))
        for key, extra in variants:
            bytes_ms = (nbytes + extra) / PEAK_BYTES * 1e3
            out[key] = (max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes",
                        flop, nbytes + extra)
    return out


def kernel_device_ms(fn, names, reps=10):
    """Per-launch device time of each kernel whose name holds one of `names`,
    from a torch.profiler trace of `reps` warm calls: the traced time over
    the launches traced (a trace can drop launches); None when the trace has
    no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    out = {}
    for key in names:
        us = sum(d for n, d, _ in rows if key in n)
        calls = sum(c for n, _, c in rows if key in n)
        out[key] = us / 1e3 / calls if us else None
        out[key + "_launches_traced"] = calls
    return out


def graph_ms(fn, n=20, replays=5):
    """Device time per call of fn with no host in the way: n calls captured
    in a CUDA graph, events around its replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    del graph
    return a.elapsed_time(b) / (n * replays)


def phase_k2_bwd_checks(report):
    """The backward kernels (dK/dV, dQ + dBias), through the autograd
    Function's wrapper, against the plain backward; timed beside it and
    beside scaled_dot_product_attention's forward + backward."""
    from wespeaker_hubert_tpu_torch.ops import flash_attention as k2

    F = torch.nn.functional
    # (B, T, bias, key lengths): the training batch (gated bias, full
    # lengths), extraction's 16 x 10 s batch, no bias with random lengths, a
    # broadcast (B, 1, 1, T) bias, odd T, the 32 s bucket (bf16 only)
    cases = [(64, 75, "gated", "full"), (16, 499, "gated", "full"),
             (16, 499, None, "random"), (16, 499, "broadcast", "random"),
             (16, 131, "gated", "random"), (16, 99, "gated", "random"),
             (16, 1599, "gated", "random")]
    rows = []
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for i, (b, t, bias_kind, len_kind) in enumerate(cases):
            if tag == "f32" and t > 1000:
                continue
            h = 16
            q, k, v, bias, gate, key_len = k2_inputs(b, t, h, dtype, bias_kind, len_kind, 500 + i)
            dout = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(600 + i),
                               device="cuda").to(dtype)
            out, lse = k2.flash_attention_fwd(q, k, v, bias, key_len, return_lse=True,
                                              bias_gate=gate)
            args = (q, k, v, bias, key_len, None, out, lse, dout)
            call = lambda: k2.flash_attention_bwd(*args, bias_gate=gate)  # noqa: E731
            got = call()
            torch.cuda.synchronize()
            want = k2.flash_attention_bwd_reference(*args, bias_gate=gate)
            errs, coss, ok = {}, {}, True
            pairs = list(zip(("dq", "dk", "dv", "dbias", "dgate", "delta"), got, want))
            if bias_kind == "gated":  # the table's gradient from each dS
                pairs.append(("dtable", k2.factored_bias_grads(got.dbias, bias, gate),
                              k2.factored_bias_grads(want.dbias, bias, gate)))
            for name, g, w in pairs:
                if w is None:
                    ok = ok and g is None
                    continue
                ok = ok and g.shape == w.shape and g.dtype == w.dtype
                errs[name] = float((g.float() - w.float()).abs().max())
                coss[name] = float(F.cosine_similarity(g.float().flatten(), w.float().flatten(), dim=0))
                ok = ok and bool(torch.isfinite(g).all())
                ok = ok and (errs[name] <= K2_BWD_TOL["f32"]["atol"] if tag == "f32"
                             else coss[name] >= K2_BWD_TOL["bf16"]["cos"])
            ds = got.dbias
            del got, want, pairs
            # the kernels' backward alone (the wrapper: allocation, both
            # launches), each kernel's device time, the wrapper's host time,
            # the plain backward, and the table gradient's reduction
            k_ms = cuda_median_ms(call)
            per = kernel_device_ms(call, ("flash_bwd_dkv", "flash_bwd_dq"))
            g_ms = graph_ms(call)
            host_us = host_us_per_call(call, n=50)
            p_ms = cuda_median_ms(lambda: k2.flash_attention_bwd_reference(*args, bias_gate=gate),
                                  reps=5)
            red_ms = (cuda_median_ms(lambda: k2.factored_bias_grads(ds, bias, gate))
                      if bias_kind == "gated" else None)
            # SDPA forward + backward with the materialized bias (plus -inf
            # past each row's key length) as attn_mask; the mask's gradient
            # where PyTorch gives one
            valid = torch.arange(t, device="cuda")[None, :] < key_len[:, None]
            mask = (k2.effective_bias(bias, gate).expand(b, h, t, t) if bias is not None
                    else torch.zeros((b, 1, 1, t), dtype=dtype, device="cuda"))
            mask = mask.masked_fill(~valid[:, None, None, :], float("-inf")).contiguous()
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
            mask_leaf = mask.detach().requires_grad_(bias is not None)
            do_t = dout.transpose(1, 2)

            def sdpa_fwd_bwd():
                o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask_leaf)
                leaves = [qt, kt, vt] + ([mask_leaf] if mask_leaf.requires_grad else [])
                return torch.autograd.grad(o, leaves, do_t)

            try:
                grads = sdpa_fwd_bwd()
                l_ms = cuda_median_ms(sdpa_fwd_bwd, reps=10)
                lib_bias_grad = mask_leaf.requires_grad and grads[-1] is not None
            except RuntimeError as e:  # no backward for a mask needing a gradient
                log(f"[K2 bwd] SDPA with a mask gradient: {e}; timed without one")
                mask_leaf.requires_grad_(False)
                l_ms = cuda_median_ms(sdpa_fwd_bwd, reps=10)
                lib_bias_grad = False
            # SDPA's backward alone (memory-efficient attention pinned: flash
            # attention takes no mask), the same mask, no mask gradient
            from torch.nn.attention import SDPBackend

            try:
                lib_bwd_ms, lib_bwd_kernels = sdpa_backward(
                    qt, kt, vt, do_t, SDPBackend.EFFICIENT_ATTENTION, mask=mask.detach())
            except RuntimeError as e:  # the backend refuses these inputs
                lib_bwd_ms, lib_bwd_kernels = None, [f"refused: {str(e)[:120]}"]
            bounds = k2_bwd_bounds(b, t, h, key_len if len_kind != "full" else None, dtype,
                                   bias_kind)
            bound_ms = bounds["function"][0]
            row = dict(dtype=tag, shape=[b, t, h, 64], bias=bias_kind, key_len=len_kind,
                       tile_q=k2.key_tile(t) if tag == "bf16" else 16,
                       max_abs_err=errs, cosine=coss, ok=ok, ms=k_ms, host_us=host_us,
                       plain_ms=p_ms, library_ms=l_ms, library_bias_grad=lib_bias_grad,
                       library_bwd_ms=lib_bwd_ms, library_bwd_kernels=lib_bwd_kernels,
                       factored_grads_ms=red_ms, graph_ms=g_ms,
                       dkv_ms=per["flash_bwd_dkv"], dq_ms=per["flash_bwd_dq"],
                       launches_traced=[per["flash_bwd_dkv_launches_traced"],
                                        per["flash_bwd_dq_launches_traced"]],
                       bound_ms=bound_ms, bound_by=bounds["function"][1],
                       gflop=bounds["function"][2] / 1e9, mbytes=bounds["function"][3] / 1e6,
                       dkv_bound_ms=bounds["dkv"][0], dkv_bound_by=bounds["dkv"][1],
                       dq_bound_ms=bounds["dq"][0], dq_bound_by=bounds["dq"][1],
                       dq_earlier_bound_ms=bounds["dq_earlier"][0],
                       materialized_dkv_bound_ms=bounds["materialized_dkv"][0],
                       materialized_dq_bound_ms=bounds["materialized_dq"][0],
                       materialized_bound_ms=bounds["materialized_function"][0],
                       roofline_share=bound_ms / k_ms)
            mma_sync = {key: MMA_SYNC_MS.get((key, b, t)) if tag == "bf16" and bias_kind
                        else None for key in ("dkv", "dq")}
            rows.append(row)
            log(f"[K2 bwd] {tag} ({b}, {t}, {h}, 64) bias={bias_kind} key_len={len_kind} "
                f"query tile {row['tile_q']}: "
                + " ".join(f"{n} err {errs[n]:.2e} cos {coss[n]:.7f}" for n in errs)
                + f" {'ok' if ok else 'FAIL'} ({'atol 1e-4' if tag == 'f32' else 'cos >= 0.9999'}); "
                f"backward {k_ms:.4f} ms ({g_ms:.4f} in a CUDA graph; host {host_us:.1f} us per "
                f"call; traced launches {row['launches_traced']}; dK/dV {row['dkv_ms']} ms "
                f"against {row['dkv_bound_ms']:.5f}, mma.sync {mma_sync['dkv']}; "
                f"dQ {row['dq_ms']} ms "
                f"against {row['dq_bound_ms']:.5f} (the earlier dQ, reading D and writing dS "
                f"alone: {row['dq_earlier_bound_ms']:.5f}), mma.sync {mma_sync['dq']}; the "
                f"mma.sync times from PERF.md, not this run)"
                + (f", the table gradient's reduction {red_ms:.4f} ms" if red_ms is not None
                   else "")
                + f", plain {p_ms:.4f} ms, SDPA fwd+bwd {l_ms:.4f} ms "
                f"({'with' if lib_bias_grad else 'no'} mask gradient), SDPA backward alone "
                f"(EFFICIENT_ATTENTION, no mask gradient) {lib_bwd_ms} ms "
                f"[{'; '.join(lib_bwd_kernels)}], bound {bound_ms:.5f} ms "
                f"({bounds['function'][1]}: {bounds['function'][2] / 1e9:.2f} GFLOP, "
                f"{bounds['function'][3] / 1e6:.1f} MB; "
                f"{row['materialized_bound_ms']:.5f} with the bias materialized), "
                f"roofline share {bound_ms / k_ms:.4f}")
            del q, k, v, dout, bias, gate, out, lse, mask, mask_leaf, qt, kt, vt, ds
            torch.cuda.empty_cache()
    report["k2_bwd_checks"] = rows
    whisper = report["k2_whisper_bwd_checks"] = [
        whisper_k2_bwd_row(b, t, tag, dtype) for tag, dtype in (("f32", torch.float32),
                                                                ("bf16", torch.bfloat16))
        for b, t in WHISPER_K2_BWD] + [
        whisper_k2_bwd_row(b, t, "f32", torch.float32, K2_LARGE_LOGIT, seed)
        for b, t in WHISPER_K2_BWD for seed in K2_LARGE_LOGIT_SEEDS]
    check(all(r["ok"] for r in rows), "the flash-attention backward disagrees with its plain version")
    check(all(r["ok"] for r in whisper),
          "the flash-attention backward disagrees with its plain version at Whisper's shape")
    return rows[0]


def train_config(root, attn_impl="flash"):
    """examples/voxceleb/v2/conf/ecapa_tdnn_wavlm_joint_ft.yaml as a dict,
    with the run's overrides: raw seeded wavs, seeded stores, a seeded
    model_init, epoch_iter 6 in 1 epoch, the flash-attention knob."""
    return {
        "exp_dir": os.path.join(root, "exp"), "seed": 42, "enable_amp": True,
        "num_epochs": 1, "epoch_iter": TRAIN_STEPS, "save_epoch_interval": 1,
        "log_batch_interval": 1, "num_avg": 3, "model_parallel": 1,
        "data_type": "raw", "train_data": os.path.join(root, "train.list"),
        "train_label": os.path.join(root, "utt2spk"),
        "model_init": os.path.join(root, "init.pt"),
        "dataloader_args": {"batch_size": 64, "num_workers": 8},
        "dataset_args": {
            "shuffle": True, "shuffle_args": {"shuffle_size": 2500},
            "filter_args": {"min_num_frames": 50, "max_num_frames": 400},
            "resample_rate": SR, "speed_perturb": True, "num_frms": 150, "aug_prob": 0.6,
            "reverb_data": os.path.join(root, "rirs_aug_store"),
            "noise_data": os.path.join(root, "musan_aug_store"),
            "frontend": "s3prl",
            "s3prl_args": {"upstream": "wavlm_large", "frozen": False, "hf_checkpoint": None,
                           "attn_impl": attn_impl},
            "spec_aug": True,
            "spec_aug_args": {"num_t_mask": 1, "num_f_mask": 1, "max_t": 10, "max_f": 8,
                              "prob": 0.6},
        },
        "model": "ECAPA_TDNN_GLOB_c512",
        "model_args": {"feat_dim": 1024, "embed_dim": 192, "pooling_func": "ASTP"},
        "projection_args": {"project_type": "arc_margin", "scale": 32.0, "easy_margin": False},
        "margin_update": {"initial_margin": 0.2, "final_margin": 0.2, "increase_start_epoch": 1,
                          "fix_start_epoch": 1, "update_margin": True},
        "loss": "CrossEntropyLoss", "optimizer": "SGD",
        "optimizer_args": {"momentum": 0.9, "nesterov": True, "weight_decay": 0.0001},
        "scheduler": "ExponentialDecrease",
        "scheduler_args": {"initial_lr": 0.001, "final_lr": 0.00025, "warm_up_epoch": 1},
    }


def write_train_dir(root):
    """Seeded 2-4 s wavs of TRAIN_SPEAKERS speakers (the config's filter
    keeps 0.5-4 s), enough for TRAIN_STEPS batches of 64; a RIR store and a
    noise store with noise / music / speech keys; a seeded model_init."""
    from wespeaker_hubert_tpu_torch.data.wav_io import write_wav
    from wespeaker_hubert_tpu_torch.models.speaker_net import build_speaker_net

    rng = np.random.default_rng(TRAIN_WEIGHT_SEED)
    lines, labels = [], []
    for i in range(64 * TRAIN_STEPS + 16):
        spk = f"spk{i % TRAIN_SPEAKERS:02d}"
        path = os.path.join(root, f"tr{i:03d}.wav")
        write_wav(path, audio(20000 + i, float(rng.uniform(2.0, 4.0))))
        lines.append(json.dumps({"key": f"tr{i:03d}", "wav": path, "spk": spk}))
        labels.append(f"tr{i:03d} {spk}")
    with open(os.path.join(root, "train.list"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "utt2spk"), "w") as f:
        f.write("\n".join(labels) + "\n")
    stores = {"rirs_aug_store": {f"rir{i}": np.exp(-np.arange(4000) / 800.0)
                                 * rng.standard_normal(4000) for i in range(8)},
              "musan_aug_store": {f"{kind}{i}": 0.1 * rng.standard_normal(48000)
                                  for kind in ("noise", "music", "speech") for i in range(3)}}
    for name, arrays in stores.items():
        d = os.path.join(root, name)
        os.makedirs(d)
        for key, x in arrays.items():
            np.save(os.path.join(d, key + ".npy"), x.astype(np.float32))
        with open(os.path.join(d, "index.json"), "w") as f:
            json.dump({k: k + ".npy" for k in arrays}, f)
    net = build_speaker_net(train_config(root))
    torch.save(ssl_state_dict(net, TRAIN_WEIGHT_SEED), os.path.join(root, "init.pt"))
    with open(os.path.join(root, "eval.jsonl"), "w") as f:
        f.write("\n".join(lines[:8]) + "\n")


def _counts():
    from wespeaker_hubert_tpu_torch.ops import flash_attention as k2

    return k2.LAUNCHES, k2.LAUNCHES_BWD_DKV, k2.LAUNCHES_BWD_DQ, k2.BIAS_RELAYOUTS


def _zero_counts():
    from wespeaker_hubert_tpu_torch.ops import flash_attention as k2

    k2.LAUNCHES = k2.LAUNCHES_BWD_DKV = k2.LAUNCHES_BWD_DQ = k2.BIAS_RELAYOUTS = 0


def phase_train(report, root):
    """bin/train.train on the joint fine-tuning config at full width, bf16,
    for TRAIN_STEPS steps; returns the launches of K2's forward, dK/dV and
    dQ in that run (the main path)."""
    from wespeaker_hubert_tpu_torch.bin.extract import extract
    from wespeaker_hubert_tpu_torch.bin.train import train
    from wespeaker_hubert_tpu_torch.train.schedulers import ExponentialDecrease

    write_train_dir(root)
    cfg = train_config(root)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()  # the training run's peak alone
    _zero_counts()
    t0 = time.perf_counter()
    state = train(cfg, device=DEVICE)
    sync()
    wall = time.perf_counter() - t0
    fwd, dkv, dq, relayouts = _counts()
    with open(os.path.join(cfg["exp_dir"], "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    steps = [m["step"] for m in metrics]
    times = [m["time"] for m in metrics]
    step_ms = [1e3 * (b - a) for a, b in zip(times, times[1:])]
    median_ms = statistics.median(step_ms)
    lr = ExponentialDecrease(num_epochs=1, epoch_iter=TRAIN_STEPS, initial_lr=1e-3,
                             final_lr=2.5e-4, warm_up_epoch=1)
    lr_err = max(abs(m["lr"] - lr(m["step"] - 1)) / lr(m["step"] - 1) for m in metrics)
    margin_err = max(abs(m["margin"] - 0.2) for m in metrics)
    out = {"steps": state.step, "batch": 64, "entry_wall_s": wall, "launches":
           {"flash_fwd": fwd, "flash_bwd_dkv": dkv, "flash_bwd_dq": dq}, "bias_copies": relayouts,
           "loss": [m["loss"] for m in metrics], "acc": [m["acc"] for m in metrics],
           "lr": [m["lr"] for m in metrics], "margin": [m["margin"] for m in metrics],
           "lr_max_rel_err": lr_err, "margin_max_err": margin_err,
           "step_ms": step_ms, "step_ms_median_after_first": median_ms,
           "audio_s_per_s": 64 * 1.5 / (median_ms / 1e3),
           "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda"
                           else "not measured")}
    log(f"[train] bin/train {state.step} steps of batch 64 (WavLM-Large + ECAPA_TDNN_GLOB_c512, "
        f"bf16, flash): {wall:.1f} s with set-up; losses "
        + ", ".join(f"{x:.3f}" for x in out["loss"]) + f"; lr max rel err {lr_err:.2e}, margin "
        f"max err {margin_err:.2e}; step {median_ms:.1f} ms median after the first ("
        + ", ".join(f"{x:.0f}" for x in step_ms) + f") = {out['audio_s_per_s']:.1f} audio-s/s; "
        f"launches fwd {fwd}, dK/dV {dkv}, dQ {dq} (want {24 * TRAIN_STEPS} each)")
    report["train"] = out
    check(state.step == TRAIN_STEPS and steps == list(range(1, TRAIN_STEPS + 1)),
          f"train: steps {steps}")
    check(all(math.isfinite(x) for x in out["loss"]), f"train: losses {out['loss']}")
    check(lr_err < 1e-6 and margin_err < 1e-7, "train: LR or margin off their schedules")
    check(fwd == dkv == dq == 24 * TRAIN_STEPS,
          f"train: K2 launches fwd {fwd} dkv {dkv} dq {dq}, want {24 * TRAIN_STEPS} each")
    check(relayouts == 0, f"train: {relayouts} bias copies (the gated bias goes in factored)")
    ckpt = os.path.join(cfg["exp_dir"], "models", "model_1.pt")
    keys, emb = extract(os.path.join(cfg["exp_dir"], "config.json"),
                        os.path.join(root, "eval.jsonl"), ckpt, "", batch_size=8, device=DEVICE)
    out["extract_from_model_1"] = {"n": len(keys), "finite": bool(np.isfinite(emb).all())}
    log(f"[train] models/model_1.pt -> bin/extract: {emb.shape} embeddings, finite "
        f"{bool(np.isfinite(emb).all())}")
    check(emb.shape == (8, 192) and np.isfinite(emb).all(), "train: extract from model_1.pt")
    del state
    empty_cache()
    return fwd, dkv, dq


def empty_cache():
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


NET_TEMPLATES = {}


def built_once(key, build):
    """A copy of the model `build()` makes on the host for `key`: built once
    (a full-size model's initialization takes the host seconds), then deep-
    copied for each run.  main() drops the templates after the phases that
    use them."""
    if key not in NET_TEMPLATES:
        NET_TEMPLATES[key] = build()
    return copy.deepcopy(NET_TEMPLATES[key])


def _train_net(root, attn_impl, device, spec_aug=True):
    """The slice's SpeakerNet (seeded init.pt, projection from a seeded
    generator), its TrainState and float32 train step on `device`."""
    from wespeaker_hubert_tpu_torch.bin.train import _feature_cfg
    from wespeaker_hubert_tpu_torch.models.speaker_net import build_speaker_net, load_speaker_state
    from wespeaker_hubert_tpu_torch.train.executor import make_train_step
    from wespeaker_hubert_tpu_torch.train.schedulers import ExponentialDecrease, MarginSchedule
    from wespeaker_hubert_tpu_torch.train.state import TrainState, make_optimizer

    cfg = train_config(root, attn_impl)
    cfg["dataset_args"]["spec_aug"] = spec_aug

    def build():
        torch.manual_seed(0)
        net = build_speaker_net(cfg, 3 * TRAIN_SPEAKERS)
        load_speaker_state(net, torch.load(os.path.join(root, "init.pt"), weights_only=True))
        return net

    net = built_once(("train", root, attn_impl), build).to(device)
    lr = ExponentialDecrease(num_epochs=1, epoch_iter=TRAIN_STEPS, initial_lr=1e-3,
                             final_lr=2.5e-4, warm_up_epoch=1)
    margin = MarginSchedule(TRAIN_STEPS, 1, 1, 0.2, 0.2)
    state = TrainState(net, make_optimizer(net), lr)
    step = make_train_step(net, lr, margin, feature_cfg=_feature_cfg(cfg["dataset_args"]),
                           chunk_samples=24240, seed=43)
    return net, state, step


def _one_step(net, state, step, batch, prefix="frontend."):
    """(loss, {tensor: p_new - p_old}, {tensor: max |p_old|}) over the
    floating tensors whose names start with `prefix`."""
    before = {k: v.detach().float().cpu().clone() for k, v in net.state_dict().items()
              if k.startswith(prefix) and v.is_floating_point()}
    metrics = step(state, batch)
    upd = {k: net.state_dict()[k].detach().float().cpu() - v for k, v in before.items()}
    return float(metrics["loss"]), upd, {k: float(v.abs().max()) for k, v in before.items()}


# A frontend tensor's two updates agree when their cosine reaches the bar,
# or when they differ by no more than the same model's updates differ under
# an input perturbation of float32's rounding size (CONTROL_EPS; the factor
# CONTROL_SLACK allows for the kernels' rounding entering at every layer),
# or by at most NOISE_FLOOR (or two float32 spacings of the tensor's largest
# value, the resolution of p_new - p_old) in every element.  Some frontend
# updates are
# that sensitive in float32: attention's key bias (a zero gradient by
# construction), query biases (sums over keys whose dS rows add up to 0),
# and, through the ECAPA BatchNorm's batch statistics of nearly constant
# pooled features, most tensors at a cosine of 0.999 or so.  1e-8 at lr
# 1e-3 is a gradient difference of 5e-6.
NOISE_FLOOR = 1e-8
CONTROL_EPS = 2.0 ** -20
CONTROL_SLACK = 4.0


def _diff_table(a, b):
    """name -> (cosine, max abs difference) of two update dicts."""
    table = {}
    for k in a:
        x, y = a[k].double().flatten(), b[k].double().flatten()
        n = float(x.norm() * y.norm())
        cos = float(x @ y) / n if n > 0 else (1.0 if float((x - y).abs().max()) == 0 else 0.0)
        table[k] = (cos, float((x - y).abs().max()))
    return table


def _update_agreement(pair, control, bar, magnitude):
    """Per frontend tensor: the pair's (cosine, max diff) and the control's;
    `magnitude` the tensor's largest |value|.  Returns the failing tensors
    and how many passed by each rule."""
    failing, how = {}, {"cosine": 0, "within_control": 0, "noise_floor": 0}
    for k, (cos, diff) in pair.items():
        if cos >= bar:
            how["cosine"] += 1
        elif diff <= CONTROL_SLACK * control[k][1]:
            how["within_control"] += 1
        elif diff <= max(NOISE_FLOOR, 2.0 * magnitude[k] * 2.0 ** -23):
            how["noise_floor"] += 1
        else:
            failing[k] = {"pair": (cos, diff), "control": control[k]}
    return failing, how


def _rel_l2(a, b):
    num = sum(float((a[k].double() - b[k].double()).norm()) ** 2 for k in a)
    den = sum(float(b[k].double().norm()) ** 2 for k in a)
    return (num / den) ** 0.5


def _perturbed(batch):
    return {k: (v * (1.0 + CONTROL_EPS) if k == "wav" else v) for k, v in batch.items()}


def phase_train_checks(report, root):
    """(a) one float32 step with K2 against one with plain attention, same
    batch and weights, batch 64; (b) one float32 step on the card against
    the port's CPU float32 step, batch 2; each held against a control (the
    same step on the input perturbed by CONTROL_EPS); (c) the device idle
    share of 3 bf16 steps and a grouped profile of one.  Every result is in
    the report before the checks run."""
    from torch.profiler import ProfilerActivity, profile

    from wespeaker_hubert_tpu_torch.data.dataset import TrainPipeline, TrainPipelineConfig
    from wespeaker_hubert_tpu_torch.bin.train import read_spk2id, _to_device
    from wespeaker_hubert_tpu_torch.data.aug_store import AugStore

    cfg = train_config(root)
    da = cfg["dataset_args"]
    pipe = TrainPipeline(
        [ln for ln in open(cfg["train_data"]).read().splitlines() if ln],
        read_spk2id(cfg["train_label"]),
        TrainPipelineConfig(num_frms=150, filter_min_frames=50, filter_max_frames=400,
                            aug_prob=0.6, batch_size=64, seed=7),
        AugStore(root=da["reverb_data"]), AugStore(root=da["noise_data"]))
    host_batch = next(iter(pipe))
    batch = _to_device(host_batch, torch.device(DEVICE))
    out = report["train_checks"] = {}
    # (a) K2 against plain attention, float32 on the card; the control is
    # plain attention on the same batch perturbed by CONTROL_EPS
    res = {}
    for tag, impl, b in (("flash", "flash", batch), ("einsum", "einsum", batch),
                         ("control", "einsum", _perturbed(batch))):
        net, state, step = _train_net(root, impl, DEVICE)
        _zero_counts()
        res[tag] = _one_step(net, state, step, b)
        res[tag + "_launches"] = _counts()
        del net, state, step
        empty_cache()
    loss_rel = abs(res["flash"][0] - res["einsum"][0]) / abs(res["einsum"][0])
    pair = _diff_table(res["flash"][1], res["einsum"][1])
    control = _diff_table(res["control"][1], res["einsum"][1])
    failing_a, how = _update_agreement(pair, control, 0.99999, res["einsum"][2])
    worst = sorted(pair.items(), key=lambda kv: kv[1][0])[:4]
    out["f32_k2_vs_plain"] = {
        "loss": [res["flash"][0], res["einsum"][0], res["control"][0]], "loss_rel": loss_rel,
        "control_loss_rel": abs(res["control"][0] - res["einsum"][0]) / abs(res["einsum"][0]),
        "updates_rel_l2": _rel_l2(res["flash"][1], res["einsum"][1]),
        "control_updates_rel_l2": _rel_l2(res["control"][1], res["einsum"][1]),
        "n_tensors": len(pair), "passed_by": how, "worst": worst, "failing": failing_a,
        "control_min_cos": min(c for c, _ in control.values()),
        "launches_flash": res["flash_launches"], "launches_einsum": res["einsum_launches"]}
    r = out["f32_k2_vs_plain"]
    log(f"[train a] f32 step, K2 vs plain attention (batch 64): loss {res['flash'][0]:.6f} vs "
        f"{res['einsum'][0]:.6f} (rel {loss_rel:.2e}, bar 1e-5); frontend updates: relative L2 "
        f"{r['updates_rel_l2']:.2e} (plain vs plain on the wav x (1 + 2^-20): "
        f"{r['control_updates_rel_l2']:.2e}, loss rel {r['control_loss_rel']:.2e}); of "
        f"{len(pair)} tensors {how['cosine']} at cosine >= 0.99999, {how['within_control']} "
        f"within {CONTROL_SLACK:g}x the control's difference, {how['noise_floor']} at the noise "
        f"floor, {len(failing_a)} failing; least cosines {worst}; control's least "
        f"cosine {r['control_min_cos']:.7f}")
    del res
    # (b) the card against the CPU, float32, batch 2 (SpecAug off: the two
    # devices' generators draw differently); the control is the card on the
    # perturbed batch
    small = {k: v[:2] for k, v in host_batch.items() if k in ("wav", "speed_idx", "label")}
    small_res = {}
    for tag, dev, scale in ((DEVICE, DEVICE, False), ("cpu", "cpu", False),
                            ("control", DEVICE, True)):
        net, state, step = _train_net(root, "flash", dev, spec_aug=False)
        b = _to_device(small, torch.device(dev))
        t0 = time.perf_counter()
        small_res[tag] = _one_step(net, state, step, _perturbed(b) if scale else b)
        small_res[tag + "_s"] = time.perf_counter() - t0
        del net, state, step
    empty_cache()
    loss_rel_b = abs(small_res[DEVICE][0] - small_res["cpu"][0]) / abs(small_res["cpu"][0])
    pair = _diff_table(small_res[DEVICE][1], small_res["cpu"][1])
    control = _diff_table(small_res["control"][1], small_res[DEVICE][1])
    failing_b, how = _update_agreement(pair, control, 0.9999, small_res["cpu"][2])
    worst = sorted(pair.items(), key=lambda kv: kv[1][0])[:4]
    out["f32_card_vs_cpu"] = {
        "loss": [small_res[DEVICE][0], small_res["cpu"][0]], "loss_rel": loss_rel_b,
        "updates_rel_l2": _rel_l2(small_res[DEVICE][1], small_res["cpu"][1]),
        "control_updates_rel_l2": _rel_l2(small_res["control"][1], small_res[DEVICE][1]),
        "n_tensors": len(pair), "passed_by": how, "worst": worst, "failing": failing_b,
        "cpu_step_s": small_res["cpu_s"]}
    r = out["f32_card_vs_cpu"]
    log(f"[train b] f32 step, card vs CPU (batch 2, speed perturbation, no aug or SpecAug): loss "
        f"{small_res[DEVICE][0]:.6f} vs {small_res['cpu'][0]:.6f} (rel {loss_rel_b:.2e}, bar "
        f"1e-4); frontend updates: relative L2 {r['updates_rel_l2']:.2e} (control "
        f"{r['control_updates_rel_l2']:.2e}); of {len(pair)} tensors {how['cosine']} at cosine "
        f">= 0.9999, {how['within_control']} within the control, {how['noise_floor']} at the "
        f"noise floor, {len(failing_b)} failing; least cosines {worst}; CPU step "
        f"{small_res['cpu_s']:.1f} s")
    del small_res
    # (c) bf16 steps under the profiler
    net, state, step = _train_net(root, "flash", DEVICE)
    from wespeaker_hubert_tpu_torch.train.executor import make_train_step
    from wespeaker_hubert_tpu_torch.bin.train import _feature_cfg

    step = make_train_step(net, state.lr_schedule, lambda s: 0.2,
                           feature_cfg=_feature_cfg(cfg["dataset_args"]), chunk_samples=24240,
                           compute_dtype=torch.bfloat16, seed=43)
    for _ in range(2):
        step(state, batch)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step(state, batch)
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    out["profile"] = grouped_profile(
        prof, wall_us, {"K2 flash_fwd": ("flash_fwd",), "K2 flash_bwd": ("flash_bwd",),
                        **PROFILE_GROUPS})
    out["profile"]["window"] = "3 bf16 train steps, batch 64, WavLM-Large + ECAPA_TDNN_GLOB_c512"
    total = out["profile"]["device_ms"]
    if total:
        log(f"[train profile] 3 bf16 steps: device {total:.2f} ms over {wall_us / 1e3:.2f} "
            f"ms wall (idle share {out['profile']['device_idle_share']:.4f}); shares "
            + ", ".join(f"{g} {d:.3f}" for g, d in out["profile"]["shares"].items()))
        for g in ("K2 flash_fwd", "K2 flash_bwd", "GEMM", "conv"):
            log(f"[train profile]   {g}: " + "; ".join(out["profile"]["group_top"][g][:3]))
    else:
        log("[train profile] torch.profiler reported no device time: not measured")
    a, b = out["f32_k2_vs_plain"], out["f32_card_vs_cpu"]
    check(a["loss_rel"] <= 1e-5 and not a["failing"], "train (a): K2 step vs plain-attention step")
    check(a["launches_flash"] == (24, 24, 24, 0) and a["launches_einsum"] == (0, 0, 0, 0),
          f"train (a): launches {a['launches_flash']} / {a['launches_einsum']}")
    check(b["loss_rel"] <= 1e-4 and not b["failing"], "train (b): card step vs CPU step")


# ------------------------------------------------ the flagship recipe
RECIPE_CONFIG = Path(__file__).resolve().parent / "examples/voxceleb/v2/conf/ecapa_tdnn.yaml"
RECIPE_SPEAKERS = 5994  # VoxCeleb2 dev: the head has 3 x 5,994 classes
RECIPE_TRAIN_SPEAKERS, RECIPE_PER_SPEAKER = 128, 12  # 1,536 utterances: 12 batches of
# 128 per epoch, one 8-step call and a 4-step tail where the data run out (bin/train,
# as JAX's, checks epoch_iter only after a full group, so epoch_iter 12 does not cut it)
RECIPE_SEED = 20251019
PROFILE_GROUPS = {
    # cuDNN's FFT convolution algorithms: their transforms (DSE::, fft2d_),
    # complex products and tile transforms (ResNet34's float32 step picks
    # them); cuFFT's own kernels (the augmentation's reverb) have other names
    "conv (FFT algorithm)": ("dse::", "fft2d_", "pointwise_mult_and_sum_complex",
                             "region_transform", "flip_filter", "gemm_cf32"),
    "conv": ("fprop", "dgrad", "wgrad", "cudnn", "convol", "winograd", "implicit_gemm"),
    "GEMM": ("nvjet", "gemm", "cutlass", "xmma", "cublas"),
    "norms": ("layer_norm", "group_norm", "batch_norm"),
    "FFT (augmentation)": ("fft", "radix", "vector_fft"),
    "optimizer": ("foreach", "multi_tensor"),
    "copies and casts": ("copy", "memcpy", "memset", "catarray"),
    "elementwise": ("elementwise", "reduce", "softmax", "gelu", "index")}


def grouped_profile(prof, wall_us, groups):
    """Device time of a torch.profiler run by group (first match of a
    group's substrings in the kernel's name), the idle share of `wall_us`
    and each group's largest kernels."""
    rows = device_rows(prof)
    total = sum(r[1] for r in rows)
    busy_us, _ = device_busy_us(prof)
    shares = {g: 0.0 for g in list(groups) + ["other"]}
    members = {g: [] for g in shares}
    for name, d, _ in rows:
        group = next((g for g, keys in groups.items()
                      if any(key in name.lower() for key in keys)), "other")
        shares[group] += d
        members[group].append((d, name[:110]))
    return {
        "wall_ms": wall_us / 1e3, "device_ms": total / 1e3,
        "device_idle_share": 1 - busy_us / wall_us if total else "not measured",
        "shares": {g: d / total for g, d in shares.items()} if total else "not measured",
        "group_top": {g: [f"{d / 1e3:.3f} ms {n}" for d, n in sorted(m, reverse=True)[:4]]
                      for g, m in members.items()},
    }


def speechlike(rng, seconds, f0, sr=SR):
    """Two harmonics of f0 under a syllable-rate envelope over a noise floor,
    on the int16 grid, at `sr`."""
    t = np.arange(int(seconds * sr)) / sr
    env = np.clip(np.sin(2 * np.pi * rng.uniform(2, 6) * t + rng.uniform(0, 6)), 0, None)
    x = env * (0.1 * np.sin(2 * np.pi * f0 * t) + 0.05 * np.sin(4 * np.pi * f0 * t + 1.0))
    x = x + rng.uniform(0.005, 0.03) * rng.standard_normal(len(t))
    return (np.round(np.clip(x, -1, 1) * 32767) / 32768).astype(np.float32)


def write_recipe_data(data):
    """The recipe's DATA directory from seeded audio: MUSAN / RIR stand-ins
    (seeded noise, impulse responses), vox2_dev with 1,536 utterances of
    2.5-7.95 s over 128 speakers (12 each, a third over 6 s) and an utt2spk
    that names all 5,994 training speakers (the rest without audio), and
    vox1 with 64 utterances of 3-8 s over 8 speakers and a labeled trial
    list over all their pairs.  Returns the audio seconds of each list."""
    from wespeaker_hubert_tpu_torch.data.wav_io import write_wav

    rng = np.random.default_rng(RECIPE_SEED)

    def put(path, x):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_wav(path, x)
        return path

    scp = []
    for kind, n in (("noise", 3), ("music", 2), ("speech", 2)):
        for i in range(n):
            x = (rng.uniform(0.05, 0.2) * rng.standard_normal(6 * SR)).astype(np.float32)
            scp.append(f"{kind}-{i} {put(f'{data}/musan/{kind}-{i}.wav', x)}")
    Path(f"{data}/musan/wav.scp").write_text("\n".join(scp) + "\n")
    scp = []
    for i in range(4):
        n = int(0.25 * SR)
        x = rng.standard_normal(n) * np.exp(-np.arange(n) / rng.uniform(400, 1600)) * 0.3
        x[0] = 1.0
        scp.append(f"rir-{i} {put(f'{data}/rirs/rir-{i}.wav', x.astype(np.float32))}")
    Path(f"{data}/rirs/wav.scp").write_text("\n".join(scp) + "\n")
    seconds = {}
    for dset, n_spk, per, lo, hi in (("vox2_dev", RECIPE_TRAIN_SPEAKERS, RECIPE_PER_SPEAKER,
                                      2.5, 7.95), ("vox1", 8, 8, 3.0, 8.0)):
        prefix = "id0" if dset == "vox2_dev" else "id1"
        scp, u2s, total = [], [], 0.0
        for s in range(n_spk):
            spk, f0 = f"{prefix}{s:04d}", rng.uniform(90, 280)
            for j in range(per):
                d = float(rng.uniform(lo, hi))
                x = speechlike(rng, d, f0)
                total += len(x) / SR
                key = f"{spk}-{j:02d}"
                scp.append(f"{key} {put(f'{data}/{dset}/wav/{key}.wav', x)}")
                u2s.append(f"{key} {spk}")
        if dset == "vox2_dev":
            u2s += [f"id0{s:04d}-absent id0{s:04d}" for s in range(n_spk, RECIPE_SPEAKERS)]
        Path(f"{data}/{dset}/wav.scp").write_text("\n".join(scp) + "\n")
        Path(f"{data}/{dset}/utt2spk").write_text("\n".join(u2s) + "\n")
        seconds[dset] = total
    keys = [ln.split()[0] for ln in Path(f"{data}/vox1/wav.scp").read_text().splitlines()]
    trials = [f"{a} {b} {'target' if a[:7] == b[:7] else 'nontarget'}"
              for i, a in enumerate(keys) for b in keys[i + 1:]]
    Path(f"{data}/vox1/vox1_O_cleaned.kaldi").write_text("\n".join(trials) + "\n")
    return seconds


class _StepTimer:
    """Wraps bin/train's make_train_step so every call of the step it makes
    is timed with a device synchronize after it: (steps in the call,
    seconds), and keeps the margins the call reports.  The synchronize is
    the only change to the run."""

    def __init__(self):
        self.calls, self.margins = [], []

    def __call__(self, make):
        def timed_make(*args, **kwargs):
            fn = make(*args, **kwargs)

            def step(state, batch):
                t0 = time.perf_counter()
                out = fn(state, batch)
                sync()
                self.calls.append((int(batch["label"].shape[0]) if batch["label"].dim() == 2
                                   else 1, time.perf_counter() - t0))
                m = out["margin"]
                self.margins += m if isinstance(m, list) else [m]
                return out
            return step
        return timed_make


class _K1Spy:
    """Wraps ops/fbank_kernel.fbank_kernel for a run: keeps a copy of every
    input the run hands it, in order, with its config (`cfgs`), and calls
    the wrapper unchanged, so each launch counts as the run's.  The copies
    are the only change to the run."""

    def __init__(self, module):
        self.module, self.fn, self.inputs, self.cfgs = module, module.fbank_kernel, [], []

    def __enter__(self):
        def spy(wav, cfg):
            self.inputs.append(wav.clone())
            self.cfgs.append(cfg)
            return self.fn(wav, cfg)
        self.module.fbank_kernel = spy
        return self

    def __exit__(self, *exc):
        self.module.fbank_kernel = self.fn


def k1_held(got, want, truth):
    """K1's bar, FBANK_TOL, element by element: against the plain version
    where that version meets the float64 log-mel, against the float64
    log-mel where it does not.  Returns (held, plain_off)."""
    plain_off = ~torch.isclose(want.double(), truth, **FBANK_TOL)
    held = torch.where(plain_off, torch.isclose(got.double(), truth, **FBANK_TOL),
                       torch.isclose(got, want, **FBANK_TOL))
    return held, plain_off


def k1_on_eval_batches(lists, caught=None, mels=80):
    """K1 against its plain version and a float64 log-mel on every batch
    that EvalPipeline (bin/extract's batching, batch 32, `mels` mels) makes of
    `lists`, in the order stage 4 extracts them.  The bar, FBANK_TOL, holds
    K1 to the plain version on every element where that version meets it
    against the float64 log-mel, and to the float64 log-mel where it does
    not: at the lowest mels of frames whose energy lies some e^25 above
    them the plain version's own float32 rounding passes the bar.  With
    `caught` (the spy's inputs of stage 4) each batch must equal the input
    K1 was given there, so these are the main path's own inputs.  Per shape: the batches, the elements past the bar, and the
    largest errors split into the frames each row's length makes valid and
    the frames past them (which the consumer masks, ops/fbank.py), with the
    worst valid element against the plain version described.  Returns
    (rows, all batches matched)."""
    import dataclasses

    from wespeaker_hubert_tpu_torch.data.dataset import EvalPipeline, load_data_list
    from wespeaker_hubert_tpu_torch.ops import fbank_kernel
    from wespeaker_hubert_tpu_torch.ops.fbank import FbankConfig

    cfg = FbankConfig(num_mel_bins=mels, dither=0.0, spectrum_impl="matmul")
    rows, i, matched = {}, 0, True
    for path in lists:
        for batch in EvalPipeline(load_data_list(path), batch_size=32):
            wav = torch.from_numpy(batch["wav"]).cuda()
            if caught is not None:
                matched &= i < len(caught) and bool(torch.equal(caught[i], wav))
            i += 1
            got = fbank_kernel.fbank_kernel(wav, dataclasses.replace(cfg))
            want = fbank_kernel.fbank_kernel_reference(wav, cfg)
            truth = fbank_float64(wav, cfg)
            n_valid = torch.from_numpy(
                np.maximum(0, 1 + (batch["length"].astype(np.int64) - 400) // 160)).cuda()
            valid = (torch.arange(got.shape[1], device="cuda")[None, :] < n_valid[:, None])
            valid = valid[:, :, None].expand_as(got)
            row = rows.setdefault(tuple(wav.shape), {
                "shape": list(wav.shape), "batches": 0, "off_bar": 0, "plain_off_float64": 0,
                "finite": True,
                "valid": {"max_abs_err": 0.0, "kernel_vs_float64": 0.0, "plain_vs_float64": 0.0},
                "padded": {"max_abs_err": 0.0, "kernel_vs_float64": 0.0, "plain_vs_float64": 0.0}})
            row["batches"] += 1
            held, plain_off = k1_held(got, want, truth)
            row["off_bar"] += int((~held).sum())
            row["plain_off_float64"] += int(plain_off.sum())
            row["finite"] &= bool(torch.isfinite(got).all())
            for part, mask in (("valid", valid), ("padded", ~valid)):
                d = torch.where(mask, (got - want).abs(), 0.0)
                r = row[part]
                r["kernel_vs_float64"] = max(r["kernel_vs_float64"], float(
                    torch.where(mask, (got.double() - truth).abs(), 0.0).max()))
                r["plain_vs_float64"] = max(r["plain_vs_float64"], float(
                    torch.where(mask, (want.double() - truth).abs(), 0.0).max()))
                if float(d.max()) >= r["max_abs_err"]:
                    r["max_abs_err"] = float(d.max())
                    b, t, m = np.unravel_index(int(d.argmax()), got.shape)
                    r["worst"] = {"row": int(b), "frame": int(t), "mel": int(m),
                                  "valid_frames": int(n_valid[b]),
                                  "float64": float(truth[b, t, m]), "kernel": float(got[b, t, m]),
                                  "plain": float(want[b, t, m]),
                                  "frame_max_float64": float(truth[b, t].max())}
            del wav, got, want, truth, valid, plain_off, held
    if caught is not None:
        matched &= i == len(caught)
    return list(rows.values()), matched


def _score_column(path, col):
    with open(path) as f:
        return np.asarray([float(ln.split()[col]) for ln in f])


def recipe_against_cpu(data, exp, out, config=None, tag="recipe", eval_set="vox1",
                       cohort_set="vox2_dev", trials=None):
    """What stages 4-6 wrote on the card against the CPU: the embeddings of
    the first 16 `eval_set` utterances by bin/extract on the CPU (the plain
    fbank, from the same avg_model.pt, `config`), and the cosine and AS-Norm
    score files of each trial file (VoxCeleb1-O unless `trials` names them)
    recomputed on the CPU from the card's embeddings, `cohort_set` the
    cohort.  Returns the failures."""
    from wespeaker_hubert_tpu_torch.bin.extract import extract
    from wespeaker_hubert_tpu_torch.bin.score import score_norm, score_trials
    from wespeaker_hubert_tpu_torch.recipes import voxceleb_v2
    from wespeaker_hubert_tpu_torch.utils.embeddings import embeddings_dict

    emb_dir, score_dir = os.path.join(exp, "embeddings"), os.path.join(exp, "scores")
    cpu_dir = os.path.join(exp, "cpu_check")
    sub = os.path.join(cpu_dir, f"{eval_set}_16.list")
    os.makedirs(cpu_dir, exist_ok=True)
    lines = Path(data, eval_set, "raw.list").read_text().splitlines()[:16]
    Path(sub).write_text("\n".join(lines) + "\n")
    eval_emb = os.path.join(emb_dir, f"{eval_set}.npz")
    card = embeddings_dict(eval_emb)
    keys, emb = extract(str(config or RECIPE_CONFIG), sub, os.path.join(exp, "avg_model.pt"), "",
                        device="cpu")
    cos = [cosine(card[k], e) for k, e in zip(keys, emb)]
    trials = trials or [os.path.join(data, "vox1", "vox1_O_cleaned.kaldi")]
    mean_vec = os.path.join(emb_dir, f"{cohort_set}_mean.npy")
    score_err = norm_err = 0.0
    for trial in trials:
        cpu_score = score_trials(eval_emb, [trial], cpu_dir, mean_vec, device="cpu")[0]
        card_score = os.path.join(score_dir, os.path.basename(trial) + ".score")
        cpu_norm = score_norm(card_score, cpu_score + ".asnorm", eval_emb,
                              os.path.join(emb_dir, f"{cohort_set}_spk_mean.npz"),
                              top_n=voxceleb_v2.parse_args([]).asnorm_top_n,
                              mean_vec_path=mean_vec, device="cpu")
        # the bars of phase_score, plus one rounding step of the files' {:.5f}
        score_err = max(score_err, float(np.abs(_score_column(card_score, 2)
                                                - _score_column(cpu_score, 2)).max()))
        norm_err = max(norm_err, float(np.abs(_score_column(card_score + ".asnorm", 2)
                                              - _score_column(cpu_norm, 2)).max()))
    out["against_cpu"] = {"embeddings": len(cos), "min_cosine": min(cos),
                          "cosine_bar": COS_MIN["f32"], "score_max_abs_err": score_err,
                          "asnorm_max_abs_err": norm_err, "score_bar": 1e-5 + 1.1e-5,
                          "asnorm_bar": 2e-4 + 1.1e-5, "trial_files": len(trials)}
    log(f"[{tag}] against the CPU: {len(cos)} stage-4 embeddings, min cosine {min(cos):.7f} "
        f"(bar {COS_MIN['f32']}); stage-5 scores max|d| {score_err:.2e} (bar 2.1e-5), stage-6 "
        f"AS-Norm max|d| {norm_err:.2e} (bar 2.11e-4), {len(trials)} trial file(s)")
    bad = []
    if len(cos) != 16 or min(cos) < COS_MIN["f32"]:
        bad.append(f"stage-4 embeddings against the CPU: {len(cos)}, min cosine {min(cos)}")
    if not score_err <= 1e-5 + 1.1e-5:
        bad.append(f"stage-5 scores against the CPU: max|d| {score_err}")
    if not norm_err <= 2e-4 + 1.1e-5:
        bad.append(f"stage-6 AS-Norm against the CPU: max|d| {norm_err}")
    return bad


def profile_recipe_steps(config, data, exp, tag):
    """3 float32 train steps of a recipe config on one of its shard batches,
    from the run's averaged weights, under torch.profiler (after 2 warm
    steps): device time, idle share and PROFILE_GROUPS' shares."""
    from torch.profiler import ProfilerActivity, profile

    from wespeaker_hubert_tpu_torch.bin.train import _feature_cfg, _to_device, read_spk2id
    from wespeaker_hubert_tpu_torch.data.aug_store import AugStore
    from wespeaker_hubert_tpu_torch.data.dataset import TrainPipeline, TrainPipelineConfig
    from wespeaker_hubert_tpu_torch.models.speaker_net import build_speaker_net, load_speaker_state
    from wespeaker_hubert_tpu_torch.train.executor import make_train_step
    from wespeaker_hubert_tpu_torch.train.schedulers import MarginSchedule, get_lr_schedule
    from wespeaker_hubert_tpu_torch.train.state import TrainState

    da = config["dataset_args"]
    batch_size = config["dataloader_args"]["batch_size"]
    spk2id = read_spk2id(os.path.join(data, "vox2_dev", "utt2spk"))
    pipe = TrainPipeline(
        Path(data, "vox2_dev", "shard.list").read_text().split(), spk2id,
        TrainPipelineConfig(data_type="shard", num_frms=da["num_frms"], batch_size=batch_size,
                            shuffle_size=da["shuffle_args"]["shuffle_size"], seed=7),
        AugStore(root=os.path.join(data, "rirs_aug_store")),
        AugStore(root=os.path.join(data, "musan_aug_store")))
    batch = _to_device(next(iter(pipe)), torch.device(DEVICE))
    net = build_speaker_net(config, 3 * len(spk2id))
    load_speaker_state(net, torch.load(os.path.join(exp, "avg_model.pt"), weights_only=True))
    net.to(DEVICE)
    lr = get_lr_schedule("ExponentialDecrease", num_epochs=2, epoch_iter=12, scale_ratio=2.0,
                         **config["scheduler_args"])
    state = TrainState(net, config_optimizer(net, config), lr)
    step = make_train_step(net, lr, MarginSchedule(12, 0, 1, 0.0, 0.2),
                           feature_cfg=_feature_cfg(da), chunk_samples=pipe.chunk_samples,
                           seed=43)
    for _ in range(2):
        step(state, batch)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step(state, batch)
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    prof_out = grouped_profile(prof, wall_us, PROFILE_GROUPS)
    prof_out["window"] = (f"3 float32 train steps, batch {batch_size} x "
                          f"{da['num_frms'] / 100:g} s, {config['model']}, "
                          f"{3 * len(spk2id)} classes, {config.get('optimizer', 'SGD')}")
    if prof_out["device_ms"]:
        log(f"[{tag}] 3 f32 steps: device {prof_out['device_ms']:.2f} ms over "
            f"{prof_out['wall_ms']:.2f} ms wall (idle share {prof_out['device_idle_share']:.4f});"
            " shares " + ", ".join(f"{g} {v:.3f}" for g, v in prof_out["shares"].items()))
        for g in ("conv", "conv (FFT algorithm)", "GEMM", "elementwise"):
            log(f"[{tag}]   {g}: " + "; ".join(prof_out["group_top"][g][:3]))
    else:
        log(f"[{tag}] torch.profiler reported no device time: not measured")
    del net, state, step
    empty_cache()
    return prof_out


def _stage_rates(records):
    """bin/extract's "extracted ..." log lines among `records`, and the audio
    seconds they report over their loop seconds."""
    lines = [r for r in records if r.startswith("extracted")]
    pairs = [(float(r.split("; ")[1].split(" audio-s")[0]), float(r.split(" in ")[1].split("s (")[0]))
             for r in lines]
    return lines, sum(a for a, _ in pairs) / max(1e-9, sum(t for _, t in pairs))


def phase_recipe(report, root):
    """recipes.voxceleb_v2 stages 1-7 on the card with the flagship config
    as the port's reader parses it, overriding only the paths and the length
    of the run.  Stages 1-3, then 4-7, each driven with K1's count set to 0
    just before and read just after: the dithered train step takes the
    plain fbank, stage 4's extraction goes through K1, and a spy keeps
    every input it gave K1 for the check after the run.  Then 3 profiled
    train steps at the same config.  Returns stage 4's K1 launches."""
    import logging

    from wespeaker_hubert_tpu_torch.bin import train as bin_train
    from wespeaker_hubert_tpu_torch.ops import fbank_kernel
    from wespeaker_hubert_tpu_torch.recipes import voxceleb_v2
    from wespeaker_hubert_tpu_torch.utils.config import load_config

    data, exp = os.path.join(root, "data"), os.path.join(root, "exp")
    t0 = time.perf_counter()
    seconds = write_recipe_data(data)
    out = report["recipe"] = {"data_write_s": time.perf_counter() - t0,
                              "audio_s": seconds}
    trials = os.path.join(data, "vox1", "vox1_O_cleaned.kaldi")
    # the overrides: paths and the length of the run, nothing else
    overrides = [f"exp_dir={exp}", f"train_data={data}/vox2_dev/shard.list",
                 f"train_label={data}/vox2_dev/utt2spk",
                 f"dataset_args.reverb_data={data}/rirs_aug_store",
                 f"dataset_args.noise_data={data}/musan_aug_store",
                 "num_epochs=2", "epoch_iter=12", "save_epoch_interval=1", "num_avg=2"]
    out["overrides"] = overrides
    common = ["--config", str(RECIPE_CONFIG), "--data_root", data, "--trials", trials,
              "--device", DEVICE] + overrides
    timer = _StepTimer()
    make = bin_train.make_train_step
    bin_train.make_train_step = timer(make)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()  # stages 1-3's peak alone
    fbank_kernel.LAUNCHES = 0
    try:
        done = voxceleb_v2.main(["--stage", "1", "--stop_stage", "3"] + common)
    finally:
        bin_train.make_train_step = make
    k1_train = fbank_kernel.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda" else "not measured"
    rates = []
    handler = logging.Handler()
    handler.emit = lambda rec: rates.append(rec.getMessage())
    logging.getLogger("extract").addHandler(handler)
    fbank_kernel.LAUNCHES = 0
    try:
        with _K1Spy(fbank_kernel) as k1_spy:
            done.update(voxceleb_v2.main(["--stage", "4", "--stop_stage", "7"] + common))
    finally:
        logging.getLogger("extract").removeHandler(handler)
    k1_extract = fbank_kernel.LAUNCHES
    # the CPU's checks in a thread, beside K1's on the card
    with ThreadPoolExecutor(1) as pool:
        cpu_run = pool.submit(recipe_against_cpu, data, exp, out)
        # K1 on every input stage 4 gave it, against its plain version (the card only)
        k1_rows, k1_matched = k1_on_eval_batches(
            [os.path.join(data, d, "raw.list") for d in ("vox1", "vox2_dev")],
            k1_spy.inputs) if DEVICE == "cuda" else ([], False)
        cpu_bad = cpu_run.result()
    n_caught = len(k1_spy.inputs)
    del k1_spy
    out["k1_stage4_checks"] = k1_rows
    log(f"[recipe] K1 on all {n_caught} stage-4 inputs against its plain version (rtol 1e-4, "
        f"atol 2e-3; against float64 where the plain version misses it by more; the inputs "
        f"{'match' if k1_matched else 'DO NOT match'} EvalPipeline's batches): " + "; ".join(
            f"{tuple(r['shape'])} x{r['batches']}: {r['off_bar']} elements past the bar, the plain "
            f"version past it from float64 at {r['plain_off_float64']}; valid "
            f"frames max|d| {r['valid']['max_abs_err']:.3e} (float64: kernel "
            f"{r['valid']['kernel_vs_float64']:.3e}, plain {r['valid']['plain_vs_float64']:.3e}), "
            f"padded {r['padded']['max_abs_err']:.3e}" for r in k1_rows))
    calls = timer.calls
    per_step_ms = [1e3 * s / n for n, s in calls]
    # all the work over all the time of every call after the first
    step_ms = 1e3 * sum(s for _, s in calls[1:]) / max(1, sum(n for n, _ in calls[1:]))
    config = load_config(str(RECIPE_CONFIG))
    batch_size = config["dataloader_args"]["batch_size"]
    extract_lines, extract_rate = _stage_rates(rates)
    out.update({
        "stage_s": {s: d["s"] for s, d in done.items()},
        "lines": {s: d["lines"] for s, d in done.items() if d["lines"]},
        "train_calls": [{"steps": n, "s": s} for n, s in calls],
        "step_ms_per_call": per_step_ms,
        "step_ms_after_first": step_ms,
        "train_audio_s_per_s": batch_size * 2.0 / (step_ms / 1e3),
        "peak_mem_gb_stage_1_3": peak_gb,
        "k1_launches_stage_1_3": k1_train, "k1_launches_stage_4_7": k1_extract,
        "extract_log": extract_lines,
        "extract_audio_s_per_s": extract_rate,
        "extract_stage4_audio_s_per_s": (seconds["vox1"] + seconds["vox2_dev"]) / done[4]["s"],
    })
    log(f"[recipe] data: {RECIPE_TRAIN_SPEAKERS * RECIPE_PER_SPEAKER} training utterances "
        f"({seconds['vox2_dev']:.0f} s) over {RECIPE_TRAIN_SPEAKERS} of {RECIPE_SPEAKERS} "
        f"speakers in tar shards, 64 eval ({seconds['vox1']:.0f} s), "
        f"written in {out['data_write_s']:.1f} s; overrides: " + " ".join(
            o.split("=")[0] for o in overrides))
    log("[recipe] stage seconds: " + ", ".join(f"{s} {d['s']:.1f}" for s, d in done.items()))
    log(f"[recipe] stage 3: {len(calls)} step calls (steps per call "
        f"{[n for n, _ in calls]}), per-step ms " + ", ".join(f"{x:.1f}" for x in per_step_ms)
        + f"; after the first call {step_ms:.2f} ms per step (their seconds over their steps) = "
        f"{out['train_audio_s_per_s']:.0f} audio-s/s ({batch_size} x 2 s); peak memory "
        + (f"{peak_gb:.2f} GB" if DEVICE == "cuda" else "not measured") + f"; K1 launches {k1_train}")
    log(f"[recipe] stage 4: " + " | ".join(extract_lines) + f"; loop rate "
        f"{out['extract_audio_s_per_s']:.0f} audio-s/s, stage wall rate "
        f"{out['extract_stage4_audio_s_per_s']:.0f} audio-s/s (averaging and model loads "
        f"included); K1 launches {k1_extract}")
    for s in (5, 6, 7):
        log(f"[recipe] stage {s}: " + "; ".join(done[s]["lines"]))

    # a few profiled steps of the same config (the recipe's averaged weights)
    out["profile"] = profile_recipe_steps(config, data, exp, "recipe profile")
    check(sorted(done) == list(range(1, 8)), f"recipe: stages {sorted(done)}")
    check([n for n, _ in calls] == [8, 1, 1, 1, 1] * 2,
          f"recipe: step calls {[n for n, _ in calls]}, want an 8-step call and, where the "
          "12 batches of the epoch's data run out, a 4-step tail")
    check(k1_train == 0, f"recipe: the dithered train step launched K1 {k1_train} times")
    check(k1_extract > 0, "recipe: stage 4 launched no K1")
    check(k1_matched and n_caught == k1_extract, "recipe: the spy's stage-4 inputs do not "
          f"match EvalPipeline's batches ({n_caught} caught, {k1_extract} launches)")
    check(all(r["off_bar"] == 0 and r["finite"] for r in k1_rows),
          "recipe: K1 disagrees with its plain version on a stage-4 input")
    check(not cpu_bad, "recipe: " + "; ".join(cpu_bad))
    for s in (5, 6, 7):
        check(len(done[s]["lines"]) == 1 and " EER " in done[s]["lines"][0],
              f"recipe: stage {s} printed {done[s]['lines']}")
    return k1_extract


ECAPA_CHECK_SEED = 20251020
ECAPA_CHECK_BATCH = 32


ECAPA_CHECK_CHUNK = 31920  # samples of 198 fbank frames: a 2 s chunk


def _ecapa_check_batch(seed, n=None):
    """A packed, speed-perturbed batch of n (ECAPA_CHECK_BATCH unless given)
    x 2 s (198 frames) for a recipe model: wav (n, speed_input_len), labels
    over 17,982 classes, an eighth of the rows reverberated and an eighth
    noised (host tensors)."""
    from wespeaker_hubert_tpu_torch.ops.augment import speed_input_len

    rng = np.random.default_rng(seed)
    n, chunk = n or ECAPA_CHECK_BATCH, ECAPA_CHECK_CHUNK
    rows_aug = max(1, n // 8)
    w = speed_input_len(chunk)
    wav = np.stack([speechlike(rng, w / SR + 0.001, rng.uniform(90, 280))[:w] for _ in range(n)])
    rir = rng.standard_normal((rows_aug, 8000)) * np.exp(-np.arange(8000) / 800) * 0.3
    rir[:, 0] = 1.0
    batch = {"wav": wav, "label": rng.integers(0, 3 * RECIPE_SPEAKERS, n).astype(np.int32),
             "speed_idx": rng.integers(0, 3, n).astype(np.int32),
             "rir": rir.astype(np.float32),
             "noise": (0.1 * rng.standard_normal((rows_aug, chunk))).astype(np.float32),
             "snr": rng.uniform(0, 15, rows_aug).astype(np.float32)}
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def config_optimizer(net, config):
    """The config's optimizer (SGD, Adam or AdamW with its optimizer_args)
    over `net`, as bin/train builds it."""
    from wespeaker_hubert_tpu_torch.train.state import make_optimizer

    args = config.get("optimizer_args", {})
    return make_optimizer(net, config.get("optimizer", "SGD"),
                          momentum=args.get("momentum", 0.9), nesterov=args.get("nesterov", True),
                          weight_decay=args.get("weight_decay", 1e-4))


def _ecapa_net(device, num_steps=1, config_path=None, seed=ECAPA_CHECK_SEED):
    """A recipe config's model (the flagship ECAPA_TDNN_GLOB_c512 unless
    `config_path` names another) + ArcMargin over 17,982 classes with seeded
    weights and the config's optimizer, float32, dither 0 and SpecAug off,
    on `device`."""
    from wespeaker_hubert_tpu_torch.bin.train import _feature_cfg
    from wespeaker_hubert_tpu_torch.models.speaker_net import build_speaker_net
    from wespeaker_hubert_tpu_torch.train.executor import make_train_step
    from wespeaker_hubert_tpu_torch.train.schedulers import ExponentialDecrease, MarginSchedule
    from wespeaker_hubert_tpu_torch.train.state import TrainState
    from wespeaker_hubert_tpu_torch.utils.config import load_config

    config = load_config(str(config_path or RECIPE_CONFIG))
    config["dataset_args"]["fbank_args"]["dither"] = 0.0
    config["dataset_args"]["spec_aug"] = False
    torch.manual_seed(0)
    net = build_speaker_net(config, 3 * RECIPE_SPEAKERS)
    # the whole SpeakerNet's names (backbone. and projection.), strictly
    net.load_state_dict(seeded_state_dict(net, seed))
    net.to(device)
    lr = ExponentialDecrease(num_epochs=2, epoch_iter=4, initial_lr=0.1, final_lr=5e-5,
                             warm_up_epoch=1)
    state = TrainState(net, config_optimizer(net, config), lr)
    step = make_train_step(net, lr, MarginSchedule(4, 0, 1, 0.0, 0.2),
                           feature_cfg=_feature_cfg(config["dataset_args"]),
                           chunk_samples=ECAPA_CHECK_CHUNK, seed=43, num_steps=num_steps)
    return net, state, step


def phase_ecapa_step_check(report):
    """(a) One float32 train step of the flagship ECAPA at full width (17,982
    classes, batch 32 x 2 s, speed perturbation, 4 reverb and 4 noise rows,
    dither 0, SpecAug off) on the card against the same step on the CPU:
    loss within 1e-5 relative, every tensor's update by _update_agreement
    against a control (the card on the wav times 1 + 2^-20).  (b) A 2-step
    call against two single steps on the card, the control a second run of
    the single steps."""
    batches = [_ecapa_check_batch(ECAPA_CHECK_SEED + i) for i in range(2)]
    out = report["ecapa_step_check"] = {}
    res = {}
    for tag, dev, scale in (("card", DEVICE, False), ("cpu", "cpu", False),
                            ("control", DEVICE, True)):
        net, state, step = _ecapa_net(dev)
        b = {k: v.to(dev) for k, v in batches[0].items()}
        t0 = time.perf_counter()
        res[tag] = _one_step(net, state, step, _perturbed(b) if scale else b, prefix="")
        res[tag + "_s"] = time.perf_counter() - t0
        del net, state, step
    empty_cache()
    loss_rel = abs(res["card"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    pair = _diff_table(res["card"][1], res["cpu"][1])
    control = _diff_table(res["control"][1], res["card"][1])
    failing, how = _update_agreement(pair, control, 0.9999, res["cpu"][2])
    worst = sorted(pair.items(), key=lambda kv: kv[1][0])[:4]
    out["card_vs_cpu"] = {
        "loss": [res["card"][0], res["cpu"][0]], "loss_rel": loss_rel,
        "updates_rel_l2": _rel_l2(res["card"][1], res["cpu"][1]),
        "control_updates_rel_l2": _rel_l2(res["control"][1], res["card"][1]),
        "n_tensors": len(pair), "passed_by": how, "worst": worst, "failing": failing,
        "cpu_step_s": res["cpu_s"], "card_step_s_first": res["card_s"]}
    r = out["card_vs_cpu"]
    log(f"[ecapa step] f32 step at full width ({3 * RECIPE_SPEAKERS} classes, batch "
        f"{ECAPA_CHECK_BATCH} x 2 s), card vs CPU: "
        f"loss {res['card'][0]:.6f} vs {res['cpu'][0]:.6f} (rel {loss_rel:.2e}, bar 1e-5); "
        f"updates relative L2 {r['updates_rel_l2']:.2e} (control {r['control_updates_rel_l2']:.2e});"
        f" of {len(pair)} tensors {how['cosine']} at cosine >= 0.9999, {how['within_control']} "
        f"within the control, {how['noise_floor']} at the noise floor, {len(failing)} failing; "
        f"least cosines {worst}; CPU step {res['cpu_s']:.1f} s")
    del res
    # (b) two single steps (twice) against one 2-step call, on the card
    runs = {}
    for tag, n in (("single", 1), ("single_again", 1), ("two_step", 2)):
        net, state, step = _ecapa_net(DEVICE, num_steps=n)
        before = {k: v.detach().float().cpu().clone() for k, v in net.state_dict().items()
                  if v.is_floating_point()}
        dev = [{k: v.to(DEVICE) for k, v in b.items()} for b in batches]
        if n == 1:
            losses = [float(step(state, b)["loss"]) for b in dev]
        else:
            losses = step(state, {k: torch.stack([b[k] for b in dev]) for k in dev[0]})
            losses = [float(x) for x in losses["loss"]]
        upd = {k: net.state_dict()[k].detach().float().cpu() - v for k, v in before.items()}
        runs[tag] = (losses, upd, {k: float(v.abs().max()) for k, v in before.items()},
                     state.step)
        del net, state, step
    empty_cache()
    pair = _diff_table(runs["two_step"][1], runs["single"][1])
    control = _diff_table(runs["single_again"][1], runs["single"][1])
    failing_b, how_b = _update_agreement(pair, control, 0.99999, runs["single"][2])
    loss_diff = max(abs(a - b) for a, b in zip(runs["two_step"][0], runs["single"][0]))
    out["two_step_vs_singles"] = {
        "losses": {k: v[0] for k, v in runs.items()}, "steps": {k: v[3] for k, v in runs.items()},
        "loss_max_abs_diff": loss_diff, "updates_rel_l2": _rel_l2(runs["two_step"][1],
                                                                 runs["single"][1]),
        "control_updates_rel_l2": _rel_l2(runs["single_again"][1], runs["single"][1]),
        "passed_by": how_b, "failing": failing_b}
    r = out["two_step_vs_singles"]
    log(f"[ecapa step] a 2-step call vs two single steps on the card: losses "
        f"{runs['two_step'][0]} vs {runs['single'][0]}; updates relative L2 "
        f"{r['updates_rel_l2']:.2e} (two single-step runs: {r['control_updates_rel_l2']:.2e}); "
        f"{len(failing_b)} tensors failing")
    check(loss_rel <= 1e-5 and not failing, "ecapa step: card step vs CPU step")
    check(all(v[3] == 2 for v in runs.values()), "ecapa step: each run takes 2 steps")
    check(loss_diff <= 1e-6 * abs(runs["single"][0][0]) and not failing_b,
          "ecapa step: the 2-step call vs two single steps")


# ------------------------------------------------ the ResNet34 recipe
RESNET_CONFIG = Path(__file__).resolve().parent / "examples/voxceleb/v2/conf/resnet34.yaml"
RESNET_LM_CONFIG = Path(__file__).resolve().parent / "examples/voxceleb/v2/conf/resnet_lm.yaml"
RESNET_CHECK_SEED = 20251021
# the recipes' cut: 2 epochs of 8 steps, and 4 lm steps; ResNet34 and CAM++,
# the earlier paths, run fewer for the script's time (PERF.md section 4
# lists the earlier, longer cuts)
RECIPE_EPOCH_STEPS, RECIPE_LM_STEPS = 8, 4
RESNET_STEPS, CAMPPLUS_STEPS = (2, 2), (8, 2)  # (steps an epoch, lm steps)
RESNET_CHECK_BATCH = 16
# the exported program against the eager model: (B, T) feature shapes
PROGRAM_SHAPES = ((16, 200), (3, 517))
# Speaker on the exported directory against stage 4: an utterance's ResNet
# embedding depends on the padding past it (its receptive field, some 240
# frames, reaches beyond the utterance), and bin/extract pads to its length
# bucket where Speaker pads to a power of two of samples
SPEAKER_COS_MIN = 0.999


def phase_resnet_recipe(report, root):
    """recipes.voxceleb_v2 stages 1-9 on the card with resnet34.yaml and
    resnet_lm.yaml as the port's reader parses them (ResNet34, 32 channels,
    80 mels, 256-d, TSTP, ArcMargin over 3 x 5,994 classes, float32; the lm
    fine-tune at batch 64 x 600 frames, margin 0.5), by recipe_1_to_9.
    Returns the K1 launches of the two stage 4s."""
    epoch, lm = RESNET_STEPS
    return recipe_1_to_9(report, root, "resnet", RESNET_CONFIG, RESNET_LM_CONFIG,
                         ([1] * 2 * epoch, [1] * lm), epoch, lm)


def program_cosines(dirs, device, shapes):
    """{"<dir> (B, T)": min cosine} of each exported directory's stage-8
    program (bin/export_model.load_program) against its eager model on
    `device`, float32 with TF32 off, at the (B, T) `shapes`.  Runs in a
    worker process (defer_check)."""
    from wespeaker_hubert_tpu_torch.bin.export_model import load_program
    from wespeaker_hubert_tpu_torch.models.speaker_net import build_speaker_net, load_speaker_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for exported, feat_dim in dirs:
        program = load_program(os.path.join(exported, "model.pt2"), device=device)
        net = build_speaker_net(json.loads(Path(exported, "config.json").read_text()))
        load_speaker_state(net, torch.load(os.path.join(exported, "avg_model.pt"),
                                           weights_only=True))
        net.to(device).eval()
        for b, t in shapes:
            feats = torch.from_numpy(np.random.default_rng(b * t).standard_normal(
                (b, t, feat_dim)).astype(np.float32)).to(device)
            with torch.inference_mode():
                got, want = program(feats), net.embed(feats)
            out[f"{Path(exported).parent.name} ({b}, {t})"] = float(
                torch.nn.functional.cosine_similarity(got.float(), want, dim=1).min())
        del program, net
    return out


DEFERRED = []  # (phase, report entry, key, future) of the checks in worker processes
_WORKERS = []


def defer_check(phase, entry, key, fn, *args):
    """Run fn(*args) in a spawned worker process beside the rest of the
    script; main() waits for it, stores its result under entry[key] and
    fails `phase` there if the bar is missed."""
    if not _WORKERS:
        import multiprocessing

        from concurrent.futures import ProcessPoolExecutor

        _WORKERS.append(ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")))
    DEFERRED.append((phase, entry, key, _WORKERS[0].submit(fn, *args)))


def collect_deferred(failures):
    """Wait for the deferred checks; a stage-8 program under COS_MIN's
    float32 bar, or a worker's error, is its phase's failure."""
    try:
        for phase, entry, key, future in DEFERRED:
            try:
                entry[key] = got = future.result(timeout=900)
            except Exception as e:  # noqa: BLE001 — reported as the phase's failure
                traceback.print_exc()
                failures.append(f"{phase} (deferred {key}): {type(e).__name__}: {e}")
                continue
            log(f"[{phase}] stage-8 torch.export program on the card against the eager model "
                "(a worker process): min cosine "
                + ", ".join(f"{k} {v:.7f}" for k, v in got.items()) + f" (bar {COS_MIN['f32']})")
            if min(got.values()) < COS_MIN["f32"]:
                failures.append(f"{phase}: program vs eager {got}")
    finally:
        for pool in _WORKERS:
            pool.shutdown(wait=True, cancel_futures=True)
        _WORKERS.clear()


def recipe_1_to_9(report, root, fam, config_path, lm_config_path, want_calls,
                  epoch_steps=RECIPE_EPOCH_STEPS, lm_steps=RECIPE_LM_STEPS):
    """recipes.voxceleb_v2 stages 1-9 on the card with a recipe config and
    its lm config as the port's reader parses them, overriding only paths
    and the run's length (base: 2 epochs of `epoch_steps` steps of the
    config's batch, 2 checkpoints averaged; lm: 1 epoch of `lm_steps` steps,
    num_avg 1), on write_recipe_data's 1,536 utterances in 2 shards;
    without an lm config (`lm_config_path` None) stages 1-8.  Three calls,
    each with K1's count set to 0 just before and read just after: stages
    1-3, stages 4-8, stage 9 (stages 3-8 of the lm config).  Then the
    checks: the train step calls `want_calls` (base, lm), K1 on every
    stage-4 input at the config's mels (the base's, and the lm run's equal
    to them), 16 stage-4 embeddings and the score files against the CPU,
    the stage-8 program (torch.export.load) against the eager model on the
    card (in a worker process, collected by main()), the exported directory
    through cli.speaker.Speaker against stage 4, and 3 profiled base steps.  `fam` names the report's key and the
    log's tag.  Returns the K1 launches of the stage 4s (the lm run's None
    without one)."""
    import logging

    from wespeaker_hubert_tpu_torch.bin import train as bin_train
    from wespeaker_hubert_tpu_torch.cli.speaker import Speaker
    from wespeaker_hubert_tpu_torch.ops import fbank_kernel
    from wespeaker_hubert_tpu_torch.recipes import voxceleb_v2
    from wespeaker_hubert_tpu_torch.utils.embeddings import embeddings_dict

    data = os.path.join(root, "data")
    exp, exp_lm = os.path.join(root, f"exp_{fam}"), os.path.join(root, f"exp_{fam}_lm")
    t0 = time.perf_counter()
    if os.path.exists(os.path.join(data, "vox1", "vox1_O_cleaned.kaldi")):
        seconds = report["recipe"]["audio_s"]  # phase_recipe's data, in the same root
    else:
        seconds = write_recipe_data(data)
    out = report[f"{fam}_recipe"] = {"data_write_s": time.perf_counter() - t0,
                                     "audio_s": seconds}
    trials = os.path.join(data, "vox1", "vox1_O_cleaned.kaldi")
    paths = [f"train_data={data}/vox2_dev/shard.list", f"train_label={data}/vox2_dev/utt2spk",
             f"dataset_args.reverb_data={data}/rirs_aug_store",
             f"dataset_args.noise_data={data}/musan_aug_store"]
    has_lm = lm_config_path is not None
    # the overrides: paths and the length of the run, nothing else
    overrides = ([f"exp_dir={exp}"] + paths
                 + ["num_epochs=2", f"epoch_iter={epoch_steps}", "save_epoch_interval=1",
                    "num_avg=2"])
    if has_lm:
        overrides += ([f"lm.exp_dir={exp_lm}"] + ["lm." + o for o in paths]
                      + ["lm.num_epochs=1", f"lm.epoch_iter={lm_steps}",
                         "lm.save_epoch_interval=1", "lm.num_avg=1"])
    out["overrides"] = overrides
    common = (["--config", str(config_path)]
              + (["--lm_config", str(lm_config_path)] if has_lm else [])
              + ["--data_root", data, "--trials", trials, "--device", DEVICE] + overrides)
    records = []
    handler = logging.Handler()
    handler.emit = lambda rec: records.append(rec.getMessage())
    for name in ("extract", "train"):
        logging.getLogger(name).addHandler(handler)
    make = bin_train.make_train_step
    runs = {}
    try:
        for tag, stages in (("base", (1, 3)), ("export", (4, 8)), ("lm", (9, 9)))[:2 + has_lm]:
            timer = _StepTimer()
            bin_train.make_train_step = timer(make)
            if DEVICE == "cuda":
                torch.cuda.reset_peak_memory_stats()
            n_records = len(records)
            fbank_kernel.LAUNCHES = 0
            with _K1Spy(fbank_kernel) as spy:
                done = voxceleb_v2.main(["--stage", str(stages[0]), "--stop_stage",
                                         str(stages[1])] + common)
            runs[tag] = {"done": done, "k1": fbank_kernel.LAUNCHES, "k1_inputs": spy.inputs,
                         "timer": timer, "records": records[n_records:],
                         "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                                     if DEVICE == "cuda" else "not measured")}
    finally:
        bin_train.make_train_step = make
        for name in ("extract", "train"):
            logging.getLogger(name).removeHandler(handler)
    done = {k: v for r in runs.values() for k, v in r["done"].items()}
    lm_done = done[9]["stages"] if has_lm else {}
    base_cfg, lm_cfg = voxceleb_v2.load_configs(voxceleb_v2.parse_args(common))
    mels = base_cfg["dataset_args"]["fbank_args"]["num_mel_bins"]
    tags = ("base", "lm") if has_lm else ("base",)

    def steps(tag, cfg):
        calls = runs[tag]["timer"].calls
        ms = 1e3 * sum(t for _, t in calls[1:]) / max(1, sum(n for n, _ in calls[1:]))
        chunk_s = cfg["dataset_args"]["num_frms"] / 100
        batch = cfg["dataloader_args"]["batch_size"]
        return {"calls": [n for n, _ in calls], "step_ms_per_call": [1e3 * t / n for n, t in calls],
                "step_ms_after_first": ms, "audio_s_per_s": batch * chunk_s / (ms / 1e3),
                "batch": batch, "chunk_s": chunk_s, "margins": runs[tag]["timer"].margins,
                "peak_mem_gb": runs[tag]["peak_gb"]}

    out["train"] = {tag: steps(tag, cfg) for tag, cfg in (("base", base_cfg), ("lm", lm_cfg))
                    if tag in tags}
    extract_base, rate_base = _stage_rates(runs["export"]["records"])
    extract_lm, rate_lm = _stage_rates(runs["lm"]["records"]) if has_lm else ([], None)
    init_lines = ([r for r in runs["lm"]["records"] if r.startswith("model_init")]
                  if has_lm else [])
    audio = seconds["vox1"] + seconds["vox2_dev"]
    out.update({
        "stage_s": {s: d["s"] for s, d in done.items()},
        "lm_stage_s": {s: d["s"] for s, d in lm_done.items()},
        "lines": {s: d["lines"] for s, d in done.items() if d.get("lines")},
        "lm_lines": {s: d["lines"] for s, d in lm_done.items() if d["lines"]},
        "k1_launches": {t: runs[t]["k1"] for t in runs},
        "mels": mels,
        "extract_log": {"base": extract_base, "lm": extract_lm},
        "extract_audio_s_per_s": {"base": rate_base, "lm": rate_lm},
        "extract_stage4_audio_s_per_s": {"base": audio / done[4]["s"],
                                         "lm": audio / lm_done[4]["s"] if has_lm else None},
        "lm_model_init": init_lines})
    for tag in tags:
        r = out["train"][tag]
        log(f"[{fam} {tag}] stage 3: {sum(r['calls'])} steps of {r['batch']} x {r['chunk_s']:g} "
            f"s in calls of {sorted(set(r['calls']), reverse=True)},"
            f" per-step ms " + ", ".join(f"{x:.1f}" for x in r["step_ms_per_call"])
            + f"; after the first {r['step_ms_after_first']:.2f} ms per step = "
            f"{r['audio_s_per_s']:.0f} audio-s/s; peak memory "
            + (f"{r['peak_mem_gb']:.2f} GB" if DEVICE == "cuda" else "not measured")
            + f"; margins {sorted(set(r['margins']))}")
    log(f"[{fam}] stage seconds: " + ", ".join(f"{s} {d['s']:.1f}" for s, d in done.items())
        + "; stage 9's: " + ", ".join(f"{s} {d['s']:.1f}" for s, d in lm_done.items()))
    log(f"[{fam}] stage 4: base " + " | ".join(extract_base) + f"; lm " + " | ".join(extract_lm)
        + f"; loop rates {rate_base:.0f} / {rate_lm} audio-s/s, stage wall rates "
        f"{out['extract_stage4_audio_s_per_s']['base']:.0f} / "
        f"{out['extract_stage4_audio_s_per_s']['lm']}; K1 launches {out['k1_launches']} "
        f"({mels} mels)")
    for s in (5, 6, 7):
        log(f"[{fam}] stage {s}: base " + "; ".join(done[s]["lines"]) + " | lm "
            + "; ".join(lm_done.get(s, {"lines": []})["lines"]))
    log(f"[{fam}] stage 8: " + "; ".join(done[8]["lines"] + lm_done.get(8, {"lines": []})["lines"])
        + f"; the lm run's {init_lines}")

    # the CPU's checks in a thread, beside the card's untimed ones below
    pool = ThreadPoolExecutor(1)
    cpu_run = pool.submit(recipe_against_cpu, data, exp, out, config_path, fam)
    try:
        # K1 on every stage-4 input: the base's against its plain version, and
        # the lm run's stage 4 gave it the same batches
        base_in = runs["export"]["k1_inputs"]
        lm_in = runs["lm"]["k1_inputs"] if has_lm else base_in
        k1_rows, k1_matched = k1_on_eval_batches(
            [os.path.join(data, d, "raw.list") for d in ("vox1", "vox2_dev")],
            base_in, mels) if DEVICE == "cuda" else ([], False)
        lm_same = len(lm_in) == len(base_in) and all(torch.equal(a, b)
                                                     for a, b in zip(lm_in, base_in))
        out["k1_stage4_checks"] = k1_rows
        log(f"[{fam}] K1 on all {len(base_in)} stage-4 inputs against its plain version (bar as "
            f"[recipe]; inputs {'match' if k1_matched else 'DO NOT match'} EvalPipeline's batches; "
            f"the lm run's {len(lm_in)} inputs {'equal' if lm_same else 'DIFFER from'} them): "
            + "; ".join(f"{tuple(r['shape'])} x{r['batches']}: {r['off_bar']} past the bar, valid "
                        f"max|d| {r['valid']['max_abs_err']:.3e}" for r in k1_rows))
        n_caught = {"base": len(base_in), "lm": len(lm_in),
                    "stage 3": len(runs["base"]["k1_inputs"])}
        del base_in, lm_in, runs
        empty_cache()

        # the stage-8 programs against the eager model, on the card, in a
        # worker process beside the rest of the script (loading a program
        # takes the host tens of seconds for CAM++); main() collects them
        defer_check(f"{fam} recipe", out, "program_min_cosine", program_cosines,
                    [(os.path.join(d, "exported"), cfg["model_args"]["feat_dim"])
                     for d, cfg in ((exp, base_cfg), (exp_lm, lm_cfg))[:1 + has_lm]],
                    DEVICE, PROGRAM_SHAPES)

        # the exported directory through cli.speaker.Speaker against stage 4
        speaker = Speaker(os.path.join(exp, "exported"), device=DEVICE)
        card = embeddings_dict(os.path.join(exp, "embeddings", "vox1.npz"))
        wavs = [ln.split() for ln in Path(data, "vox1", "wav.scp").read_text().splitlines()[:16]]
        speaker_cos = [cosine(speaker.extract_embedding(w), card[k]) for k, w in wavs]
        del speaker
        empty_cache()
        out["speaker_vs_stage4"] = {"n": len(speaker_cos), "min_cosine": min(speaker_cos),
                                    "bar": SPEAKER_COS_MIN}
        log(f"[{fam}] exported directory through cli.speaker.Speaker against stage 4: "
            f"{len(speaker_cos)} utterances, min cosine {min(speaker_cos):.7f} "
            f"(bar {SPEAKER_COS_MIN})")
        cpu_bad = cpu_run.result()
    finally:
        pool.shutdown()
    out["profile"] = profile_recipe_steps(base_cfg, data, exp, f"{fam} profile")

    check(sorted(done) == list(range(1, 9 + has_lm))
          and sorted(lm_done) == (list(range(3, 9)) if has_lm else []),
          f"{fam}: stages {sorted(done)}, stage 9's {sorted(lm_done)}")
    calls = [out["train"][t]["calls"] for t in tags]
    check(calls == list(want_calls[:len(tags)]), f"{fam}: step calls {calls}")
    if has_lm:
        check(set(out["train"]["lm"]["margins"]) == {0.5},
              f"{fam}: the lm run's margins {out['train']['lm']['margins']}")
        check(init_lines == [f"model_init from {exp}/avg_model.pt (epoch 0, 0 missing, "
                             "0 unexpected)"], f"{fam}: the lm run's initialization {init_lines}")
    k1 = out["k1_launches"]
    check(k1["base"] == 0 and n_caught["stage 3"] == 0,
          f"{fam}: the dithered train step launched K1 {k1['base']} times")
    check(k1["export"] > 0 and k1_matched and n_caught["base"] == k1["export"],
          f"{fam}: stage 4's K1 inputs do not match EvalPipeline's batches ({n_caught}, {k1})")
    check(lm_same and k1.get("lm", k1["export"]) == k1["export"],
          f"{fam}: the lm run's K1 launches {k1.get('lm')} are not its stage 4's")
    check(all(r["off_bar"] == 0 and r["finite"] for r in k1_rows),
          f"{fam}: K1 disagrees with its plain version on a stage-4 input")
    check(not cpu_bad, f"{fam}: " + "; ".join(cpu_bad))
    check(min(speaker_cos) >= SPEAKER_COS_MIN, f"{fam}: Speaker vs stage 4 {speaker_cos}")
    for s in (5, 6, 7):
        for lines in (done[s]["lines"], lm_done[s]["lines"]) if has_lm else (done[s]["lines"],):
            check(len(lines) == 1 and " EER " in lines[0], f"{fam}: stage {s} printed {lines}")
    return k1["export"], k1.get("lm")


def phase_resnet_step_check(report):
    """One float32 train step of ResNet34 at full width (resnet34.yaml: 32
    channels, 80 mels, 256-d, TSTP, ArcMargin over 17,982 classes; batch 16
    x 2 s) on the card against the CPU, by step_vs_cpu."""
    report["resnet_step_check"] = step_vs_cpu(RESNET_CONFIG, RESNET_CHECK_SEED, "resnet step")


CARD_CPU_CONTROL = (("card", False), ("cpu", False), ("control", True))


def beside_cpu(run):
    """{kind: run(device, perturbed)} for the card, the CPU and the control
    (the card on the perturbed input), the CPU's run in a thread beside the
    card's two: its float32 step is host-bound, the card's are not."""
    devices = {"card": DEVICE, "cpu": "cpu", "control": DEVICE}
    with ThreadPoolExecutor(1) as pool:
        cpu = (pool.submit(run, "cpu", False) if DEVICE != "cpu" else None)
        out = {k: run(devices[k], p) for k, p in CARD_CPU_CONTROL if not (k == "cpu" and cpu)}
        if cpu is not None:
            out["cpu"] = cpu.result()
    return out


def step_vs_cpu(config_path, seed, tag):
    """One float32 train step of a recipe config's model at full width
    (ArcMargin over 17,982 classes; batch RESNET_CHECK_BATCH x 2 s, speed
    perturbation, reverb and noise rows, dither 0, SpecAug off) on the card
    against the same step on the CPU: loss within 1e-5 relative, every
    tensor's update by _update_agreement (cosine >= 0.9999, or within
    CONTROL_SLACK x the control's difference, the control the card on the
    wav times 1 + 2^-20, or at the noise floor).  The first BatchNorm
    reduces 16 x 200 x 80 positions per channel with flax's E[x^2] - E[x]^2
    in float32, whose rounding the card and the CPU sum in another order:
    the control measures how far the step moves under an input change of
    that size, and the bar is relative to it.  With Adam or AdamW the
    parameters' first moments ((1 - b1) g after one step) stand in for
    their updates.  Returns the report entry."""
    from wespeaker_hubert_tpu_torch.utils.config import load_config

    batch = _ecapa_check_batch(seed, RESNET_CHECK_BATCH)
    adam = load_config(str(config_path)).get("optimizer", "SGD").upper() in ("ADAM", "ADAMW")

    def run(dev, scale):
        net, state, step = _ecapa_net(dev, config_path=config_path, seed=seed)
        b = {k: v.to(dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        got = {"step": _one_step(net, state, step, _perturbed(b) if scale else b, prefix="")}
        got["s"] = time.perf_counter() - t0
        if adam:
            # Adam's first update is lr g / (|g| + eps), about lr sign(g): at
            # an element whose |g| lies within the rounding of the gradient
            # it flips with that rounding.  Its first moment, (1 - b1) g,
            # carries the gradient itself: compared in place of the update
            # (the update's relative L2 is reported as `adam_updates_rel_l2`)
            got["update"] = {k: v for k, v in got["step"][1].items()}
            moments = {name: state.optimizer.state[p]["exp_avg"].detach().float().cpu()
                       for name, p in net.named_parameters() if p in state.optimizer.state}
            got["step"][1].update(moments)
        del net, state, step
        return got

    res = {}
    for kind, got in beside_cpu(run).items():
        res[kind], res[kind + "_s"] = got["step"], got["s"]
        if adam:
            res[kind + "_update"] = got["update"]
    empty_cache()
    loss_rel = abs(res["card"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    pair = _diff_table(res["card"][1], res["cpu"][1])
    control = _diff_table(res["control"][1], res["card"][1])
    failing, how = _update_agreement(pair, control, 0.9999, res["cpu"][2])
    worst = sorted(pair.items(), key=lambda kv: kv[1][0])[:4]
    out = {
        "loss": [res["card"][0], res["cpu"][0]], "loss_rel": loss_rel,
        "updates_rel_l2": _rel_l2(res["card"][1], res["cpu"][1]),
        "control_updates_rel_l2": _rel_l2(res["control"][1], res["card"][1]),
        "n_tensors": len(pair), "passed_by": how, "worst": worst, "failing": failing,
        "cpu_step_s": res["cpu_s"], "card_step_s_first": res["card_s"],
        "compared": "first moments of the parameters (Adam)" if adam else "updates"}
    if adam:
        out["adam_updates_rel_l2"] = _rel_l2(res["card_update"], res["cpu_update"])
    name = Path(config_path).stem
    log(f"[{tag}] f32 {name} step at full width ({3 * RECIPE_SPEAKERS} classes, batch "
        f"{RESNET_CHECK_BATCH} x 2 s), card vs CPU: loss {res['card'][0]:.6f} vs "
        f"{res['cpu'][0]:.6f} (rel {loss_rel:.2e}, bar 1e-5); "
        + (f"Adam: the parameters' first moments compared (the updates' relative L2 "
           f"{out['adam_updates_rel_l2']:.2e}); " if adam else "")
        + f"updates relative L2 "
        f"{out['updates_rel_l2']:.2e} (control {out['control_updates_rel_l2']:.2e}); of "
        f"{len(pair)} tensors {how['cosine']} at cosine >= 0.9999, {how['within_control']} "
        f"within the control, {how['noise_floor']} at the noise floor, {len(failing)} failing; "
        f"least cosines {worst}; CPU step {res['cpu_s']:.1f} s")
    if failing:
        log(f"[{tag}] failing (pair (cosine, max|d|), control): "
            + "; ".join(f"{k} {v['pair']} {v['control']}" for k, v in list(failing.items())[:12]))
    check(loss_rel <= 1e-5 and not failing, f"{tag}: {name}'s card step vs CPU step")
    return out


# ----------------------------------------------- CAM++, Res2Net, ERes2Net
CAMPPLUS_CONFIG = Path(__file__).resolve().parent / "examples/voxceleb/v2/conf/campplus.yaml"
CAMPPLUS_LM_CONFIG = Path(__file__).resolve().parent / "examples/voxceleb/v2/conf/campplus_lm.yaml"
CONF = Path(__file__).resolve().parent / "examples/voxceleb/v2/conf"
# the step checks' configs; SimAM_ResNet34_ASP has none: it runs resnet34.yaml
# with only the model swapped
ZOO_CONFIGS = {name: CONF / f"{name}.yaml"
               for name in ("eres2net", "res2net", "repvgg", "xvec", "xi_vector",
                            "gemini_dfresnet_adam")}
ZOO_SWAPPED = {"simam_resnet34": (CONF / "resnet34.yaml", "SimAM_ResNet34_ASP")}
ZOO_CHECK_SEED = 20251023
ZOO_TIMED_BATCH, ZOO_TIMED_STEPS = None, 2  # batch None: the config's; 2 s chunks
REDIMNET_CONFIG = CONF / "redimnet.yaml"
GEMINI_CONFIG = CONF / "gemini_dfresnet_adam.yaml"
GEMINI_LM_CONFIG = CONF / "gemini_dfresnet_sgd_lm.yaml"


def phase_campplus_recipe(report, root):
    """recipes.voxceleb_v2 stages 1-9 on the card with campplus.yaml and
    campplus_lm.yaml as the port's reader parses them (CAMPPlus, 80 mels,
    512-d, TSTP, ArcMargin over 3 x 5,994 classes, batch 128 x 2 s,
    `loop_steps: 8`, float32; the lm fine-tune at batch 64 x 600 frames,
    margin 0.5), by recipe_1_to_9 on phase_recipe's data.  Returns the K1
    launches of the two stage 4s."""
    # loop_steps 8: an epoch of 8 steps is one 8-step call
    epoch, lm = CAMPPLUS_STEPS
    return recipe_1_to_9(report, root, "campplus", CAMPPLUS_CONFIG, CAMPPLUS_LM_CONFIG,
                         ([epoch] * 2, [1] * lm), epoch, lm)


def phase_redimnet_recipe(report, root):
    """recipes.voxceleb_v2 stages 1-8 on the card with redimnet.yaml as the
    port's reader parses it (ReDimNetB2, 72 mels, ASTP, 192-d, ArcMargin
    over 3 x 5,994 classes, batch 256 x 200 frames, `loop_steps: 8`,
    float32; no lm config, so no stage 9), by recipe_1_to_9 on
    phase_recipe's data (6 batches of 256 an epoch): K1 at 72 mels.
    Returns the K1 launches of stage 4."""
    # 1,536 utterances make 6 batches of 256 a pass, fewer than loop_steps:
    # each epoch's steps run as the single-step flushes of bin/train's tail
    return recipe_1_to_9(report, root, "redimnet", REDIMNET_CONFIG, None, ([1] * 12,))


def phase_gemini_recipe(report, root):
    """recipes.voxceleb_v2 stages 1-9 on the card with gemini_dfresnet_adam.yaml
    and gemini_dfresnet_sgd_lm.yaml as the port's reader parses them
    (Gemini_DF_ResNet114, 80 mels, 256-d, TSTP; AdamW, weight decay 0.05,
    batch 128 x 2 s, margin 0.2, `loop_steps: 8`; then SGD from the AdamW
    run's average at batch 32 x 600 frames, margin 0.5, `do_lm`), by
    recipe_1_to_9 on phase_recipe's data.  Returns the K1 launches of the
    two stage 4s."""
    return recipe_1_to_9(report, root, "gemini", GEMINI_CONFIG, GEMINI_LM_CONFIG,
                         ([8] * 2, [1] * RECIPE_LM_STEPS))


def _repvgg_deploy_check(config, wav, lengths, fcfg):
    """REPVGG_TINY_A0's deploy form (convert_repvgg_params of the seeded
    training form) against the training form, eval embeddings through K1
    on the card: min cosine and max |d| relative to max |embedding|."""
    from wespeaker_hubert_tpu_torch.models.repvgg import convert_repvgg_params
    from wespeaker_hubert_tpu_torch.models.speaker_net import build_speaker_net, load_speaker_state
    from wespeaker_hubert_tpu_torch.train.executor import make_eval_embed

    sd = seeded_state_dict(build_speaker_net(config).backbone, ZOO_CHECK_SEED)
    embs = {}
    for deploy in (False, True):
        cfg = json.loads(json.dumps(config))
        cfg["model_args"]["deploy"] = deploy
        net = build_speaker_net(cfg)
        missing, unexpected = load_speaker_state(net, convert_repvgg_params(sd) if deploy else sd)
        check(not missing and not unexpected,
              f"repvgg deploy={deploy}: {missing[:4]} missing, {unexpected[:4]} unexpected")
        net.to(DEVICE).eval()
        embs[deploy] = make_eval_embed(net, fcfg)({"wav": wav.to(DEVICE),
                                                   "length": lengths.to(DEVICE)}).cpu().numpy()
        del net
    cos = [cosine(a, b) for a, b in zip(embs[True], embs[False])]
    rel = float(np.abs(embs[True] - embs[False]).max() / np.abs(embs[False]).max())
    return {"min_cosine": min(cos), "max_rel_err": rel, "bar": COS_MIN["f32"]}


def phase_zoo_step_check(report):
    """Each of ZOO_CONFIGS' models (ERes2Net34_Base, Res2Net34_Base,
    REPVGG_TINY_A0, XVEC, XI_VEC_ECAPA_TDNN_c512, Gemini_DF_ResNet114 with
    its AdamW) and SimAM_ResNet34_ASP (resnet34.yaml with the model swapped;
    no config names it) at full width with seeded weights: (a) one float32
    train step with the config's optimizer on the card against the CPU
    (step_vs_cpu); (b) eval embeddings of a padded batch through
    make_eval_embed with K1 (3 x 3 s, lengths 3, 1.9 and 0.8 s), the card
    against the CPU's plain path, cosine >= 0.99999; (c) ZOO_TIMED_STEPS
    float32 steps at the config's batch x 2 s on the card, each timed with
    a device synchronize after a warm one, and the peak memory.  For
    RepVGG also its deploy form (convert_repvgg_params) against the
    training form in eval on the card, cosine >= 0.99999."""
    from wespeaker_hubert_tpu_torch.models.speaker_net import build_speaker_net, load_speaker_state
    from wespeaker_hubert_tpu_torch.ops import fbank_kernel
    from wespeaker_hubert_tpu_torch.ops.fbank import FbankConfig
    from wespeaker_hubert_tpu_torch.ops.pipeline import FeaturePipelineConfig
    from wespeaker_hubert_tpu_torch.train.executor import make_eval_embed
    from wespeaker_hubert_tpu_torch.utils.config import load_config

    out = report["zoo_step_check"] = {}
    rng = np.random.default_rng(ZOO_CHECK_SEED)
    wav = torch.from_numpy(np.stack([speechlike(rng, 3.0, f0) for f0 in (110, 180, 240)]))
    lengths = torch.tensor([48000, 30400, 12800], dtype=torch.int32)
    fcfg = FeaturePipelineConfig(fbank=FbankConfig(dither=0.0, spectrum_impl="kernel"),
                                 spec_aug=False)
    configs = dict(ZOO_CONFIGS)
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, (path, model) in ZOO_SWAPPED.items():
            config = load_config(str(path))
            config["model"] = model
            configs[name] = Path(tmp, f"{name}.json")
            configs[name].write_text(json.dumps(config))
        for name, path in configs.items():
            r = out[name] = {"step": step_vs_cpu(path, ZOO_CHECK_SEED, f"zoo step {name}")}
            config = load_config(str(path))
            r["model"], r["optimizer"] = config["model"], config.get("optimizer", "SGD")
            embs = {}
            for dev in ("cpu", DEVICE):
                net = build_speaker_net(config)
                missing, _ = load_speaker_state(net, seeded_state_dict(net.backbone,
                                                                       ZOO_CHECK_SEED))
                check(not missing, f"zoo {name}: seeded weights miss {missing[:4]}")
                net.to(dev).eval()
                launches = fbank_kernel.LAUNCHES
                embs[dev] = make_eval_embed(net, fcfg)({"wav": wav.to(dev),
                                                        "length": lengths.to(dev)}).cpu().numpy()
                r.setdefault("k1_launches", {})[dev] = fbank_kernel.LAUNCHES - launches
                del net
            cos = [cosine(a, b) for a, b in zip(embs[DEVICE], embs["cpu"])]
            r["embeddings"] = {"min_cosine": min(cos), "bar": COS_MIN["f32"],
                               "shape": list(embs[DEVICE].shape)}
            if name == "repvgg":
                r["deploy"] = _repvgg_deploy_check(config, wav, lengths, fcfg)
                log(f"[zoo repvgg] deploy form (convert_repvgg_params) against the training "
                    f"form, eval on the card: min cosine {r['deploy']['min_cosine']:.7f}, "
                    f"max|d| {r['deploy']['max_rel_err']:.2e} of max|embedding| (bar cosine "
                    f"{COS_MIN['f32']})")
                if r["deploy"]["min_cosine"] < COS_MIN["f32"]:
                    bad.append(f"repvgg deploy form {r['deploy']}")
            # timed steps at the config's batch
            n = ZOO_TIMED_BATCH or config["dataloader_args"]["batch_size"]
            net, state, step = _ecapa_net(DEVICE, config_path=path, seed=ZOO_CHECK_SEED)
            batch = {k: v.to(DEVICE) for k, v in _ecapa_check_batch(ZOO_CHECK_SEED + 1,
                                                                    n).items()}
            if DEVICE == "cuda":
                torch.cuda.reset_peak_memory_stats()
            ms = []
            for i in range(1 + ZOO_TIMED_STEPS):
                sync()
                t0 = time.perf_counter()
                step(state, batch)
                sync()
                ms.append(1e3 * (time.perf_counter() - t0))
            r["timed"] = {"batch": n, "chunk_s": 2.0, "step_ms": ms,
                          "step_ms_after_first": statistics.mean(ms[1:]),
                          "audio_s_per_s": n * 2.0 / (statistics.mean(ms[1:]) / 1e3),
                          "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                                          if DEVICE == "cuda" else "not measured")}
            del net, state, step, batch
            empty_cache()
            t = r["timed"]
            log(f"[zoo {name}] {config['model']} ({r['optimizer']}) eval embeddings through K1 "
                f"({r['k1_launches']} launches), card vs CPU: min cosine {min(cos):.7f} (bar "
                f"{COS_MIN['f32']}); {ZOO_TIMED_STEPS} f32 steps at {n} x 2 s: "
                + ", ".join(f"{x:.1f}" for x in ms) + f" ms, {t['step_ms_after_first']:.2f} ms "
                f"after the first = {t['audio_s_per_s']:.0f} audio-s/s; peak memory "
                + (f"{t['peak_mem_gb']:.2f} GB" if DEVICE == "cuda" else "not measured"))
            shape = (3, config["model_args"]["embed_dim"])
            if min(cos) < COS_MIN["f32"] or embs[DEVICE].shape != shape:
                bad.append(f"{name} embeddings {embs[DEVICE].shape}, cosines {cos}")
            if DEVICE == "cuda" and r["k1_launches"] != {"cpu": 0, DEVICE: 1}:
                bad.append(f"{name} K1 launches {r['k1_launches']}")
    check(not bad, "zoo: " + "; ".join(bad))


# ------------------------------------------------- the WavLM staged recipe
WAVLM_CONFIG = (Path(__file__).resolve().parent
                / "examples/voxceleb/v2/conf/ecapa_tdnn_wavlm_frozen.yaml")
WAVLM_SEED = 20251024
# the run's length: stage 1 3 epochs, stage 2 2, stage 3 1, of WAVLM_EPOCH_STEPS steps
WAVLM_EPOCH_STEPS = 2
WAVLM_STAGE_STEPS = {1: 3 * WAVLM_EPOCH_STEPS, 2: 2 * WAVLM_EPOCH_STEPS, 3: WAVLM_EPOCH_STEPS}
WAVLM_CPU_UTTS = 16  # stage-3 embeddings re-extracted in float32 on the CPU
WAVLM_EXTRA = []  # more overrides, for a CPU rehearsal (the upstream, batch sizes)
# 16 bf16 stage-3 embeddings against float32 bin/extract on the CPU: min
# cosine 0.9998351 at these weights (1 - cosine 1.649e-4).  The JAX
# package's bf16 path cannot run here; at data-matched BatchNorm statistics
# on the CPU it loses as much as the port's (the port within 1.25 x JAX's
# loss, tests/test_torch_port_wavlm_bf16.py), so the bar allows the
# reading that margin: 1 - 1.25 x 1.649e-4 = 0.99979, rounded up.
WAVLM_BF16_COS_MIN = 0.9998
# one bf16 stage-2 step against the float32 step at the same weights and
# batch, each bar between the sound reading and a control, a fault of the
# bf16 path (PERF.md section 2): the loss (sound 5.83e-4 relative) against
# the bf16 step with the norm layers' statistics taken in bf16 (2.41e-2),
# the whole update (relative L2, sound 2.965e-3) against the bf16 update
# held in bf16 weights, no float32 master weights (1.965e-2); H100 80GB
# HBM3, 700 W.  The phase fails if a control does not exceed its bar.
WAVLM_BF16_LOSS_BAR, WAVLM_BF16_UPDATE_BAR = 2e-3, 1e-2


def _wavlm_step_net(config, ckpt, compute_dtype):
    """Stage 2's model (`config`, the frontend unfrozen, 3 x 5,994 classes)
    with `ckpt`'s weights on the card, its TrainState and train step in
    `compute_dtype` (None: float32)."""
    from wespeaker_hubert_tpu_torch.bin.train import _feature_cfg
    from wespeaker_hubert_tpu_torch.models.speaker_net import build_speaker_net, load_speaker_state
    from wespeaker_hubert_tpu_torch.train.executor import make_train_step
    from wespeaker_hubert_tpu_torch.train.schedulers import ExponentialDecrease, MarginSchedule
    from wespeaker_hubert_tpu_torch.train.state import TrainState, make_optimizer

    def build():
        torch.manual_seed(0)
        net = build_speaker_net(config, 3 * RECIPE_SPEAKERS)
        missing, unexpected = load_speaker_state(
            net, torch.load(ckpt, map_location="cpu", weights_only=True))
        check(not missing and not unexpected, f"wavlm step: {missing[:4]} {unexpected[:4]}")
        return net

    net = built_once(("wavlm", ckpt, json.dumps(config, sort_keys=True, default=str)),
                     build).to(DEVICE)
    lr = ExponentialDecrease(num_epochs=2, epoch_iter=WAVLM_EPOCH_STEPS, initial_lr=1e-4,
                             final_lr=5e-5, warm_up_epoch=2)
    state = TrainState(net, make_optimizer(net), lr)
    step = make_train_step(net, lr, MarginSchedule(WAVLM_EPOCH_STEPS, 0, 1, 0.0, 0.2),
                           feature_cfg=_feature_cfg(config["dataset_args"]),
                           chunk_samples=_chunk(config), compute_dtype=compute_dtype, seed=43)
    return net, state, step


def phase_wavlm_recipe(report, root):
    """recipes.voxceleb_v2_wavlm stages 1-3 on the card with
    ecapa_tdnn_wavlm_frozen.yaml as the port's reader parses it
    (WavLM-Large, 24 x 1024, 16 heads; ECAPA_TDNN_GLOB_c512 at 1024 -> 192,
    ASTP; ArcMargin over 3 x 5,994 classes, 5,994 in stage 3; batch 64 x 3
    s, 6 s in stage 3; bf16 through enable_amp; speed perturbation, reverb /
    noise, SpecAug), overriding only paths, the flash-attention knob, a
    seeded model_init for stage 1 and the run's length (stage 1 3 epochs,
    stage 2 `joint_epochs` 2, stage 3 `lmft_epochs` 1, of WAVLM_EPOCH_STEPS
    steps, a checkpoint per epoch), on phase_recipe's shards.  Each stage is
    one call of the driver, K2's counts set to 0 just before and read just
    after.  Then: stage 1's checkpoints hold every `frontend.upstream`
    tensor bitwise as model_init gave it; stages 2 and 3 start from the
    previous stage's avg_model.pt (every tensor; stage 3's head fresh at
    5,994 classes); 16 stage-3 embeddings through bin/extract, float32 on
    the card against float32 on the CPU, bf16 on the card against float32 on
    the CPU (WAVLM_BF16_COS_MIN) and bf16 with K2 against bf16 with plain
    attention; a bf16 stage-2 step against the float32 step at the same
    weights and batch, with a control for each bar; 3 profiled stage-3
    steps.  Returns K2's launches per stage."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from wespeaker_hubert_tpu_torch.bin import train as bin_train
    from wespeaker_hubert_tpu_torch.bin.extract import extract
    from wespeaker_hubert_tpu_torch.bin.train import _to_device, read_spk2id
    from wespeaker_hubert_tpu_torch.data.aug_store import AugStore
    from wespeaker_hubert_tpu_torch.data.dataset import TrainPipeline, TrainPipelineConfig
    from wespeaker_hubert_tpu_torch.models.speaker_net import build_speaker_net, speaker_state_dict
    from wespeaker_hubert_tpu_torch.recipes import voxceleb_v2, voxceleb_v2_wavlm as recipe
    from wespeaker_hubert_tpu_torch.utils.config import apply_overrides, load_config

    data, exp = os.path.join(root, "data"), os.path.join(root, "exp_wavlm")
    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(data, "vox2_dev", "shard.list")):
        report.setdefault("recipe", {})["audio_s"] = write_recipe_data(data)
        voxceleb_v2.main(["--stage", "1", "--stop_stage", "2", "--config", str(RECIPE_CONFIG),
                          "--data_root", data, "--device", DEVICE])
    init = os.path.join(root, "wavlm_init.pt")
    overrides = [f"exp_dir={exp}", f"train_data={data}/vox2_dev/shard.list",
                 f"train_label={data}/vox2_dev/utt2spk",
                 f"dataset_args.reverb_data={data}/rirs_aug_store",
                 f"dataset_args.noise_data={data}/musan_aug_store",
                 "dataset_args.s3prl_args.attn_impl=flash", f"model_init={init}",
                 "num_epochs=3", f"epoch_iter={WAVLM_EPOCH_STEPS}", "save_epoch_interval=1",
                 "log_batch_interval=1", "joint_epochs=2", "lmft_epochs=1"] + WAVLM_EXTRA
    base = apply_overrides(load_config(str(WAVLM_CONFIG)), overrides)
    configs = recipe.stage_configs(base)
    net = build_speaker_net(base)
    torch.save(ssl_state_dict(net, WAVLM_SEED), init)
    del net
    out = report["wavlm_recipe"] = {"setup_s": time.perf_counter() - t0, "overrides": overrides}
    common = ["--config", str(WAVLM_CONFIG), "--device", DEVICE] + overrides

    started, timer = {}, _StepTimer()
    make = bin_train.make_train_step

    def spying(model, *args, **kwargs):
        # each stage's model as its train step is made (after model_init)
        started[len(started) + 1] = {k: v.detach().cpu().clone()
                                     for k, v in speaker_state_dict(model).items()}
        return timer(make)(model, *args, **kwargs)

    records = []
    handler = logging.Handler()
    handler.emit = lambda rec: records.append(rec.getMessage())
    logging.getLogger("train").addHandler(handler)
    bin_train.make_train_step = spying
    done, launches, peak_gb, calls = {}, {}, {}, {}
    try:
        for s in (1, 2, 3):
            if DEVICE == "cuda":
                torch.cuda.reset_peak_memory_stats()
            n_calls = len(timer.calls)
            _zero_counts()
            done.update(recipe.main(["--stage", str(s), "--stop_stage", str(s)] + common))
            sync()
            launches[s] = dict(zip(("fwd", "dkv", "dq", "bias_copies"), _counts()))
            peak_gb[s] = (torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda"
                          else "not measured")
            calls[s] = timer.calls[n_calls:]
    finally:
        bin_train.make_train_step = make
        logging.getLogger("train").removeHandler(handler)
    init_lines = [r for r in records if r.startswith("model_init")]
    stages = {}
    for s in (1, 2, 3):
        cfg = configs[s]
        batch, chunk_s = cfg["dataloader_args"]["batch_size"], cfg["dataset_args"]["num_frms"] / 100
        # all the work over all the time of every call after the first
        after = calls[s][1:]
        ms = 1e3 * sum(t for _, t in after) / sum(n for n, _ in after) if after else None
        losses = [json.loads(ln)["loss"]
                  for ln in open(os.path.join(done[s]["exp_dir"], "metrics.jsonl"))]
        stages[s] = {"s": done[s]["s"], "calls": [n for n, _ in calls[s]],
                     "step_ms_per_call": [1e3 * t / n for n, t in calls[s]],
                     "step_ms_after_first": ms if after else "not measured", "batch": batch,
                     "chunk_s": chunk_s, "losses": losses, "peak_mem_gb": peak_gb[s],
                     "audio_s_per_s": batch * chunk_s / (ms / 1e3) if after else "not measured",
                     "k2_launches": launches[s]}
        rate = (f"after the first {ms:.2f} ms per step = {stages[s]['audio_s_per_s']:.1f} "
                "audio-s/s" if after else "one step: no time after the first")
        log(f"[wavlm stage {s}] {recipe.STAGES[s][1]}: {len(calls[s])} steps of {batch} x "
            f"{chunk_s:g} s, per-step ms " + ", ".join(f"{x:.1f}" for x in
                                                        stages[s]["step_ms_per_call"])
            + f"; {rate}; losses " + ", ".join(f"{x:.3f}" for x in losses) + "; peak memory "
            + (f"{peak_gb[s]:.2f} GB" if DEVICE == "cuda" else "not measured")
            + f"; K2 launches {launches[s]}; stage {done[s]['s']:.1f} s")
    out["stages"] = stages
    out["model_init_lines"] = init_lines

    # stage 1 left the frozen encoder bitwise; stages 2-3 start from the averages
    init_sd = torch.load(init, map_location="cpu", weights_only=True)
    upstream = [k for k in init_sd if k.startswith("frontend.upstream.")]
    frozen_changed = []
    for n in range(1, 4):
        saved = torch.load(os.path.join(done[1]["exp_dir"], "models", f"model_{n}.pt"),
                           map_location="cpu", weights_only=True)
        frozen_changed += [f"model_{n}:{k}" for k in upstream if not torch.equal(saved[k],
                                                                                init_sd[k])]
        featurizer_moved = not torch.equal(saved["frontend.featurizer_weights"],
                                           init_sd["frontend.featurizer_weights"])
        del saved
    start_diff = {}
    for s in (2, 3):
        avg = torch.load(done[s - 1]["avg_model"], map_location="cpu", weights_only=True)
        start_diff[s] = [k for k in avg if not (s == 3 and k == "projection.weight")
                         and not torch.equal(started[s][k], avg[k])]
        del avg
    # stage 3's head: 5,994 rows where stage 2's average has 3 x 5,994, so
    # bin/train skips it (the "1 unexpected" below) and it keeps the init
    # bin/train seeds
    head_fresh = tuple(started[3]["projection.weight"].shape) == (RECIPE_SPEAKERS, 192)
    del started, init_sd
    out.update({"frozen_upstream_tensors": len(upstream), "frozen_changed": frozen_changed,
                "featurizer_trained_in_stage_1": featurizer_moved,
                "start_differs": start_diff, "stage3_head_fresh": head_fresh})
    log(f"[wavlm] stage 1's 3 checkpoints left {len(upstream) - len(frozen_changed)} of "
        f"{len(upstream)} frontend.upstream tensors bitwise as model_init gave them (featurizer "
        f"weights {'trained' if featurizer_moved else 'unchanged'}); stages 2 / 3 started from "
        f"the previous average with {len(start_diff[2])} / {len(start_diff[3])} tensors "
        f"different; stage 3's head fresh at {RECIPE_SPEAKERS} classes: {head_fresh}; "
        f"bin/train: {init_lines}")

    # 16 stage-3 embeddings: float32 bin/extract on the CPU (in a thread,
    # beside the card's untimed extractions) against float32 and bf16 on the
    # card; bf16 with K2 against bf16 with plain attention on the card.  The
    # shortest 16 of the eval list (3-4 s): the CPU's float32 WavLM-Large
    rows = Path(data, "vox1", "raw.list").read_text().splitlines()
    rows = sorted(rows, key=lambda r: os.path.getsize(json.loads(r)["wav"]))[:WAVLM_CPU_UTTS]
    sub = os.path.join(root, "wavlm_vox1_16.list")
    Path(sub).write_text("\n".join(rows) + "\n")
    t1 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        cpu_run = pool.submit(extract, configs[3], sub, done[3]["avg_model"], "", device="cpu")
        card, launches_extract = {}, {}
        for tag, dtype, impl in (("bf16", "bf16", "flash"), ("bf16_plain_attention", "bf16",
                                                              "einsum"), ("f32", None, "flash")):
            cfg = copy.deepcopy(configs[3])
            cfg["dataset_args"]["s3prl_args"]["attn_impl"] = impl
            if dtype:
                cfg["compute_dtype"] = dtype
            _zero_counts()
            keys, card[tag] = extract(cfg, sub, done[3]["avg_model"], "", device=DEVICE)
            launches_extract[tag] = _counts()[0]
        cpu_keys, cpu = cpu_run.result()
    cos = {tag: [cosine(a, b) for a, b in zip(card[tag], cpu)] for tag in ("bf16", "f32")}
    cos["bf16_k2_vs_plain"] = [cosine(a, b) for a, b in zip(card["bf16"],
                                                            card["bf16_plain_attention"])]
    extract_launches = launches_extract["bf16"]
    out["stage3_embeddings"] = {
        "n": len(rows), "k2_launches": launches_extract, "cpu_s": time.perf_counter() - t1,
        **{k: {"min_cosine": min(v), "median_cosine": statistics.median(v)}
           for k, v in cos.items()},
        "bars": {"f32": COS_MIN["f32"], "bf16_k2_vs_plain": COS_MIN["bf16"],
                 "bf16": WAVLM_BF16_COS_MIN}}
    log(f"[wavlm] {len(rows)} stage-3 embeddings through bin/extract, against float32 on the "
        f"CPU: float32 on the card min cosine {min(cos['f32']):.7f} (bar {COS_MIN['f32']}); bf16 "
        f"on the card min {min(cos['bf16']):.7f} (bar {WAVLM_BF16_COS_MIN}), median "
        f"{statistics.median(cos['bf16']):.7f}; "
        f"bf16 with K2 against bf16 with plain attention min "
        f"{min(cos['bf16_k2_vs_plain']):.7f} (bar {COS_MIN['bf16']}); K2 launches "
        f"{launches_extract}; {out['stage3_embeddings']['cpu_s']:.1f} s with the CPU's")

    # a bf16 stage-2 step against the float32 step: same weights (stage 1's
    # average, stage 2's start), same batch
    cfg2 = configs[2]
    da = cfg2["dataset_args"]
    pipe = TrainPipeline(
        Path(data, "vox2_dev", "shard.list").read_text().split(),
        read_spk2id(os.path.join(data, "vox2_dev", "utt2spk")),
        TrainPipelineConfig(data_type="shard", num_frms=da["num_frms"],
                            batch_size=cfg2["dataloader_args"]["batch_size"],
                            shuffle_size=da["shuffle_args"]["shuffle_size"], seed=7),
        AugStore(root=os.path.join(data, "rirs_aug_store")),
        AugStore(root=os.path.join(data, "musan_aug_store")))
    batch = _to_device(next(iter(pipe)), torch.device(DEVICE))
    res = {}
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        net, state, step = _wavlm_step_net(cfg2, done[1]["avg_model"], dtype)
        if dtype is not None:
            start = {k: v.detach().float().cpu().clone() for k, v in net.state_dict().items()
                     if v.is_floating_point()}
        res[tag] = _one_step(net, state, step, batch, prefix="")
        del net, state, step
        empty_cache()
    # the controls, two faults of the bf16 path: the norm layers'
    # statistics taken in bf16 (models/norm.py takes them in float32, as the
    # JAX package does), and no float32 master weights (the bf16 step's
    # update as bf16 weights would hold it)
    from wespeaker_hubert_tpu_torch.models import norm

    net, state, step = _wavlm_step_net(cfg2, done[1]["avg_model"], torch.bfloat16)
    upcast, norm.upcast = norm.upcast, lambda x: x
    try:
        ctrl_loss = abs(_one_step(net, state, step, batch, prefix="projection.")[0]
                        - res["f32"][0]) / abs(res["f32"][0])
    finally:
        norm.upcast = upcast
    del net, state, step
    empty_cache()
    ctrl_upd = _rel_l2({k: (start[k].bfloat16().float() + v).bfloat16().float()
                        - start[k].bfloat16().float() for k, v in res["bf16"][1].items()},
                       res["f32"][1])
    del start
    loss_rel = abs(res["bf16"][0] - res["f32"][0]) / abs(res["f32"][0])
    upd_rel = _rel_l2(res["bf16"][1], res["f32"][1])
    pair = _diff_table(res["bf16"][1], res["f32"][1])
    worst = sorted(pair.items(), key=lambda kv: kv[1][0])[:4]
    out["bf16_vs_f32_step"] = {
        "loss": [res["bf16"][0], res["f32"][0]], "loss_rel": loss_rel,
        "loss_bar": WAVLM_BF16_LOSS_BAR, "updates_rel_l2": upd_rel,
        "updates_bar": WAVLM_BF16_UPDATE_BAR, "worst": worst,
        "control_loss_rel": ctrl_loss, "control_loss_fault": "the bf16 step with the norm "
        "layers' statistics taken in bf16", "control_updates_rel_l2": ctrl_upd,
        "control_updates_fault": "the bf16 step's update held in bf16 weights (no float32 "
                                 "master weights)"}
    log(f"[wavlm] a bf16 stage-2 step against the float32 step (batch {batch['label'].shape[0]} "
        f"x {da['num_frms'] / 100:g} s, stage 1's average): loss {res['bf16'][0]:.5f} vs "
        f"{res['f32'][0]:.5f} (rel {loss_rel:.3e}, bar {WAVLM_BF16_LOSS_BAR}; control, the "
        f"norm statistics in bf16, {ctrl_loss:.3e}); updates relative L2 {upd_rel:.3e} (bar "
        f"{WAVLM_BF16_UPDATE_BAR}; control, no float32 master weights, {ctrl_upd:.3e}); least "
        f"cosines {worst}")
    del res, pair

    # 3 profiled stage-3 steps from stage 3's average, bf16
    prof_out = "not measured"
    if DEVICE == "cuda":
        cfg3 = configs[3]
        pipe = TrainPipeline(
            Path(data, "vox2_dev", "shard.list").read_text().split(),
            read_spk2id(os.path.join(data, "vox2_dev", "utt2spk")),
            TrainPipelineConfig(data_type="shard", num_frms=cfg3["dataset_args"]["num_frms"],
                                batch_size=cfg3["dataloader_args"]["batch_size"],
                                speed_perturb=False, seed=8),
            AugStore(root=os.path.join(data, "rirs_aug_store")),
            AugStore(root=os.path.join(data, "musan_aug_store")))
        batch3 = _to_device(next(iter(pipe)), torch.device(DEVICE))
        from wespeaker_hubert_tpu_torch.bin.train import _feature_cfg
        from wespeaker_hubert_tpu_torch.models.speaker_net import load_speaker_state
        from wespeaker_hubert_tpu_torch.train.executor import make_train_step
        from wespeaker_hubert_tpu_torch.train.schedulers import ExponentialDecrease, MarginSchedule
        from wespeaker_hubert_tpu_torch.train.state import TrainState, make_optimizer

        net = build_speaker_net(cfg3, RECIPE_SPEAKERS)
        load_speaker_state(net, torch.load(done[3]["avg_model"], map_location="cpu",
                                           weights_only=True))
        net.to(DEVICE)
        lr = ExponentialDecrease(num_epochs=1, epoch_iter=WAVLM_EPOCH_STEPS, initial_lr=2e-5,
                                 final_lr=5e-5, warm_up_epoch=1)
        state = TrainState(net, make_optimizer(net), lr)
        step = make_train_step(net, lr, MarginSchedule(WAVLM_EPOCH_STEPS, 1, 1, 0.5, 0.5),
                               feature_cfg=_feature_cfg(cfg3["dataset_args"]),
                               chunk_samples=_chunk(cfg3), compute_dtype=torch.bfloat16, seed=43)
        for _ in range(2):
            step(state, batch3)
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for _ in range(3):
                step(state, batch3)
            sync()
            wall_us = (time.perf_counter() - t1) * 1e6
        prof_out = grouped_profile(prof, wall_us, {"K2 flash_fwd": ("flash_fwd",),
                                                   "K2 flash_bwd": ("flash_bwd",),
                                                   **PROFILE_GROUPS})
        prof_out["window"] = ("3 bf16 stage-3 steps, batch 64 x 6 s, WavLM-Large unfrozen + "
                              f"ECAPA_TDNN_GLOB_c512, {RECIPE_SPEAKERS} classes")
        shares = prof_out["shares"] if prof_out["device_ms"] else {}
        prof_out["k2_share"] = (shares.get("K2 flash_fwd", 0.0) + shares.get("K2 flash_bwd", 0.0)
                                if shares else "not measured")
        del net, state, step, batch3, prof
        empty_cache()
        if prof_out["device_ms"]:
            log(f"[wavlm profile] 3 bf16 stage-3 steps: device {prof_out['device_ms']:.2f} ms "
                f"over {prof_out['wall_ms']:.2f} ms wall (idle share "
                f"{prof_out['device_idle_share']:.4f}); K2 share {prof_out['k2_share']:.4f}; "
                "shares " + ", ".join(f"{g} {v:.3f}" for g, v in shares.items()))
            for g in ("K2 flash_fwd", "K2 flash_bwd", "GEMM", "conv", "elementwise"):
                log(f"[wavlm profile]   {g}: " + "; ".join(prof_out["group_top"][g][:3]))
        else:
            log("[wavlm profile] torch.profiler reported no device time: not measured")
    out["profile"] = prof_out

    n = 24  # K2 launches once per layer and step
    want = {1: (n * WAVLM_STAGE_STEPS[1], 0, 0), 2: (n * WAVLM_STAGE_STEPS[2],) * 3,
            3: (n * WAVLM_STAGE_STEPS[3],) * 3}
    got = {s: (v["fwd"], v["dkv"], v["dq"]) for s, v in launches.items()}
    check(sorted(done) == [1, 2, 3], f"wavlm: stages {sorted(done)}")
    check({s: stages[s]["calls"] for s in stages} == {s: [1] * k for s, k in
                                                      WAVLM_STAGE_STEPS.items()},
          f"wavlm: step calls {[stages[s]['calls'] for s in stages]}")
    check(got == want and all(v["bias_copies"] == 0 for v in launches.values()),
          f"wavlm: K2 launches {launches}, want (fwd, dkv, dq) {want}")
    check(all(math.isfinite(x) for s in stages for x in stages[s]["losses"]),
          "wavlm: a loss is not finite")
    check(not frozen_changed, f"wavlm: stage 1 changed frozen tensors {frozen_changed[:4]}")
    check(not start_diff[2] and not start_diff[3],
          f"wavlm: stages 2 / 3 did not start from the averages: {start_diff}")
    check(head_fresh, "wavlm: stage 3's head is not the fresh 5,994-class head")
    check(init_lines[1:] == [f"model_init from {done[1]['avg_model']} (epoch 0, 0 missing, "
                             "0 unexpected)",
                             f"model_init from {done[2]['avg_model']} (epoch 0, 0 missing, "
                             "1 unexpected)"], f"wavlm: bin/train's initialization {init_lines}")
    check(len(cos["f32"]) == WAVLM_CPU_UTTS and keys == cpu_keys
          and min(cos["f32"]) >= COS_MIN["f32"],
          f"wavlm: stage-3 embeddings, float32 on the card against the CPU: {cos['f32']}")
    check(min(cos["bf16_k2_vs_plain"]) >= COS_MIN["bf16"],
          f"wavlm: stage-3 embeddings, bf16 K2 against plain attention: {cos['bf16_k2_vs_plain']}")
    check(extract_launches > 0 and extract_launches % n == 0
          and launches_extract["f32"] == extract_launches
          and launches_extract["bf16_plain_attention"] == 0,
          f"wavlm: the extractions launched K2 {launches_extract} times")
    check(min(cos["bf16"]) >= WAVLM_BF16_COS_MIN,
          f"wavlm: stage-3 embeddings, bf16 on the card against float32 on the CPU: {cos['bf16']}")
    check(loss_rel <= WAVLM_BF16_LOSS_BAR < ctrl_loss
          and upd_rel <= WAVLM_BF16_UPDATE_BAR < ctrl_upd,
          f"wavlm: the bf16 stage-2 step against the float32 step: loss {loss_rel} (control "
          f"{ctrl_loss}), updates {upd_rel} (control {ctrl_upd})")
    return launches


# ------------------------------------------------- the Whisper-PMFA recipe
WHISPER_CONF = Path(__file__).resolve().parent / "examples/voxceleb/v1/Whisper-PMFA/conf"
WHISPER_SPEAKERS = 1211  # VoxCeleb1 dev: the head has 3 x 1,211 classes
WHISPER_TRAIN_SPEAKERS, WHISPER_PER_SPEAKER = 64, 4  # 256 utterances of 2-7.9 s
WHISPER_STEPS = {3: 3, 4: 4}  # stage 3 at batch 64, stage 4 at batch 16
WHISPER_SEED = 20251022
WHISPER_CHECK_BATCH = 4
WHISPER_CPU_UTTS = 3  # stage-5 utterances re-extracted on the CPU, one past 30 s
WHISPER_VARIANT = "large_v2"  # the configs' own; a CPU rehearsal sets "tiny_test"
WHISPER_EXTRA = []  # more overrides, for a CPU rehearsal (batch sizes)


def write_whisper_data(data):
    """The Whisper recipe's DATA directory from seeded audio: vox1_dev with
    256 speech-like utterances of 2-7.9 s over 64 speakers (inside the
    configs' 1-8 s filter) and 4 of 30-40 s (which the filter keeps out of
    training and stage 5 extracts), its utt2spk naming all 1,211 VoxCeleb1
    dev speakers (the rest without audio); vox1 with 24 utterances over 8
    speakers, 2-8, 8-20 and 30-40 s each, and a labeled trial list over all
    their pairs; RIR and noise stores.  Returns the audio seconds of each
    list."""
    from wespeaker_hubert_tpu_torch.data.wav_io import write_wav

    rng = np.random.default_rng(WHISPER_SEED)
    seconds = {}
    for dset in ("vox1_dev", "vox1"):
        scp, u2s, total = [], [], 0.0
        n_spk = WHISPER_TRAIN_SPEAKERS if dset == "vox1_dev" else 8
        for s in range(n_spk):
            spk, f0 = f"id1{s:04d}" if dset == "vox1_dev" else f"id9{s:04d}", rng.uniform(90, 280)
            if dset == "vox1_dev":
                spans = [(2.0, 7.9)] * WHISPER_PER_SPEAKER + ([(30.0, 40.0)] if s < 4 else [])
            else:
                spans = [(2.0, 8.0), (8.0, 20.0), (30.0, 40.0)]
            for j, (lo, hi) in enumerate(spans):
                x = speechlike(rng, float(rng.uniform(lo, hi)), f0)
                total += len(x) / SR
                key = f"{spk}-{j:02d}"
                path = f"{data}/{dset}/wav/{key}.wav"
                os.makedirs(os.path.dirname(path), exist_ok=True)
                write_wav(path, x)
                scp.append(f"{key} {path}")
                u2s.append(f"{key} {spk}")
        if dset == "vox1_dev":
            u2s += [f"id1{s:04d}-absent id1{s:04d}" for s in range(n_spk, WHISPER_SPEAKERS)]
        Path(f"{data}/{dset}/wav.scp").write_text("\n".join(scp) + "\n")
        Path(f"{data}/{dset}/utt2spk").write_text("\n".join(u2s) + "\n")
        seconds[dset] = total
    keys = [ln.split()[0] for ln in Path(f"{data}/vox1/wav.scp").read_text().splitlines()]
    Path(f"{data}/vox1/trials.kaldi").write_text("\n".join(
        f"{a} {b} {'target' if a[:8] == b[:8] else 'nontarget'}"
        for i, a in enumerate(keys) for b in keys[i + 1:]) + "\n")
    stores = {"rirs_aug_store": {f"rir{i}": np.exp(-np.arange(4000) / 800.0)
                                 * rng.standard_normal(4000) for i in range(4)},
              "musan_aug_store": {f"{kind}{i}": 0.1 * rng.standard_normal(6 * SR)
                                  for kind in ("noise", "music", "speech") for i in range(2)}}
    for name, arrays in stores.items():
        d = os.path.join(data, name)
        os.makedirs(d)
        for key, x in arrays.items():
            np.save(os.path.join(d, key + ".npy"), x.astype(np.float32))
        with open(os.path.join(d, "index.json"), "w") as f:
            json.dump({k: k + ".npy" for k in arrays}, f)
    return seconds


def write_openai_whisper(path, cfg, seed=WHISPER_SEED):
    """A seeded state dict in OpenAI's Whisper encoder layout (large-v2's
    32 blocks: 8 past `cfg`'s 24, `positional_embedding`, `ln_post`; no
    `ln_post2`) as an `.npz`, what `whisper_encoder_args.checkpoint` names:
    weights of std fan_in^-0.5, small biases, LayerNorm scales near 1."""
    g = torch.Generator().manual_seed(seed)
    d, m, n_blocks, sd = cfg.n_state, cfg.n_mels, cfg.n_layer + 8, {}

    def put(name, *shape, std=None, center=0.0):
        std = float(np.prod(shape[1:])) ** -0.5 if std is None else std
        sd[name] = (center + std * torch.randn(shape, generator=g)).numpy()

    put("conv1.weight", d, m, 3)
    put("conv1.bias", d, std=0.02)
    put("conv2.weight", d, d, 3)
    put("conv2.bias", d, std=0.02)
    put("positional_embedding", cfg.n_ctx, d, std=0.02)
    for ln in ["ln_post"] + [f"blocks.{i}.{n}" for i in range(n_blocks)
                             for n in ("attn_ln", "mlp_ln")]:
        put(ln + ".weight", d, std=0.1, center=1.0)
        put(ln + ".bias", d, std=0.02)
    for i in range(n_blocks):
        p = f"blocks.{i}"
        for name in ("query", "key", "value", "out"):
            put(f"{p}.attn.{name}.weight", d, d)
            if name != "key":
                put(f"{p}.attn.{name}.bias", d, std=0.02)
        put(f"{p}.mlp.0.weight", 4 * d, d)
        put(f"{p}.mlp.0.bias", 4 * d, std=0.02)
        put(f"{p}.mlp.2.weight", d, 4 * d)
        put(f"{p}.mlp.2.bias", d, std=0.02)
    np.savez(path, **sd)


class _EmbedCounter:
    """Wraps bin/extract's make_eval_embed: counts the batches every
    embedding function it makes is called on; the counting is the only
    change to the run."""

    def __init__(self):
        self.batches = 0

    def __call__(self, make):
        def counted(*args, **kwargs):
            fn = make(*args, **kwargs)

            def embed(batch):
                self.batches += 1
                return fn(batch)
            return embed
        return counted


def _chunk(config):
    from wespeaker_hubert_tpu_torch.data.dataset import chunk_samples_for_frames

    return chunk_samples_for_frames(config["dataset_args"]["num_frms"])


def _whisper_step_net(config, ckpt, device, attn_impl="flash", dtype=None):
    """The stage-4 model (`config`, the encoder unfrozen) with `ckpt`'s
    weights, its TrainState and float32 (or `dtype`) train step on
    `device`; built on the card directly where it runs there."""
    import copy

    from wespeaker_hubert_tpu_torch.bin.train import _feature_cfg
    from wespeaker_hubert_tpu_torch.models.speaker_net import build_speaker_net, load_speaker_state
    from wespeaker_hubert_tpu_torch.train.executor import make_train_step
    from wespeaker_hubert_tpu_torch.train.schedulers import ExponentialDecrease, MarginSchedule
    from wespeaker_hubert_tpu_torch.train.state import TrainState, make_optimizer

    cfg = copy.deepcopy(config)
    cfg["dataset_args"]["whisper_encoder_args"]["attn_impl"] = attn_impl
    with torch.device(device):
        net = build_speaker_net(cfg, 3 * WHISPER_SPEAKERS)
    missing, unexpected = load_speaker_state(
        net, torch.load(ckpt, map_location="cpu", weights_only=True))
    check(not missing and not unexpected, f"whisper step: {missing} {unexpected}")
    if dtype is not None:
        net.to(dtype)
    lr = ExponentialDecrease(num_epochs=1, epoch_iter=WHISPER_STEPS[4], initial_lr=0.005,
                             final_lr=0.00073, warm_up_epoch=1)
    state = TrainState(net, make_optimizer(net), lr)
    step = make_train_step(net, lr, MarginSchedule(WHISPER_STEPS[4], 0, 8, 0.2, 0.2),
                           feature_cfg=_feature_cfg(cfg["dataset_args"]),
                           chunk_samples=_chunk(cfg), seed=43)
    return net, state, step


def _whisper_batch(config, data, n, seed):
    """A train batch of n from the stage-4 pipeline over vox1_dev (speed
    perturbation, packed reverb / noise rows), host arrays."""
    from wespeaker_hubert_tpu_torch.bin.train import read_spk2id
    from wespeaker_hubert_tpu_torch.data.aug_store import AugStore
    from wespeaker_hubert_tpu_torch.data.dataset import TrainPipeline, TrainPipelineConfig

    pipe = TrainPipeline(
        Path(data, "vox1_dev", "raw.list").read_text().splitlines(),
        read_spk2id(os.path.join(data, "vox1_dev", "utt2spk")),
        TrainPipelineConfig(num_frms=config["dataset_args"]["num_frms"], batch_size=n,
                            seed=seed, aug_prob=0.6),
        AugStore(root=os.path.join(data, "rirs_aug_store")),
        AugStore(root=os.path.join(data, "musan_aug_store")))
    check(pipe.chunk_samples == _chunk(config), f"whisper: chunk {pipe.chunk_samples}")
    return next(iter(pipe))


def phase_whisper_recipe(report, root):
    """recipes.voxceleb_v1_whisper_pmfa stages 2-7 on the card with the
    Whisper-PMFA configs as the port's reader parses them (Whisper-large-v2
    as the JAX package defines it: 24 blocks of 1,280, 20 heads; layers
    16-23 concatenated, ln_post2, the PMFA head over 3 x 1,211 classes,
    float32), overriding the paths, `attn_impl: flash`, the seeded OpenAI
    checkpoint and the run's length.  Stages 2-3, 4 and 5-7 are each driven
    with K2's counts set to 0 just before and read just after.  Then the
    frozen encoder against its checkpoint, stage-5 embeddings and a stage-4
    step against the CPU, and 3 profiled stage-4 steps.  Returns K2's
    launches per stage."""
    import logging

    from torch.profiler import ProfilerActivity, profile

    from wespeaker_hubert_tpu_torch.bin import extract as bin_extract
    from wespeaker_hubert_tpu_torch.bin import train as bin_train
    from wespeaker_hubert_tpu_torch.bin.extract import extract
    from wespeaker_hubert_tpu_torch.frontend import read_whisper_checkpoint, whisper_encoder_state
    from wespeaker_hubert_tpu_torch.frontend.whisper import WhisperEncoderConfig
    from wespeaker_hubert_tpu_torch.recipes import voxceleb_v1_whisper_pmfa as recipe
    from wespeaker_hubert_tpu_torch.utils.embeddings import embeddings_dict

    data, exp0, exp1 = (os.path.join(root, d) for d in ("data", "exp0", "exp1"))
    t0 = time.perf_counter()
    seconds = write_whisper_data(data)
    npz = os.path.join(root, "large-v2.npz")
    wcfg = getattr(WhisperEncoderConfig, WHISPER_VARIANT)()
    write_openai_whisper(npz, wcfg)
    out = report["whisper_recipe"] = {"data_write_s": time.perf_counter() - t0,
                                      "audio_s": seconds}
    trials = os.path.join(data, "vox1", "trials.kaldi")
    overrides = [f"stage0.exp_dir={exp0}", f"stage1.exp_dir={exp1}",
                 f"train_data={data}/vox1_dev/raw.list", f"train_label={data}/vox1_dev/utt2spk",
                 f"dataset_args.reverb_data={data}/rirs_aug_store",
                 f"dataset_args.noise_data={data}/musan_aug_store",
                 "dataset_args.whisper_encoder_args.attn_impl=flash",
                 f"stage0.dataset_args.whisper_encoder_args.checkpoint={npz}",
                 "num_epochs=1", "save_epoch_interval=1", "log_batch_interval=1",
                 f"stage0.epoch_iter={WHISPER_STEPS[3]}", f"stage1.epoch_iter={WHISPER_STEPS[4]}",
                 f"dataset_args.whisper_encoder_args.variant={WHISPER_VARIANT}"] + WHISPER_EXTRA
    out["overrides"] = overrides
    common = ["--stage0_config", str(WHISPER_CONF / "whisper_pmfa_stage0.yaml"),
              "--stage1_config", str(WHISPER_CONF / "whisper_pmfa_stage1.yaml"),
              "--data_root", data, "--trials", trials, "--device", DEVICE] + overrides
    cfg0, cfg1 = recipe.load_configs(recipe.parse_args(common))
    timer, counter = _StepTimer(), _EmbedCounter()
    make_step, make_embed = bin_train.make_train_step, bin_extract.make_eval_embed
    bin_train.make_train_step, bin_extract.make_eval_embed = timer(make_step), counter(make_embed)
    rates = []
    handler = logging.Handler()
    handler.emit = lambda rec: rates.append(rec.getMessage())
    logging.getLogger("extract").addHandler(handler)
    done, launches, peak_gb, step_calls = {}, {}, {}, {}
    try:
        for first, last in ((2, 3), (4, 4), (5, 7)):
            if DEVICE == "cuda":
                torch.cuda.reset_peak_memory_stats()
            n_calls = len(timer.calls)
            _zero_counts()
            done.update(recipe.main(["--stage", str(first), "--stop_stage", str(last)] + common))
            sync()
            launches[last] = dict(zip(("fwd", "dkv", "dq"), _counts()[:3]))
            peak_gb[last] = (torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda"
                             else "not measured")
            step_calls[last] = timer.calls[n_calls:]
    finally:
        bin_train.make_train_step, bin_extract.make_eval_embed = make_step, make_embed
        logging.getLogger("extract").removeHandler(handler)
    extract_lines, extract_rate = _stage_rates(rates)

    def step_stats(calls, cfg):
        # all the work over all the time of every call after the first
        ms = 1e3 * sum(s for _, s in calls[1:]) / max(1, sum(n for n, _ in calls[1:]))
        audio = cfg["dataloader_args"]["batch_size"] * cfg["dataset_args"]["num_frms"] / 100
        return {"per_step_ms": [1e3 * s / n for n, s in calls], "step_ms_after_first": ms,
                "audio_s_per_s": audio / (ms / 1e3)}

    train3, train4 = step_stats(step_calls[3], cfg0), step_stats(step_calls[4], cfg1)
    losses = {s: [json.loads(ln)["loss"] for ln in open(os.path.join(d, "metrics.jsonl"))]
              for s, d in ((3, exp0), (4, exp1))}
    out.update({
        "stage_s": {s: d["s"] for s, d in done.items()},
        "lines": {s: d["lines"] for s, d in done.items() if d["lines"]},
        "launches": {"stage 2-3": launches[3], "stage 4": launches[4],
                     "stage 5-7": launches[7]},
        "extract_batches": counter.batches, "peak_mem_gb": {
            "stage 2-3": peak_gb[3], "stage 4": peak_gb[4], "stage 5-7": peak_gb[7]},
        "stage3": train3, "stage4": train4, "losses": losses,
        "extract_log": extract_lines, "extract_audio_s_per_s": extract_rate,
        "stage5_wall_audio_s_per_s": (seconds["vox1"] + seconds["vox1_dev"]) / done[5]["s"],
    })
    log(f"[whisper] data: {WHISPER_TRAIN_SPEAKERS * WHISPER_PER_SPEAKER} training utterances "
        f"over {WHISPER_TRAIN_SPEAKERS} of {WHISPER_SPEAKERS} speakers and 4 of 30-40 s "
        f"({seconds['vox1_dev']:.0f} s), 24 eval ({seconds['vox1']:.0f} s), a seeded 32-block "
        f"OpenAI large-v2 state dict; written in {out['data_write_s']:.1f} s")
    log("[whisper] stage seconds: " + ", ".join(f"{s} {d['s']:.1f}" for s, d in done.items()))
    for s, tr, batch in ((3, train3, cfg0["dataloader_args"]["batch_size"]),
                         (4, train4, cfg1["dataloader_args"]["batch_size"])):
        log(f"[whisper] stage {s}: batch {batch} x {cfg1['dataset_args']['num_frms'] / 100:g} s, "
            f"per-step ms "
            + ", ".join(f"{x:.1f}" for x in tr["per_step_ms"]) + f"; after the first "
            f"{tr['step_ms_after_first']:.2f} ms = {tr['audio_s_per_s']:.1f} audio-s/s; losses "
            + ", ".join(f"{x:.4f}" for x in losses[s]) + f"; peak memory "
            + (f"{peak_gb[s if s == 4 else 3]:.2f} GB" if DEVICE == "cuda" else "not measured")
            + f"; K2 launches {launches[s if s == 4 else 3]}")
    log(f"[whisper] stage 5: " + " | ".join(extract_lines) + f"; loop rate {extract_rate:.1f} "
        f"audio-s/s, stage wall rate {out['stage5_wall_audio_s_per_s']:.1f} audio-s/s "
        f"(averaging and model loads included); {counter.batches} batches, K2 launches "
        f"{launches[7]}, peak memory "
        + (f"{peak_gb[7]:.2f} GB" if DEVICE == "cuda" else "not measured"))
    for s in (6, 7):
        log(f"[whisper] stage {s}: " + "; ".join(done[s]["lines"]))

    # the frozen encoder: stage 3's checkpoint holds the imported tensors bitwise
    imported = whisper_encoder_state(read_whisper_checkpoint(npz), wcfg)
    saved = torch.load(os.path.join(exp0, "models", "model_1.pt"), map_location="cpu",
                       weights_only=True)
    changed = [k for k, v in imported.items() if not torch.equal(saved["frontend." + k], v)]
    out["frozen_changed"] = changed
    log(f"[whisper] stage 3 left {len(imported) - len(changed)} of {len(imported)} encoder "
        f"tensors bitwise as imported (ln_post2 fresh: ones, zeros)")
    del imported, saved

    # stage-5 embeddings against bin/extract on the CPU
    lines = Path(data, "vox1", "raw.list").read_text().splitlines()
    pick = [lines[0], lines[1], lines[2]][:WHISPER_CPU_UTTS]
    sub = os.path.join(root, "vox1_cpu.list")
    Path(sub).write_text("\n".join(pick) + "\n")
    card = embeddings_dict(os.path.join(exp1, "embeddings", "vox1.npz"))
    t1 = time.perf_counter()
    keys, emb = extract(cfg1, sub, os.path.join(exp1, "avg_model.pt"), "", device="cpu")
    cos = [cosine(card[k], e) for k, e in zip(keys, emb)]
    out["embeddings_vs_cpu"] = {"keys": keys, "cosine": cos, "bar": COS_MIN["f32"],
                                "cpu_s": time.perf_counter() - t1}
    log(f"[whisper] stage-5 embeddings of {len(keys)} utterances (2-8, 8-20, 30-40 s) against "
        f"bin/extract on the CPU: cosines " + ", ".join(f"{c:.7f}" for c in cos)
        + f" (bar {COS_MIN['f32']}); {out['embeddings_vs_cpu']['cpu_s']:.1f} s on the CPU")

    # stage 5's profile: bin/extract on the 24 eval utterances (2-40 s, T up
    # to 1,500 tokens) with the stage-4 average, once to warm, once traced
    # from its first embedding call to its end (the model's load and build
    # before it are not in the window)
    s5_prof = "not measured"
    if DEVICE == "cuda":
        eval_list, avg = os.path.join(data, "vox1", "raw.list"), os.path.join(exp1, "avg_model.pt")
        extract(cfg1, eval_list, avg, "", device=DEVICE)
        sync()
        traced = {}

        def tracing(make):
            def made(*args, **kwargs):
                fn = make(*args, **kwargs)

                def call(*a, **kw):
                    if not traced:
                        sync()
                        traced["prof"] = profile(
                            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                        traced["prof"].start()
                        traced["t"] = time.perf_counter()
                    return fn(*a, **kw)
                return call
            return made

        bin_extract.make_eval_embed = tracing(make_embed)
        try:
            extract(cfg1, eval_list, avg, "", device=DEVICE)
            sync()
        finally:
            bin_extract.make_eval_embed = make_embed
        wall_us = (time.perf_counter() - traced["t"]) * 1e6
        traced["prof"].stop()
        s5_prof = grouped_profile(traced["prof"], wall_us, {"K2 flash_fwd": ("flash_fwd",),
                                                            "log-mel FFT": ("fft", "radix"),
                                                            **PROFILE_GROUPS})
        s5_prof["window"] = ("bin/extract.extract of the 24 eval utterances (2-40 s), float32, "
                             "from its first embedding call to its end")
        del traced
        empty_cache()
        if s5_prof["device_ms"]:
            log(f"[whisper stage-5 profile] 24 utterances: device {s5_prof['device_ms']:.2f} ms "
                f"over {s5_prof['wall_ms']:.2f} ms wall (idle share "
                f"{s5_prof['device_idle_share']:.4f}); shares " + ", ".join(
                    f"{g} {v:.3f}" for g, v in s5_prof["shares"].items()))
            for g in ("K2 flash_fwd", "GEMM", "elementwise"):
                log(f"[whisper stage-5 profile]   {g}: " + "; ".join(s5_prof["group_top"][g][:3]))
        else:
            log("[whisper stage-5 profile] torch.profiler reported no device time: not measured")
    out["stage5_profile"] = s5_prof

    # one full-width stage-4 step at a small batch, card against CPU
    init = os.path.join(exp0, "models", "model_1.pt")
    host = _whisper_batch(cfg1, data, WHISPER_CHECK_BATCH, 11)
    res = {}

    def run(tag, dev, scale, dtype, impl):
        net, state, step = _whisper_step_net(cfg1, init, dev, impl, dtype)
        b = {k: torch.from_numpy(v).to(dev) for k, v in host.items() if k != "keys"}
        if dtype is not None:
            b = {k: v.to(dtype) if v.is_floating_point() else v for k, v in b.items()}
        t1 = time.perf_counter()
        if tag == "float64":
            res[tag] = (float(step(state, b)["loss"]),)
        else:
            res[tag] = _one_step(net, state, step, _perturbed(b) if scale else b, prefix="")
        res[tag + "_s"] = time.perf_counter() - t1
        del net, state, step, b
        empty_cache()

    # the CPU's step in a thread beside the card's three
    with ThreadPoolExecutor(1) as pool:
        cpu_run = pool.submit(run, "cpu", "cpu", False, None, "flash")
        for args in (("card", DEVICE, False, None, "flash"),
                     ("control", DEVICE, True, None, "flash"),
                     ("float64", DEVICE, False, torch.float64, "einsum")):
            run(*args)
        cpu_run.result()
    exact = res["float64"][0]
    loss_rel = abs(res["card"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    cpu_off = abs(res["cpu"][0] - exact) / abs(exact)
    # float32 leaves the loss some 1e-5 off the exact one where the head's
    # BatchNorm (flax's E[x^2] - E[x]^2) sees pooled statistics nearly equal
    # across the batch: the bar is 1e-5, or twice the CPU's distance from
    # the float64 step where that is more
    loss_bar = max(1e-5, 2 * cpu_off)
    pair = _diff_table(res["card"][1], res["cpu"][1])
    control = _diff_table(res["control"][1], res["card"][1])
    failing, how = _update_agreement(pair, control, 0.9999, res["cpu"][2])
    worst = sorted(pair.items(), key=lambda kv: kv[1][0])[:4]
    out["step_vs_cpu"] = {
        "batch": WHISPER_CHECK_BATCH, "loss": [res["card"][0], res["cpu"][0], exact],
        "loss_rel": loss_rel, "cpu_vs_float64_rel": cpu_off,
        "card_vs_float64_rel": abs(res["card"][0] - exact) / abs(exact), "loss_bar": loss_bar,
        "updates_rel_l2": _rel_l2(res["card"][1], res["cpu"][1]),
        "control_updates_rel_l2": _rel_l2(res["control"][1], res["card"][1]),
        "n_tensors": len(pair), "passed_by": how, "worst": worst, "failing": failing,
        "cpu_step_s": res["cpu_s"], "card_step_s_first": res["card_s"]}
    r = out["step_vs_cpu"]
    del res
    log(f"[whisper step] f32 stage-4 step at full width ({3 * WHISPER_SPEAKERS} classes, batch "
        f"{WHISPER_CHECK_BATCH} x 5 s, flash), card vs CPU: loss {r['loss'][0]:.7f} vs "
        f"{r['loss'][1]:.7f} (rel {loss_rel:.2e}; the float64 step on the card {exact:.7f}: CPU "
        f"{cpu_off:.2e} off it, card {r['card_vs_float64_rel']:.2e}; bar {loss_bar:.2e}); "
        f"updates relative L2 {r['updates_rel_l2']:.2e} (control "
        f"{r['control_updates_rel_l2']:.2e}); of {len(pair)} tensors {how['cosine']} at cosine "
        f">= 0.9999, {how['within_control']} within the control, {how['noise_floor']} at the "
        f"noise floor, {len(failing)} failing; least cosines {worst}; CPU step "
        f"{r['cpu_step_s']:.1f} s")

    # 3 profiled stage-4 steps (batch 16) from the stage-4 weights
    prof_out = "not measured"
    if DEVICE == "cuda":
        net, state, step = _whisper_step_net(cfg1, os.path.join(exp1, "avg_model.pt"), DEVICE)
        batch = {k: torch.from_numpy(v).to(DEVICE)
                 for k, v in _whisper_batch(cfg1, data, 16, 12).items() if k != "keys"}
        for _ in range(2):
            step(state, batch)
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for _ in range(3):
                step(state, batch)
            sync()
            wall_us = (time.perf_counter() - t1) * 1e6
        prof_out = grouped_profile(prof, wall_us, {"K2 flash_fwd": ("flash_fwd",),
                                                   "K2 flash_bwd": ("flash_bwd",),
                                                   **PROFILE_GROUPS})
        prof_out["window"] = ("3 float32 stage-4 steps, batch 16 x 5 s, Whisper-large-v2 "
                              f"unfrozen + PMFA, {3 * WHISPER_SPEAKERS} classes")
        del net, state, step, batch, prof
        empty_cache()
        if prof_out["device_ms"]:
            log(f"[whisper profile] 3 f32 stage-4 steps: device {prof_out['device_ms']:.2f} ms "
                f"over {prof_out['wall_ms']:.2f} ms wall (idle share "
                f"{prof_out['device_idle_share']:.4f}); shares " + ", ".join(
                    f"{g} {v:.3f}" for g, v in prof_out["shares"].items()))
            for g in ("K2 flash_fwd", "K2 flash_bwd", "GEMM", "elementwise"):
                log(f"[whisper profile]   {g}: " + "; ".join(prof_out["group_top"][g][:3]))
        else:
            log("[whisper profile] torch.profiler reported no device time: not measured")
    out["profile"] = prof_out

    check(sorted(done) == list(range(2, 8)), f"whisper: stages {sorted(done)}")
    check([n for n, _ in step_calls[3]] == [1] * WHISPER_STEPS[3]
          and [n for n, _ in step_calls[4]] == [1] * WHISPER_STEPS[4],
          f"whisper: step calls {step_calls}")
    n = wcfg.n_layer  # K2 launches once per block and batch
    want = {3: {"fwd": n * WHISPER_STEPS[3], "dkv": 0, "dq": 0},
            4: {k: n * WHISPER_STEPS[4] for k in ("fwd", "dkv", "dq")},
            7: {"fwd": n * counter.batches, "dkv": 0, "dq": 0}}
    check(launches == want and counter.batches > 0,
          f"whisper: K2 launches {launches}, want {want}")
    check(all(math.isfinite(x) for s in losses for x in losses[s])
          and [len(losses[s]) for s in (3, 4)] == [WHISPER_STEPS[3], WHISPER_STEPS[4]],
          f"whisper: losses {losses}")
    check(not changed, f"whisper: stage 3 changed frozen encoder tensors {changed[:4]}")
    check(len(cos) == WHISPER_CPU_UTTS and min(cos) >= COS_MIN["f32"],
          f"whisper: stage-5 embeddings against the CPU, cosines {cos}")
    check(r["loss_rel"] <= loss_bar and r["cpu_vs_float64_rel"] <= loss_bar
          and r["card_vs_float64_rel"] <= loss_bar and not failing,
          "whisper: the stage-4 step on the card against the CPU")
    for s in (6, 7):
        check(len(done[s]["lines"]) == 1 and " EER " in done[s]["lines"][0],
              f"whisper: stage {s} printed {done[s]['lines']}")
    return launches


# ------------------------------------------- self-supervised training
SSL_CONF = Path(__file__).resolve().parent / "examples"
DINO_MODEL = "ECAPA_TDNN_GLOB_c1024"  # the fine-tune's model: it takes the teacher whole
DINO_EPOCHS, DINO_EPOCH_ITER = 2, 4  # epoch 1 inside the last layer's freeze, epoch 2 not
DINO_BATCH, DINO_OUT = 64, 65536
DINO_SEED = 20251025
DINO_EMA_STEP = 1  # the step whose teacher EMA and centre are checked (lr > 0 from step 1)
DINO_CHECK_BATCH = 2
DINO_BENCH_MODEL = "ECAPA_TDNN_c512"  # bench.py's DINO_ECAPA_c512_train_step row
SSL_TIMED_STEPS = 3
CONTRASTIVE_STEPS = 2  # steps per epoch, 2 epochs
CONTRASTIVE_CHECK_BATCH = 4
CONTRASTIVE_SEED = 20251026
CNCELEB_SPEAKERS = 2800  # CN-Celeb1 dev + CN-Celeb2: the head has 3 x 2,800 classes
CNCELEB_TRIALS = ("CNC-Eval-Concat.lst", "CNC-Eval-Avg.lst")
CONTRASTIVE_EXTRA = []  # more overrides of the v3 configs, for a CPU rehearsal
CNCELEB_EXTRA = []  # more overrides of the fine-tune config, for a CPU rehearsal


class _SSLStepSpy:
    """Wraps an SSL step maker of a bin module (`name` in `module`) for a
    run: each step call is timed with a device synchronize after it and its
    scalar metrics kept; `before(state, args)` and `after(state, args,
    metrics, seen)` see the state around it.  The synchronize and the hooks'
    copies are the only changes to the run."""

    def __init__(self, module, name, before=None, after=None):
        self.module, self.name, self.before, self.after = module, name, before, after
        self.make, self.times, self.metrics = getattr(module, name), [], []

    def __enter__(self):
        def timed_make(*args, **kwargs):
            fn = self.make(*args, **kwargs)

            def step(state, *step_args):
                seen = self.before(state, step_args) if self.before else None
                t0 = time.perf_counter()
                out = fn(state, *step_args)
                sync()
                self.times.append(time.perf_counter() - t0)
                self.metrics.append({k: float(v) if not torch.is_tensor(v) or v.numel() == 1
                                     else None for k, v in out.items()})
                if self.after:
                    self.after(state, step_args, out, seen)
                return out
            return step
        setattr(self.module, self.name, timed_make)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.make)


def _f32_spacing(*terms):
    """Two float32 spacings of sum |terms| elementwise: the rounding of a
    short chain of float32 operations on them (the float32 constants
    included)."""
    total = sum(t.abs() for t in terms)
    return 2.0 * torch.finfo(torch.float32).eps * total


def _dino_schedules():
    """examples/voxceleb/v3/dino/run.py's schedules at the phase's length,
    written out from its constants."""
    from wespeaker_hubert_tpu_torch.ssl import cosine_schedule

    total = DINO_EPOCHS * DINO_EPOCH_ITER
    return {"lr": cosine_schedule(0.2 * DINO_BATCH / 256, 1e-5, total,
                                  warmup_steps=10 * DINO_EPOCH_ITER),
            "wd": cosine_schedule(1e-4, 1e-4, total),
            "teacher_momentum": cosine_schedule(0.996, 1.0, total),
            "teacher_temp": cosine_schedule(0.04, 0.07, int(total * 0.2))}


def _dino_net(device, model=DINO_MODEL, seed=DINO_SEED):
    """Full-width DINONet (80 mels, 192-d, the 65,536-way head of 2,048 /
    256) with seeded weights (g of the weight-normed layer at 1), on
    `device`."""
    from wespeaker_hubert_tpu_torch.models.registry import get_speaker_model
    from wespeaker_hubert_tpu_torch.ssl import DINOHead, DINONet

    torch.manual_seed(0)
    net = DINONet(get_speaker_model(model)(feat_dim=80, embed_dim=192),
                  DINOHead(192, DINO_OUT))
    sd = seeded_state_dict(net, seed)
    sd["head.last_layer.weight_g"] = torch.ones_like(sd["head.last_layer.weight_g"])
    net.load_state_dict(sd)
    return net.to(device)


def _dino_crops(seed, batch, n_global=2, n_local=4):
    """Seeded (B, 2, 200, 80) global and (B, 4, 100, 80) local features
    with per-utterance scales and offsets (host tensors)."""
    rng = np.random.default_rng(seed)

    def feats(n, t):
        return torch.from_numpy((rng.standard_normal((batch, n, t, 80))
                                 * rng.uniform(0.5, 2.0, (batch, 1, 1, 80))
                                 + rng.normal(0.0, 1.0, (batch, 1, 1, 80))).astype(np.float32))
    return {"global_feat": feats(n_global, 200), "local_feat": feats(n_local, 100)}


def _state_tables(before, after):
    """{name: after - before} over float tensors, and {name: max |before|}."""
    upd = {k: after[k].double() - before[k].double() for k in before
           if before[k].is_floating_point()}
    mag = {k: float(before[k].abs().max()) for k in upd}
    return upd, mag


def _flat_state(prefix, module):
    return {f"{prefix}.{k}": v.detach().float().cpu().clone()
            for k, v in module.state_dict().items() if v.is_floating_point()}


def _against_control(tag, runs, loss_bar, bar=0.9999):
    """runs: {"card", "cpu", "control"} -> (loss, before, after); the
    card's changes against the CPU's by _update_agreement, the control the
    card on inputs scaled by 1 + 2^-20.  Returns (report entry, failing)."""
    changes = {}
    for k, (loss, before, after) in runs.items():
        changes[k] = _state_tables(before, after)
    pair = _diff_table(changes["card"][0], changes["cpu"][0])
    control = _diff_table(changes["control"][0], changes["card"][0])
    failing, how = _update_agreement(pair, control, bar, changes["cpu"][1])
    loss_rel = abs(runs["card"][0] - runs["cpu"][0]) / abs(runs["cpu"][0])
    worst = sorted(pair.items(), key=lambda kv: kv[1][0])[:4]
    out = {"loss": [runs["card"][0], runs["cpu"][0]], "loss_rel": loss_rel, "loss_bar": loss_bar,
           "updates_rel_l2": _rel_l2(changes["card"][0], changes["cpu"][0]),
           "control_updates_rel_l2": _rel_l2(changes["control"][0], changes["card"][0]),
           "n_tensors": len(pair), "passed_by": how, "worst": worst, "failing": failing}
    log(f"[{tag}] card vs CPU: loss {runs['card'][0]:.6f} vs {runs['cpu'][0]:.6f} (rel "
        f"{loss_rel:.2e}, bar {loss_bar:g}); changes relative L2 {out['updates_rel_l2']:.2e} "
        f"(control {out['control_updates_rel_l2']:.2e}); of {len(pair)} tensors {how['cosine']} at "
        f"cosine >= {bar}, {how['within_control']} within the control, {how['noise_floor']} at "
        f"the noise floor, {len(failing)} failing; least cosines {worst}")
    return out, (loss_rel > loss_bar) or bool(failing)


def dino_step_vs_cpu():
    """One float32 DINO step of the recipe's model and head at full width
    (ECAPA_TDNN_GLOB_c1024, 65,536-way head), batch DINO_CHECK_BATCH x (2
    x 200 + 4 x 100 frames), features handed in, at step DINO_EPOCH_ITER
    (the first after the freeze) of the recipe's schedules, on the card
    against the CPU: the loss within 1e-4 relative; the student's change
    (parameters and statistics), the teacher's and the centre's under
    step_vs_cpu's rules (_update_agreement against the card on the
    features times 1 + 2^-20)."""
    from wespeaker_hubert_tpu_torch.ssl import create_dino_state, make_dino_train_step

    sched = _dino_schedules()
    crops = _dino_crops(DINO_SEED + 1, DINO_CHECK_BATCH)
    center = torch.from_numpy(np.random.default_rng(DINO_SEED + 2).normal(
        0.0, 0.1, (1, DINO_OUT)).astype(np.float32))

    def run(dev, perturbed):
        scale = 1.0 + CONTROL_EPS if perturbed else 1.0
        state = create_dino_state(_dino_net(dev), DINO_OUT)
        state.center.copy_(center)
        state.step = DINO_EPOCH_ITER
        step = make_dino_train_step(sched["lr"], sched["wd"], sched["teacher_momentum"],
                                    sched["teacher_temp"], freeze_last_layer_steps=DINO_EPOCH_ITER)
        before = {**_flat_state("student", state.student), **_flat_state("teacher", state.teacher),
                  "center": state.center.detach().float().cpu().clone()}
        out = step(state, {k: (v * scale).to(dev) for k, v in crops.items()})
        after = {**_flat_state("student", state.student), **_flat_state("teacher", state.teacher),
                 "center": state.center.detach().float().cpu().clone()}
        return float(out["loss"]), before, after

    runs = beside_cpu(run)
    empty_cache()
    return _against_control("dino step", runs, 1e-4)


def dino_bench_row(dtype):
    """bench.py's DINO_ECAPA_c512_train_step row on the port: ECAPA_TDNN_c512
    + the 65,536-way head, batch 64 x (2 x 2 s + 4 x 1 s) random crops with
    reverb / noise rows, dithered fbank on the device, SGD; one warm step,
    then SSL_TIMED_STEPS timed (each with a synchronize): ms per step and
    crop audio-s/s (bench_all.py:bench_dino_step's count)."""
    from wespeaker_hubert_tpu_torch.bin.train_dino import make_dino_preprocess, ssl_feature_cfg
    from wespeaker_hubert_tpu_torch.data.dataset import chunk_samples_for_frames
    from wespeaker_hubert_tpu_torch.ssl import create_dino_state, make_dino_train_step

    rng = np.random.default_rng(0)
    batch = {}
    for prefix, n, length in (("global", 2, chunk_samples_for_frames(200)),
                              ("local", 4, chunk_samples_for_frames(100))):
        b = DINO_BATCH
        batch[f"{prefix}_wav"] = rng.standard_normal((b, n, length)) * 0.1
        batch[f"{prefix}_rir"] = rng.standard_normal((b, n, 8000))
        batch[f"{prefix}_noise"] = rng.standard_normal((b, n, length)) * 0.05
        batch[f"{prefix}_aug_type"] = rng.integers(0, 3, (b, n)).astype(np.int32)
        batch[f"{prefix}_snr"] = np.full((b, n), 10.0)
    batch = {k: torch.from_numpy(v.astype(np.float32) if v.dtype == np.float64 else v).to(DEVICE)
             for k, v in batch.items()}
    state = create_dino_state(_dino_net(DEVICE, DINO_BENCH_MODEL), DINO_OUT)
    total = 150 * 1000
    from wespeaker_hubert_tpu_torch.ssl import cosine_schedule

    step = make_dino_train_step(
        cosine_schedule(0.2 * DINO_BATCH / 256.0, 1e-5, total), cosine_schedule(1e-4, 1e-4, total),
        cosine_schedule(0.996, 1.0, total), cosine_schedule(0.04, 0.07, total // 5),
        preprocess_fn=make_dino_preprocess(ssl_feature_cfg({})), compute_dtype=dtype)
    gen = torch.Generator(DEVICE).manual_seed(1)
    step(state, batch, gen)
    sync()
    times = []
    for _ in range(SSL_TIMED_STEPS):
        t0 = time.perf_counter()
        step(state, batch, gen)
        sync()
        times.append(time.perf_counter() - t0)
    ms = 1e3 * statistics.median(times)
    name = "bf16" if dtype else "f32"
    prof = profile_steps(lambda: step(state, batch, gen),
                         f"3 {name} DINO steps at bench.py's row ({DINO_BENCH_MODEL}, batch "
                         f"{DINO_BATCH})", warm=0)
    del state, step, batch
    empty_cache()
    return {"step_ms": ms, "step_ms_each": [1e3 * t for t in times],
            "crop_audio_s_per_s": DINO_BATCH * (2 * 2.0 + 4 * 1.0) / (ms / 1e3),
            "dtype": name, "model": DINO_BENCH_MODEL, "profile": prof}


def profile_steps(call, window, warm=2, n=SSL_TIMED_STEPS):
    """`n` calls of `call` under torch.profiler after `warm` warm calls:
    device time, idle share and PROFILE_GROUPS' shares."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        call()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    out = grouped_profile(prof, wall_us, PROFILE_GROUPS)
    out["window"] = window
    return out


def _log_profile(tag, prof):
    if prof["device_ms"]:
        log(f"[{tag}] {prof['window']}: device {prof['device_ms']:.2f} ms over {prof['wall_ms']:.2f}"
            f" ms wall (idle share {prof['device_idle_share']:.4f}); shares "
            + ", ".join(f"{g} {v:.3f}" for g, v in prof["shares"].items()))
        for g in ("conv", "GEMM", "elementwise"):
            log(f"[{tag}]   {g}: " + "; ".join(prof["group_top"][g][:3]))
    else:
        log(f"[{tag}] torch.profiler reported no device time: not measured")


def _ssl_batch(pipe, device):
    from wespeaker_hubert_tpu_torch.bin.train import _to_device

    return _to_device(next(iter(pipe)), torch.device(device))


def phase_dino_recipe(report, root):
    """recipes.voxceleb_v3_dino on the card at full width: --model
    ECAPA_TDNN_GLOB_c1024 (what the CN-Celeb fine-tune takes whole), embed
    192, batch 64 of 2 x 200 + 4 x 100-frame crops, the 65,536-way head of
    2,048 / 256, SGD, float32, aug_prob 0.6 with both of phase_recipe's aug
    stores, 2 epochs of 4 steps (epoch 1 inside the last layer's freeze) on
    phase_recipe's 1,536 utterances.  Checks: finite losses; lr, wd, the
    teacher momentum and temperature equal to run.py's cosine schedules at
    each step; inside the freeze the last layer moves by exactly -lr (wd p
    + 0.9 m) and its momentum becomes wd p + 0.9 m; after step
    DINO_EMA_STEP the teacher equals m t + (1 - m) s and the centre its
    EMA; each epoch checkpoint loads into bin/extract's net (nothing
    missing) and into the fine-tune's (only `projection.*` missing); one
    step card against CPU (dino_step_vs_cpu).  Timings: the run's steps,
    its peak memory, 3 profiled steps and bench.py's DINO row in bf16 and
    float32.  Returns the report entry."""
    from wespeaker_hubert_tpu_torch.bin import train_dino as bin_train_dino
    from wespeaker_hubert_tpu_torch.models.speaker_net import (
        build_speaker_net,
        load_speaker_state,
    )
    from wespeaker_hubert_tpu_torch.recipes import voxceleb_v3_dino
    from wespeaker_hubert_tpu_torch.utils.checkpoint import load_partial
    from wespeaker_hubert_tpu_torch.utils.config import load_config

    data, exp = os.path.join(root, "data"), os.path.join(root, "exp_dino")
    argv = ["--train_data", f"{data}/vox2_dev/raw.list", "--exp_dir", exp, "--model", DINO_MODEL,
            "--num_epochs", str(DINO_EPOCHS), "--epoch_iter", str(DINO_EPOCH_ITER),
            "--batch_size", str(DINO_BATCH), "--out_dim", str(DINO_OUT),
            "--noise_store", f"{data}/musan_aug_store", "--reverb_store", f"{data}/rirs_aug_store",
            "--device", DEVICE]
    out = report["dino_recipe"] = {"argv": argv}
    freeze, ema = [], {}

    def before(state, args):
        v = state.student.head.last_layer.weight_v
        seen = {"step": state.step, "v": v.detach().clone(),
                "m": state.optimizer.state.get(v, {}).get("momentum_buffer")}
        seen["m"] = seen["m"].clone() if seen["m"] is not None else torch.zeros_like(v)
        if state.step == DINO_EMA_STEP:
            seen["teacher"] = {k: p.detach().clone() for k, p in state.teacher.named_parameters()}
            seen["center"] = state.center.detach().clone()
        return seen

    def after(state, args, metrics, seen):
        v = state.student.head.last_layer.weight_v.detach()
        if seen["step"] < DINO_EPOCH_ITER:  # the freeze: -lr (wd p + 0.9 m)
            lr, wd = metrics["lr"], metrics["wd"]
            p, m = seen["v"].double(), seen["m"].double()
            m_new = wd * p + 0.9 * m
            want = p - lr * m_new
            tol = _f32_spacing(p, lr * m_new)
            buf = state.optimizer.state[state.student.head.last_layer.weight_v][
                "momentum_buffer"].double()
            freeze.append({"step": seen["step"], "lr": lr,
                           "moved_max": float((v.double() - p).abs().max()),
                           "err_max": float((v.double() - want).abs().max()),
                           "within": bool(((v.double() - want).abs() <= tol).all()),
                           "momentum_within": bool(((buf - m_new).abs()
                                                    <= _f32_spacing(wd * p, 0.9 * m)).all())})
        if seen["step"] == DINO_EMA_STEP:
            m = metrics["teacher_momentum"]
            worst, ok = 0.0, True
            s_params = dict(state.student.named_parameters())
            for k, p in state.teacher.named_parameters():
                if k not in s_params or not s_params[k].requires_grad:
                    continue
                t0, s1 = seen["teacher"][k].double(), s_params[k].detach().double()
                want = m * t0 + (1.0 - m) * s1
                d = (p.detach().double() - want).abs()
                ok &= bool((d <= _f32_spacing(m * t0, (1.0 - m) * s1)).all())
                worst = max(worst, float(d.max()))
            c0, bc = seen["center"].double(), metrics["batch_center"].double()
            want_c = 0.9 * c0 + 0.1 * bc
            dc = (state.center.double() - want_c).abs()
            ema.update({"step": seen["step"], "m": m, "teacher_max_abs_err": worst,
                        "teacher_within": ok, "center_max_abs_err": float(dc.max()),
                        "center_within": bool((dc <= _f32_spacing(0.9 * c0, 0.1 * bc)).all())})

    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _SSLStepSpy(bin_train_dino, "make_dino_train_step", before, after) as spy:
        state = voxceleb_v3_dino.main(argv)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda" else "not measured"
    sched = _dino_schedules()
    metrics = spy.metrics
    sched_err = max(abs(m[k] - sched[k](i)) for i, m in enumerate(metrics)
                    for k in ("lr", "wd", "teacher_momentum", "teacher_temp"))
    step_ms = [1e3 * t for t in spy.times]
    after_first = statistics.median(step_ms[1:]) if len(step_ms) > 1 else step_ms[0]
    out.update({"steps": state.step, "wall_s": wall, "loss": [m["loss"] for m in metrics],
                "lr": [m["lr"] for m in metrics],
                "teacher_momentum": [m["teacher_momentum"] for m in metrics],
                "teacher_temp": [m["teacher_temp"] for m in metrics],
                "schedule_max_abs_err": sched_err, "freeze": freeze, "ema": ema,
                "step_ms": step_ms, "step_ms_median_after_first": after_first,
                "crop_audio_s_per_s": DINO_BATCH * 8.0 / (after_first / 1e3),
                "peak_mem_gb": peak})
    log(f"[dino] recipes.voxceleb_v3_dino: {state.step} steps of {DINO_BATCH} x (2 x 2 s + 4 x 1 s) "
        f"crops, {DINO_MODEL} + {DINO_OUT}-way head, float32, {wall:.1f} s; losses "
        + ", ".join(f"{x:.4f}" for x in out["loss"]) + f"; schedules max|d| {sched_err:.1e}; step ms "
        + ", ".join(f"{x:.1f}" for x in step_ms) + f" (median after the first {after_first:.2f} = "
        f"{out['crop_audio_s_per_s']:.0f} crop audio-s/s); peak memory "
        + (f"{peak:.2f} GB" if DEVICE == "cuda" else "not measured"))
    log("[dino] the freeze: " + "; ".join(
        f"step {f['step']} lr {f['lr']:.2e} moved {f['moved_max']:.2e}, off -lr (wd p + 0.9 m) by "
        f"{f['err_max']:.1e} ({'within' if f['within'] else 'PAST'} 2 float32 spacings), momentum "
        f"{'within' if f['momentum_within'] else 'PAST'}" for f in freeze))
    log(f"[dino] step {ema.get('step')}: teacher vs m t + (1 - m) s max|d| "
        f"{ema.get('teacher_max_abs_err', float('nan')):.1e} (within 2 spacings: "
        f"{ema.get('teacher_within')}), centre vs its EMA {ema.get('center_max_abs_err', float('nan')):.1e}"
        f" (within: {ema.get('center_within')})")

    # the epoch checkpoints: bin/extract's net, and the fine-tune's (only its head missing)
    ft_config = load_config(str(SSL_CONF / "cnceleb/v3_finetune/conf/ecapa_tdnn_ft.yaml"))
    loads = {}
    for epoch in range(1, DINO_EPOCHS + 1):
        ckpt = os.path.join(exp, "models", f"model_{epoch}.pt")
        extract_net = build_speaker_net(ft_config)
        got = load_speaker_state(extract_net, torch.load(ckpt, weights_only=True))
        ft_net = build_speaker_net(ft_config, 3 * CNCELEB_SPEAKERS)
        loads[epoch] = {"extract": got, "finetune": load_partial(ckpt, ft_net, DINO_MODEL)}
        del extract_net, ft_net
    out["checkpoint_loads"] = loads
    log(f"[dino] epoch checkpoints: " + "; ".join(
        f"model_{e}.pt into bin/extract's net missing {v['extract'][0]} unexpected {v['extract'][1]},"
        f" into the fine-tune's missing {v['finetune'][0]} unexpected {v['finetune'][1]}"
        for e, v in loads.items()))

    # 3 profiled steps of the run's state on one of its batches
    from wespeaker_hubert_tpu_torch.bin.train_dino import (
        _stores,
        make_dino_preprocess,
        ssl_feature_cfg,
    )
    from wespeaker_hubert_tpu_torch.data.dataset import load_data_list
    from wespeaker_hubert_tpu_torch.ssl import SSLPipeline, make_dino_train_step

    cfg = voxceleb_v3_dino.dino_config(voxceleb_v3_dino.parse_args(argv))
    rev, noise = _stores(cfg["dataset_args"])
    batch_size = cfg["dataloader_args"]["batch_size"]
    batch = _ssl_batch(SSLPipeline(load_data_list(cfg["train_data"]), batch_size=batch_size,
                                   reverb_store=rev, noise_store=noise, seed=7), DEVICE)
    step = make_dino_train_step(sched["lr"], sched["wd"], sched["teacher_momentum"],
                                sched["teacher_temp"], freeze_last_layer_steps=DINO_EPOCH_ITER,
                                preprocess_fn=make_dino_preprocess(
                                    ssl_feature_cfg(cfg["dataset_args"])))
    gen = torch.Generator(DEVICE).manual_seed(5)
    out["profile"] = profile_steps(
        lambda: step(state, batch, gen),
        f"3 float32 DINO steps, batch {batch_size} x (2 x 200 + 4 x 100 frames), {cfg['model']}, "
        f"{cfg['dino_args']['out_dim']}-way head, aug and fbank on the device")
    _log_profile("dino profile", out["profile"])
    del state, step, batch
    empty_cache()
    out["step_vs_cpu"], step_bad = dino_step_vs_cpu()
    out["bench_row"] = {name: dino_bench_row(dtype) for name, dtype in
                        (("bf16", torch.bfloat16), ("f32", None))} if DEVICE == "cuda" else {}
    for name, r in out["bench_row"].items():
        log(f"[dino bench] bench.py's DINO_ECAPA_c512_train_step row on the port, {name}: "
            f"{r['step_ms']:.2f} ms per step (" + ", ".join(f"{x:.1f}" for x in r["step_ms_each"])
            + f"), {r['crop_audio_s_per_s']:.0f} crop audio-s/s")
        _log_profile(f"dino bench {name}", r["profile"])

    n_steps = DINO_EPOCHS * DINO_EPOCH_ITER
    check(out["steps"] == n_steps, f"dino: {out['steps']} steps, want {n_steps}")
    check(all(math.isfinite(x) for x in out["loss"]), f"dino: losses {out['loss']}")
    check(sched_err == 0.0, f"dino: the schedules are off cosine_schedule by {sched_err}")
    check(len(freeze) == DINO_EPOCH_ITER and all(f["within"] and f["momentum_within"]
                                                  for f in freeze),
          f"dino: inside the freeze the last layer moved otherwise than -lr (wd p + 0.9 m): {freeze}")
    check(ema.get("teacher_within") and ema.get("center_within"),
          f"dino: the teacher or the centre is off its EMA: {ema}")
    check(all(v["extract"] == ([], []) and v["finetune"] == (["projection.weight"], [])
              for v in loads.values()), f"dino: checkpoint loads {loads}")
    check(not step_bad, "dino: the card's step against the CPU's")
    return out


def _moco_key_check(rows):
    """Hooks for MoCo's step: the pointer before and after, and the rows the
    step wrote against the key encoder's embeddings of the step's key batch
    (recomputed on a copy, so no statistic moves)."""
    from wespeaker_hubert_tpu_torch.ssl.contrastive import _embed

    def before(state, args):
        return state.queue_ptr

    def after(state, args, metrics, ptr):
        b = args[0]["key_feat"].shape[0]
        enc = copy.deepcopy(state.encoder_k).train()
        with torch.no_grad():
            want = _embed(enc, args[0]["key_feat"], None)
        got = state.queue[ptr:ptr + b]
        rows.append({"ptr_before": ptr, "ptr_after": state.queue_ptr,
                     "max_abs_err": float((got - want).abs().max())})
        del enc
    return before, after


def contrastive_step_vs_cpu(method):
    """One float32 step of the method at the config's model
    (ECAPA_TDNN_GLOB_c512, 80 mels, 192-d, seeded) at batch
    CONTRASTIVE_CHECK_BATCH x 2 views x 200 frames, features handed in,
    MoCo with its full 65,536-row queue, on the card against the CPU: loss
    within 1e-5 relative, every changed tensor (the query encoder; for MoCo
    also the key encoder and the queue) under step_vs_cpu's rules."""
    from wespeaker_hubert_tpu_torch.bin.train_contrastive import _Encoder
    from wespeaker_hubert_tpu_torch.models.registry import get_speaker_model
    from wespeaker_hubert_tpu_torch.ssl import (
        create_moco_state,
        create_simclr_state,
        make_moco_train_step,
        make_simclr_train_step,
    )

    rng = np.random.default_rng(CONTRASTIVE_SEED)
    b = CONTRASTIVE_CHECK_BATCH
    views = {k: torch.from_numpy((rng.standard_normal((b, 200, 80))
                                  * rng.uniform(0.5, 2.0, (b, 1, 80))
                                  + rng.normal(0.0, 1.0, (b, 1, 80))).astype(np.float32))
             for k in ("query_feat", "key_feat")}

    def run(dev, perturbed):
        scale = 1.0 + CONTROL_EPS if perturbed else 1.0
        enc = _Encoder(get_speaker_model("ECAPA_TDNN_GLOB_c512")(feat_dim=80, embed_dim=192))
        enc.load_state_dict(seeded_state_dict(enc, CONTRASTIVE_SEED))
        enc.to(dev)
        if method == "moco":
            state = create_moco_state(enc, 192, K=65536, lr=0.05,
                                      generator=torch.Generator().manual_seed(1))
            step = make_moco_train_step(m=0.999, T=0.07)
            nets = {"q": state.encoder_q, "k": state.encoder_k}
        else:
            state = create_simclr_state(enc, lr=0.05)
            step = make_simclr_train_step(T=0.07)
            nets = {"q": state.encoder}

        def snap():
            s = {}
            for name, net in nets.items():
                s.update(_flat_state(name, net))
            if method == "moco":
                s["queue_rows"] = state.queue[:b].detach().float().cpu().clone()
            return s

        before = snap()
        out = step(state, {k: (v * scale).to(dev) for k, v in views.items()})
        return float(out["loss"]), before, snap()

    runs = beside_cpu(run)
    empty_cache()
    return _against_control(f"{method} step", runs, 1e-5)


def _contrastive_profile(method, config, exp):
    """3 profiled float32 steps (features from the crops on the device
    included) of the method at its config, from the run's averaged encoder,
    on one SSLPipeline batch of the run's data."""
    from wespeaker_hubert_tpu_torch.bin.train_contrastive import _Encoder
    from wespeaker_hubert_tpu_torch.bin.train_dino import _stores, crops_to_features, ssl_feature_cfg
    from wespeaker_hubert_tpu_torch.data.dataset import load_data_list
    from wespeaker_hubert_tpu_torch.models.registry import get_speaker_model
    from wespeaker_hubert_tpu_torch.ssl import (
        SSLPipeline,
        create_moco_state,
        create_simclr_state,
        make_moco_train_step,
        make_simclr_train_step,
    )

    da = config["dataset_args"]
    batch_size = config["dataloader_args"]["batch_size"]
    lr = config["scheduler_args"]["initial_lr"]
    enc = _Encoder(get_speaker_model(config["model"])(**config["model_args"]))
    enc.backbone.load_state_dict(torch.load(os.path.join(exp, "avg_model.pt"), weights_only=True))
    enc.to(DEVICE)
    if method == "moco":
        state = create_moco_state(enc, config["model_args"]["embed_dim"],
                                  K=config["moco_args"]["K"], lr=lr,
                                  generator=torch.Generator().manual_seed(1))
        step = make_moco_train_step(m=config["moco_args"]["m"], T=config["moco_args"]["T"])
    else:
        state = create_simclr_state(enc, lr=lr)
        step = make_simclr_train_step(T=config["simclr_args"]["T"])
    rev, noise = _stores(da)
    batch = _ssl_batch(SSLPipeline(load_data_list(config["train_data"]),
                                   global_frames=da["chunk_len"], global_num=2, local_num=0,
                                   batch_size=batch_size, aug_prob=da["aug_prob"],
                                   reverb_store=rev, noise_store=noise, seed=7), DEVICE)
    fcfg = ssl_feature_cfg(da)
    gen = torch.Generator(DEVICE).manual_seed(5)

    def call():
        feats = crops_to_features(batch, "global", fcfg, gen)
        step(state, {"query_feat": feats[:, 0], "key_feat": feats[:, 1]})

    prof = profile_steps(call, f"3 float32 {method} steps, batch {batch_size} x 2 views x "
                               f"{da['chunk_len']} frames, {config['model']}, aug and fbank on "
                               "the device")
    del state, step, batch, enc
    empty_cache()
    return prof


def phase_contrastive_recipe(report, root):
    """recipes.voxceleb_v3_contrastive stages 2-6 on the card for MoCo and
    SimCLR with examples/voxceleb/v3/{moco,simclr}/conf/ecapa_tdnn.yaml as
    the port's reader parses them (ECAPA_TDNN_GLOB_c512, batch 128 x 2
    views x 200 frames, aug_prob 1.0, K 65,536, m 0.999, T 0.07, SGD 0.05),
    overriding only the paths, num_epochs 2, epoch_iter CONTRASTIVE_STEPS,
    save_epoch_interval 1 and num_avg 2, on phase_recipe's data.  Stages
    2-3, then 4-6, each with K1's count set to 0 just before and read just
    after.  Checks: MoCo's pointer after each step is steps x 128 mod 65,536
    and the rows written equal that step's key embeddings; K1 on every
    stage-4 input of the MoCo run against its plain version, SimCLR's the
    same inputs; 16 embeddings and the score files against the CPU; one
    step of each method card against CPU; 3 profiled steps of each.
    Returns the K1 launches of each stage 4."""
    from wespeaker_hubert_tpu_torch.bin import train_contrastive as bin_tc
    from wespeaker_hubert_tpu_torch.ops import fbank_kernel
    from wespeaker_hubert_tpu_torch.recipes import voxceleb_v3_contrastive

    data = os.path.join(root, "data")
    trials = os.path.join(data, "vox1", "vox1_O_cleaned.kaldi")
    out = report["contrastive_recipe"] = {}
    launches, inputs = {}, {}
    for method in ("moco", "simclr"):
        exp = os.path.join(root, f"exp_{method}")
        config_path = SSL_CONF / "voxceleb/v3" / method / "conf/ecapa_tdnn.yaml"
        overrides = [f"exp_dir={exp}", f"train_data={data}/vox2_dev/raw.list",
                     f"dataset_args.reverb_data={data}/rirs_aug_store",
                     f"dataset_args.noise_data={data}/musan_aug_store", "num_epochs=2",
                     f"epoch_iter={CONTRASTIVE_STEPS}", "save_epoch_interval=1",
                     "num_avg=2"] + CONTRASTIVE_EXTRA
        common = ["--method", method, "--config", str(config_path), "--data_root", data,
                  "--trials", trials, "--device", DEVICE] + overrides
        r = out[method] = {"overrides": overrides}
        rows = []
        hooks = _moco_key_check(rows) if method == "moco" else (None, None)
        name = "make_moco_train_step" if method == "moco" else "make_simclr_train_step"
        fbank_kernel.LAUNCHES = 0
        with _SSLStepSpy(bin_tc, name, *hooks) as spy:
            done = voxceleb_v3_contrastive.main(["--stage", "2", "--stop_stage", "3"] + common)
        k1_train = fbank_kernel.LAUNCHES
        fbank_kernel.LAUNCHES = 0
        with _K1Spy(fbank_kernel) as k1_spy:
            done.update(voxceleb_v3_contrastive.main(["--stage", "4", "--stop_stage", "6"] + common))
        launches[method] = fbank_kernel.LAUNCHES
        inputs[method] = k1_spy.inputs
        config = voxceleb_v3_contrastive.load_method_config(
            voxceleb_v3_contrastive.parse_args(common))
        batch, k_total = config["dataloader_args"]["batch_size"], config.get("moco_args", {}).get("K")
        step_ms = [1e3 * t for t in spy.times]
        after_first = statistics.median(step_ms[1:])
        r.update({"stage_s": {s: d["s"] for s, d in done.items()},
                  "lines": {s: d["lines"] for s, d in done.items() if d["lines"]},
                  "loss": [m["loss"] for m in spy.metrics], "acc": [m["acc"] for m in spy.metrics],
                  "step_ms": step_ms, "step_ms_median_after_first": after_first,
                  "audio_s_per_s": batch * 2 * 2.0 / (after_first / 1e3),
                  "k1_launches_stage_2_3": k1_train, "k1_launches_stage_4_6": launches[method],
                  "queue": rows})
        log(f"[{method}] stages 2-6: " + ", ".join(f"{s} {d['s']:.1f} s" for s, d in done.items())
            + f"; {len(step_ms)} steps of {batch} x 2 views x 2 s, losses "
            + ", ".join(f"{x:.4f}" for x in r["loss"]) + f"; step ms " + ", ".join(
                f"{x:.1f}" for x in step_ms) + f" (median after the first {after_first:.2f} = "
            f"{r['audio_s_per_s']:.0f} view audio-s/s); K1 launches stages 2-3 {k1_train}, "
            f"stages 4-6 {launches[method]}")
        for s in (5, 6):
            log(f"[{method}] stage {s}: " + "; ".join(done[s]["lines"]))
        if rows:
            log(f"[moco] queue: pointers " + ", ".join(str(q["ptr_after"]) for q in rows)
                + f"; rows written vs the step's key embeddings max|d| "
                f"{max(q['max_abs_err'] for q in rows):.1e}")
        r["cpu_bad"] = recipe_against_cpu(data, exp, r, config_path, method)
        r["step_vs_cpu"], r["step_bad"] = contrastive_step_vs_cpu(method)
        r["profile"] = _contrastive_profile(method, config, exp)
        _log_profile(f"{method} profile", r["profile"])
        check(sorted(done) == [2, 3, 4, 5, 6], f"{method}: stages {sorted(done)}")
        check(len(step_ms) == 2 * CONTRASTIVE_STEPS
              and all(math.isfinite(x) for x in r["loss"]), f"{method}: losses {r['loss']}")
        check(k1_train == 0, f"{method}: the dithered train step launched K1 {k1_train} times")
        if method == "moco":
            check(len(rows) == 2 * CONTRASTIVE_STEPS and all(
                q["ptr_after"] == (i + 1) * batch % k_total and q["max_abs_err"] <= 1e-5
                for i, q in enumerate(rows)), f"moco: the queue {rows}")
        check(not r["cpu_bad"], f"{method}: " + "; ".join(r["cpu_bad"]))
        check(not r["step_bad"], f"{method}: the card's step against the CPU's")
        for s in (5, 6):
            check(len(done[s]["lines"]) == 1 and " EER " in done[s]["lines"][0],
                  f"{method}: stage {s} printed {done[s]['lines']}")
    # K1 on every stage-4 input: MoCo's against its plain version, SimCLR's the same batches
    k1_rows, k1_matched = k1_on_eval_batches(
        [os.path.join(data, d, "raw.list") for d in ("vox1", "vox2_dev")],
        inputs["moco"]) if DEVICE == "cuda" else ([], False)
    same = len(inputs["simclr"]) == len(inputs["moco"]) and all(
        torch.equal(a, b) for a, b in zip(inputs["simclr"], inputs["moco"]))
    out["k1_stage4_checks"] = k1_rows
    log(f"[contrastive] K1 on all {len(inputs['moco'])} of MoCo's stage-4 inputs against its plain "
        f"version (bar as [recipe]; inputs {'match' if k1_matched else 'DO NOT match'} "
        f"EvalPipeline's batches; SimCLR's {len(inputs['simclr'])} inputs "
        f"{'equal' if same else 'DIFFER from'} them): " + "; ".join(
            f"{tuple(r['shape'])} x{r['batches']}: {r['off_bar']} past the bar, valid max|d| "
            f"{r['valid']['max_abs_err']:.3e}" for r in k1_rows))
    del inputs
    check(launches["moco"] > 0 and k1_matched and same and launches["simclr"] == launches["moco"],
          f"contrastive: stage 4's K1 inputs do not match EvalPipeline's batches ({launches})")
    check(all(r["off_bar"] == 0 and r["finite"] for r in k1_rows),
          "contrastive: K1 disagrees with its plain version on a stage-4 input")
    return launches


def write_cnceleb_data(data):
    """phase_recipe's wavs laid out as CN-Celeb: `cnceleb_train` (vox2_dev's
    1,536 utterances, its utt2spk naming CNCELEB_SPEAKERS speakers, the
    rest without audio) and `eval` (vox1's 64), with the recipe's two trial
    files under `eval/trials/` (VoxCeleb1-O's pairs split between them)."""
    for src, dst in (("vox2_dev", "cnceleb_train"), ("vox1", "eval")):
        os.makedirs(os.path.join(data, dst, "trials"), exist_ok=True)
        Path(data, dst, "wav.scp").write_text(Path(data, src, "wav.scp").read_text())
        u2s = [ln for ln in Path(data, src, "utt2spk").read_text().splitlines()
               if "absent" not in ln]
        if dst == "cnceleb_train":
            spks = {ln.split()[1] for ln in u2s}
            u2s += [f"cnc{s:05d}-absent cnc{s:05d}" for s in range(CNCELEB_SPEAKERS - len(spks))]
        Path(data, dst, "utt2spk").write_text("\n".join(u2s) + "\n")
    trials = Path(data, "vox1", "vox1_O_cleaned.kaldi").read_text().splitlines()
    for i, name in enumerate(CNCELEB_TRIALS):
        Path(data, "eval", "trials", name).write_text("\n".join(trials[i::2]) + "\n")


def phase_cnceleb_finetune(report, root):
    """recipes.cnceleb_v3_finetune stages 2-6 on the card with
    examples/cnceleb/v3_finetune/conf/ecapa_tdnn_ft.yaml as the port's
    reader parses it (ECAPA_TDNN_GLOB_c1024, ASTP, ArcMargin over 3 x 2,800
    classes, batch 128 x 200 frames, speed perturbation, aug_prob 0.6, SGD
    Nesterov), `--model_init` the average of phase_dino_recipe's epoch
    checkpoints, overriding only the paths and the run's length (2 epochs
    of 4 steps), on write_cnceleb_data's layout.  Stages 2-3, then 4-6,
    each with K1's count set to 0 just before and read just after.
    Checks: load_partial reports only `projection.*` missing and nothing
    mismatched (bin/train's log line too); K1 on every stage-4 input
    against its plain version; 16 embeddings and both trial files' score
    files against the CPU.  Returns stage 4's K1 launches."""
    import logging

    from wespeaker_hubert_tpu_torch.bin import train as bin_train
    from wespeaker_hubert_tpu_torch.bin.average_model import average_model
    from wespeaker_hubert_tpu_torch.models.speaker_net import build_speaker_net
    from wespeaker_hubert_tpu_torch.ops import fbank_kernel
    from wespeaker_hubert_tpu_torch.recipes import cnceleb_v3_finetune
    from wespeaker_hubert_tpu_torch.utils.checkpoint import load_partial
    from wespeaker_hubert_tpu_torch.utils.config import apply_overrides, load_config

    data, exp = os.path.join(root, "data"), os.path.join(root, "exp_cnceleb")
    dino_exp = os.path.join(root, "exp_dino")
    write_cnceleb_data(data)
    avg = average_model(os.path.join(dino_exp, "models"), os.path.join(dino_exp, "avg_model.pt"),
                        num=DINO_EPOCHS)
    config_path = SSL_CONF / "cnceleb/v3_finetune/conf/ecapa_tdnn_ft.yaml"
    overrides = [f"exp_dir={exp}", f"train_data={data}/cnceleb_train/raw.list",
                 f"train_label={data}/cnceleb_train/utt2spk",
                 f"dataset_args.reverb_data={data}/rirs_aug_store",
                 f"dataset_args.noise_data={data}/musan_aug_store",
                 "num_epochs=2", f"epoch_iter={DINO_EPOCH_ITER}"] + CNCELEB_EXTRA
    common = ["--config", str(config_path), "--model_init", avg, "--data_root", data,
              "--device", DEVICE] + overrides
    out = report["cnceleb_finetune"] = {"overrides": overrides}
    config = apply_overrides(load_config(str(config_path)), overrides)
    net = build_speaker_net(config, 3 * CNCELEB_SPEAKERS)
    out["load_partial"] = load_partial(avg, net, config["model"])
    del net
    records = []
    handler = logging.Handler()
    handler.emit = lambda rec: records.append(rec.getMessage())
    logging.getLogger("train").addHandler(handler)
    timer = _StepTimer()
    make = bin_train.make_train_step
    bin_train.make_train_step = timer(make)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    try:
        fbank_kernel.LAUNCHES = 0
        t0 = time.perf_counter()
        done = cnceleb_v3_finetune.main(["--stage", "2", "--stop_stage", "3"] + common)
        train_s = time.perf_counter() - t0
        bin_train.make_train_step = make
        peak = torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda" else "not measured"
        k1_train = fbank_kernel.LAUNCHES
        fbank_kernel.LAUNCHES = 0
        with _K1Spy(fbank_kernel) as k1_spy:
            done.update(cnceleb_v3_finetune.main(["--stage", "4", "--stop_stage", "6"] + common))
        k1_extract = fbank_kernel.LAUNCHES
    finally:
        bin_train.make_train_step = make
        logging.getLogger("train").removeHandler(handler)
    init_lines = [r for r in records if r.startswith("model_init")]
    step_ms = [1e3 * t / n for n, t in timer.calls]
    after_first = statistics.median(step_ms[1:])
    batch = config["dataloader_args"]["batch_size"]
    out.update({"step_ms": step_ms, "step_ms_median_after_first": after_first,
                "audio_s_per_s": batch * config["dataset_args"]["num_frms"] / 100
                / (after_first / 1e3), "peak_mem_gb": peak, "margins": timer.margins})
    out.update({"stage_s": {s: d["s"] for s, d in done.items()},
                "lines": {s: d["lines"] for s, d in done.items() if d["lines"]},
                "model_init_log": init_lines, "k1_launches_stage_2_3": k1_train,
                "k1_launches_stage_4_6": k1_extract, "stage_2_3_s": train_s})
    log(f"[cnceleb] load_partial of the DINO average: missing {out['load_partial'][0]}, "
        f"unexpected or mismatched {out['load_partial'][1]}; bin/train: {init_lines}")
    log(f"[cnceleb] stages 2-6: " + ", ".join(f"{s} {d['s']:.1f} s" for s, d in done.items())
        + f"; {len(step_ms)} steps of {batch} x 2 s, step ms " + ", ".join(
            f"{x:.1f}" for x in step_ms) + f" (median after the first {after_first:.2f} = "
        f"{out['audio_s_per_s']:.0f} audio-s/s), peak memory "
        + (f"{peak:.2f} GB" if DEVICE == "cuda" else "not measured")
        + f"; K1 launches stages 2-3 {k1_train}, stages 4-6 {k1_extract}")
    for s in (5, 6):
        log(f"[cnceleb] stage {s}: " + "; ".join(done[s]["lines"]))
    trials = [os.path.join(data, "eval", "trials", t) for t in CNCELEB_TRIALS]
    with ThreadPoolExecutor(1) as pool:  # the CPU's checks beside K1's on the card
        cpu_run = pool.submit(recipe_against_cpu, data, exp, out, config_path, "cnceleb",
                              "eval", "cnceleb_train", trials)
        k1_rows, k1_matched = k1_on_eval_batches(
            [os.path.join(data, d, "raw.list") for d in ("eval", "cnceleb_train")],
            k1_spy.inputs) if DEVICE == "cuda" else ([], False)
        cpu_bad = cpu_run.result()
    n_caught = len(k1_spy.inputs)
    del k1_spy
    out["k1_stage4_checks"] = k1_rows
    log(f"[cnceleb] K1 on all {n_caught} stage-4 inputs against its plain version (bar as "
        f"[recipe]; inputs {'match' if k1_matched else 'DO NOT match'} EvalPipeline's batches): "
        + "; ".join(f"{tuple(r['shape'])} x{r['batches']}: {r['off_bar']} past the bar, valid "
                    f"max|d| {r['valid']['max_abs_err']:.3e}" for r in k1_rows))
    check(sorted(done) == [2, 3, 4, 5, 6], f"cnceleb: stages {sorted(done)}")
    check(out["load_partial"] == (["projection.weight"], []),
          f"cnceleb: load_partial of the DINO average {out['load_partial']}")
    check(init_lines == [f"model_init from {avg} (epoch 0, 1 missing, 0 unexpected)"],
          f"cnceleb: bin/train's initialization {init_lines}")
    check(k1_train == 0, f"cnceleb: the dithered train step launched K1 {k1_train} times")
    check(k1_extract > 0 and k1_matched and n_caught == k1_extract,
          f"cnceleb: stage 4's K1 inputs do not match EvalPipeline's batches ({n_caught}, "
          f"{k1_extract})")
    check(all(r["off_bar"] == 0 and r["finite"] for r in k1_rows),
          "cnceleb: K1 disagrees with its plain version on a stage-4 input")
    check(not cpu_bad, "cnceleb: " + "; ".join(cpu_bad))
    for s in (5, 6):
        check(len(done[s]["lines"]) == len(CNCELEB_TRIALS)
              and all(" EER " in ln for ln in done[s]["lines"]),
              f"cnceleb: stage {s} printed {done[s]['lines']}")
    return k1_extract


DIAR_CONFIG = RESNET_CONFIG  # examples/voxconverse/v2/README.md diarizes with ResNet34
DIAR_SEED = 20251027
DIAR_RECIPE = ((120, 2), (240, 3), (360, 4), (600, 3))  # (seconds, speakers): (a), (b)
DIAR_SERVED = (60, 90, 120, 150, 180, 210, 240, 300)  # (c): 8 concurrent /diarize posts
DIAR_CPU_SECONDS = 60  # the conversation embedded on the card and on the CPU
DIAR_LONG = (2700, 4)  # (d): at least DIAR_LONG_WINDOWS windows
DIAR_LONG_WINDOWS = 2000
SILERO_TOL = 1e-5


def conversation(rng, seconds, n_spk):
    """Alternating-tone turns of `n_spk` speakers (each turn 1-3 s of the
    speaker's two tones plus noise, then a zero gap of 0.4-0.9 s; the next
    speaker differs from the last), on the int16 grid: the samples and the
    exact reference turns [(begin_s, end_s, speaker)].  The JAX package's
    tests/test_diar_batch.py:_conversation, extended to K speakers."""
    parts, turns, t, spk = [], [], 0.0, 0
    while t < seconds:
        n = int(float(rng.uniform(1.0, 3.0)) * SR)
        tt = np.arange(n) / SR
        f0 = 150 + 90 * spk
        x = 0.3 * np.sin(2 * np.pi * f0 * tt) + 0.12 * np.sin(2 * np.pi * 2.1 * f0 * tt)
        parts.append(x + rng.standard_normal(n) * 0.01)
        turns.append((t, min(t + n / SR, seconds), f"S{spk}"))
        gap = int(float(rng.uniform(0.4, 0.9)) * SR)
        parts.append(np.zeros(gap))
        t += (n + gap) / SR
        spk = (spk + 1 + int(rng.integers(n_spk - 1))) % n_spk
    wav = np.concatenate(parts)[: int(seconds * SR)]
    wav = (np.round(np.clip(wav, -1, 1) * 32767) / 32768).astype(np.float32)
    return wav, [(b, e, s) for b, e, s in turns if e > b]


def write_diar_model_dir(root):
    """resnet34.yaml as the port's reader parses it, ResNet34 with seeded
    weights (strict load) and seeded Silero parameters as vad.npz."""
    from wespeaker_hubert_tpu_torch.diar.silero import save_silero_params, silero_init_params
    from wespeaker_hubert_tpu_torch.models.registry import get_speaker_model
    from wespeaker_hubert_tpu_torch.utils.config import load_config

    config = load_config(str(DIAR_CONFIG))
    model = get_speaker_model(config["model"])(**config["model_args"])
    sd = seeded_state_dict(model, DIAR_SEED)
    model.load_state_dict(sd, strict=True)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(config, f)
    torch.save(sd, os.path.join(root, "avg_model.pt"))
    save_silero_params(os.path.join(root, "vad.npz"),
                       silero_init_params(np.random.default_rng(DIAR_SEED)))
    return config


def _same_partition(a, b):
    pairs = set(zip(a, b))
    return len(a) == len(b) and len(pairs) == len(set(a)) == len(set(b))


def _k1_launches():
    from wespeaker_hubert_tpu_torch.ops import fbank_kernel

    return fbank_kernel.LAUNCHES


def _zero_k1():
    from wespeaker_hubert_tpu_torch.ops import fbank_kernel

    fbank_kernel.LAUNCHES = 0


def k1_on_inputs(inputs):
    """K1 against its plain version on each (wav, cfg) it was given, at
    `k1_held`'s bar.  Per shape: batches, elements past the bar, the
    largest errors."""
    from wespeaker_hubert_tpu_torch.ops import fbank_kernel

    rows = {}
    for wav, cfg in inputs:
        got = fbank_kernel.fbank_kernel(wav, cfg)
        want = fbank_kernel.fbank_kernel_reference(wav, cfg)
        truth = fbank_float64(wav, cfg)
        held, plain_off = k1_held(got, want, truth)
        row = rows.setdefault(tuple(wav.shape), {"shape": list(wav.shape), "batches": 0,
                                                "off_bar": 0, "plain_off_float64": 0,
                                                "max_abs_err": 0.0, "kernel_vs_float64": 0.0,
                                                "finite": True})
        row["batches"] += 1
        row["off_bar"] += int((~held).sum())
        row["plain_off_float64"] += int(plain_off.sum())
        row["max_abs_err"] = max(row["max_abs_err"], float((got - want).abs().max()))
        row["kernel_vs_float64"] = max(row["kernel_vs_float64"],
                                       float((got.double() - truth).abs().max()))
        row["finite"] &= bool(torch.isfinite(got).all())
        del got, want, truth, plain_off, held
    return list(rows.values())


def phase_diarization(report, root):
    """Diarization at ResNet34's full width (resnet34.yaml: 80 mels, TSTP,
    256-d, float32, TF32 off) with seeded weights and seeded Silero
    parameters, on constructed conversations of 2-4 speakers with exact
    reference RTTMs:
      (a) recipes.voxconverse_v2 over 4 conversations of 120-600 s, with
          --clusterer spectral and density, DER at collar 0.25;
      (b) recipes.voxconverse_v1 on the same 4, oracle and system (Silero)
          SAD;
      (c) the server: 8 concurrent /diarize posts of 60-300 s and one
          KServe `run` infer, each equal to a direct diarize_pcm_batch on the
          card, and that equal to sequential diarize_pcm (energy VAD, then
          Silero on the batched path);
      (d) a conversation of at least 2,000 windows through
          spectral.cluster(impl="device") and impl="host" at its 4 speakers.
    Checks: K1 against its plain version on every segment bucket of the 360
    s conversation; window embeddings and labels of a 60 s conversation card
    against CPU; Silero card against CPU within 1e-5; the served and batched
    results as above; (d)'s labels.  K1's launches on each path are counted.
    The DERs are reported (random weights), not gated."""
    import contextlib
    import io

    from wespeaker_hubert_tpu_torch.bin.serve import EmbeddingService, make_http_server
    from wespeaker_hubert_tpu_torch.cli.speaker import Speaker
    from wespeaker_hubert_tpu_torch.data.wav_io import write_wav
    from wespeaker_hubert_tpu_torch.diar import (density_cluster, make_seg_id,
                                                 spectral_cluster, subsegment_fbank,
                                                 write_rttm)
    from wespeaker_hubert_tpu_torch.diar import spectral as spectral_mod
    from wespeaker_hubert_tpu_torch.diar.silero import silero_probs
    from wespeaker_hubert_tpu_torch.ops import fbank_kernel
    from wespeaker_hubert_tpu_torch.recipes import voxconverse_v1, voxconverse_v2

    out = report["diarization"] = {"config": DIAR_CONFIG.name}
    model_dir = os.path.join(root, "model")
    os.makedirs(model_dir)
    config = write_diar_model_dir(model_dir)
    data = Path(root) / "data"
    (data / "ref").mkdir(parents=True)
    rng = np.random.default_rng(DIAR_SEED)
    convs = {}
    for i, (seconds, n_spk) in enumerate(DIAR_RECIPE):
        utt = f"conv{i}"
        wav, turns = conversation(rng, seconds, n_spk)
        write_wav(str(data / f"{utt}.wav"), wav)
        write_rttm(str(data / "ref" / f"{utt}.rttm"), [(utt, b, e, s) for b, e, s in turns])
        convs[utt] = (wav, turns)
    (data / "wav.scp").write_text("".join(f"{u} {data / u}.wav\n" for u in convs))
    write_rttm(str(data / "ref.rttm"),
               [(u, b, e, s) for u, (_, turns) in convs.items() for b, e, s in turns])
    log(f"[diar] {config['model']} {config['model_args']}; conversations "
        + ", ".join(f"{u} {len(w) / SR:.0f} s / {len({s for *_, s in t})} speakers / "
                    f"{len(t)} turns" for u, (w, t) in convs.items()))

    def recipe(mod, tag, args):
        _zero_k1()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            d = mod.main(["--model_dir", model_dir, "--wav_scp", str(data / "wav.scp"),
                          "--out_rttm", str(Path(root) / f"{tag}.rttm"), "--device", DEVICE]
                         + args)
        secs = time.perf_counter() - t0
        row = {"der": d["der"], "miss": d["miss"] / d["total"], "fa": d["fa"] / d["total"],
               "confusion": d["confusion"] / d["total"], "scored_s": d["total"],
               "seconds": secs, "k1_launches": _k1_launches(),
               "printed": buf.getvalue().strip().splitlines()[-1]}
        log(f"[diar {tag}] {row['printed']} ({row['scored_s']:.1f} s scored, collar 0.25); "
            f"{secs:.1f} s for {sum(len(w) for w, _ in convs.values()) / SR:.0f} s of audio; "
            f"K1 launches {row['k1_launches']}")
        check(DEVICE != "cuda" or row["k1_launches"] > 0, f"diarization {tag}: K1 never launched")
        return row

    # (a), (b)
    out["v2_spectral"] = recipe(voxconverse_v2, "v2_spectral",
                                ["--ref_rttm", str(data / "ref.rttm"), "--clusterer", "spectral"])
    out["v2_density"] = recipe(voxconverse_v2, "v2_density",
                               ["--ref_rttm", str(data / "ref.rttm"), "--clusterer", "density"])
    for sad in ("oracle", "system"):
        out[f"v1_{sad}"] = recipe(voxconverse_v1, f"v1_{sad}",
                                  ["--ref_rttm_dir", str(data / "ref"), "--sad_type", sad])

    card = Speaker(model_dir, device=DEVICE)
    cpu = Speaker(model_dir, device="cpu")
    # K1 on every segment bucket of the 360 s conversation
    wav, _ = convs["conv2"]
    segs = card._vad_segments(wav)
    k1_inputs, real_k1 = [], fbank_kernel.fbank_kernel

    def keep(w, cfg):
        k1_inputs.append((w.clone(), cfg))
        return real_k1(w, cfg)
    fbank_kernel.fbank_kernel = keep
    try:
        card._segment_fbanks(wav, segs)
    finally:
        fbank_kernel.fbank_kernel = real_k1
    k1_rows = k1_on_inputs(k1_inputs) if DEVICE == "cuda" else []
    out["k1_segment_buckets"] = k1_rows
    log(f"[diar K1] {len(segs)} VAD segments of conv2 in {len(k1_inputs)} batches: "
        + "; ".join(f"{tuple(r['shape'])} x{r['batches']}: {r['off_bar']} elements past the bar "
                    f"(max|err| vs plain {r['max_abs_err']:.3e}, vs float64 "
                    f"{r['kernel_vs_float64']:.3e}; plain off float64 {r['plain_off_float64']})"
                    for r in k1_rows))
    check(DEVICE != "cuda" or k1_inputs and all(r["off_bar"] == 0 and r["finite"] for r in k1_rows),
          f"diarization: K1 disagrees with its plain version on a segment bucket {k1_rows}")

    # window embeddings and labels of a 60 s conversation, card against CPU
    wav60, _ = conversation(np.random.default_rng(DIAR_SEED + 1), DIAR_CPU_SECONDS, 3)
    segs60 = card._vad_segments(wav60)

    def windows(spk, w, s):
        subsegs, fbanks = [], []
        for (b, e), f in zip(s, spk._segment_fbanks(w, s)):
            ids, m = subsegment_fbank(f, make_seg_id("c60", int(b * 1000), int(e * 1000)))
            subsegs += ids
            fbanks += m
        return np.stack(fbanks)

    t0 = time.perf_counter()
    emb_card = card._extract_embedding_feats(windows(card, wav60, segs60))
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    emb_cpu = cpu._extract_embedding_feats(windows(cpu, wav60, segs60))
    cpu_s = time.perf_counter() - t0
    cos = [cosine(a, b) for a, b in zip(emb_card, emb_cpu)]
    lab_card, lab_cpu = density_cluster(emb_card), density_cluster(emb_cpu)
    sp_card = spectral_cluster(emb_card, seed=DIAR_SEED, impl="host")
    sp_cpu = spectral_cluster(emb_cpu, seed=DIAR_SEED, impl="host")
    out["card_vs_cpu"] = {"windows": len(cos), "min_cosine": min(cos), "bar": COS_MIN["f32"],
                          "density_same_partition": _same_partition(lab_card, lab_cpu),
                          "spectral_same_partition": _same_partition(sp_card, sp_cpu),
                          "card_s": card_s, "cpu_s": cpu_s}
    log(f"[diar card vs CPU] {len(cos)} windows of a {DIAR_CPU_SECONDS} s conversation: min "
        f"cosine {min(cos):.7f} (bar {COS_MIN['f32']}); labels the same partition: density "
        f"{out['card_vs_cpu']['density_same_partition']} ({len(set(lab_card))} speakers), "
        f"spectral {out['card_vs_cpu']['spectral_same_partition']} ({len(set(sp_card))}); "
        f"fbank + embeddings {card_s:.2f} s on the card, {cpu_s:.2f} s on the CPU")
    check(len(cos) == len(emb_cpu) and min(cos) >= COS_MIN["f32"],
          f"diarization: window embeddings card vs CPU, min cosine {min(cos)}")
    check(out["card_vs_cpu"]["density_same_partition"]
          and out["card_vs_cpu"]["spectral_same_partition"],
          "diarization: labels from the card's embeddings differ from the CPU's")

    # Silero card against CPU
    card.set_vad(True)
    cpu.set_vad(True)
    wav120 = convs["conv0"][0]
    p_card = silero_probs(card.vad_model, wav120)
    p_cpu = silero_probs(cpu.vad_model, wav120)
    silero_err = float(np.abs(p_card - p_cpu).max())
    out["silero"] = {"chunks": len(p_card), "max_abs_err": silero_err, "tol": SILERO_TOL}
    log(f"[diar silero] {len(p_card)} chunks of conv0, card vs CPU max|d| {silero_err:.2e} "
        f"(tol {SILERO_TOL})")
    check(silero_err <= SILERO_TOL, f"diarization: Silero card vs CPU {silero_err}")
    del cpu

    # (c) the server
    service = EmbeddingService(model_dir, device=DEVICE)
    httpd = make_http_server(service, "127.0.0.1", 0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        srng = np.random.default_rng(DIAR_SEED + 2)
        served = [conversation(srng, s, 2 + i % 3)[0] for i, s in enumerate(DIAR_SERVED)]
        bodies = [wav_bytes(w) for w in served]
        _zero_k1()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(bodies)) as pool:
            replies = list(pool.map(lambda b: post(url + "/diarize", b), bodies))
        burst_s = time.perf_counter() - t0
        served_launches = _k1_launches()
        got = [[(s["utt"], s["begin"], s["end"], s["speaker"]) for s in r["segments"]]
               for r in replies]
        kserve_body = json.dumps({"inputs": [{"name": "input", "datatype": "FP32",
                                              "shape": [1, len(served[0])],
                                              "data": served[0].tolist()}]}).encode()
        kserve = post(url + "/v2/models/run/infer", kserve_body)["outputs"][0]
        stats = get(url + "/stats")["diarization"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
        server.join(timeout=30)
    spk = service.speaker
    t0 = time.perf_counter()
    direct = spk.diarize_pcm_batch(served, utts=["unk"] * len(served))
    direct_s = time.perf_counter() - t0
    timings = dict(spk.last_diar_timings)
    sequential = [spk.diarize_pcm(w) for w in served]
    kserve_rows = np.asarray(kserve["data"], np.float64).reshape(kserve["shape"])
    kserve_ok = kserve_rows.tolist() == [[b, e, float(s)] for _, b, e, s in direct[0]]
    audio_s = sum(len(w) for w in served) / SR
    out["served"] = {"requests": len(served), "audio_s": audio_s, "burst_s": burst_s,
                     "audio_s_per_s": audio_s / burst_s, "k1_launches": served_launches,
                     "served_equal_direct": got == direct, "kserve_equal_direct": kserve_ok,
                     "direct_equal_sequential": direct == sequential,
                     "direct_s": direct_s, "last_diar_timings": timings, "stats": stats}
    log(f"[diar served] {len(served)} concurrent /diarize posts, {audio_s:.0f} s of audio in "
        f"{burst_s:.2f} s: {audio_s / burst_s:.1f} audio-s/s; K1 launches {served_launches}; "
        f"served == direct diarize_pcm_batch {got == direct}, KServe run == direct {kserve_ok}, "
        f"direct == sequential diarize_pcm {direct == sequential}")
    log(f"[diar served] direct diarize_pcm_batch {direct_s:.2f} s, last_diar_timings "
        + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items()))
    check(DEVICE != "cuda" or served_launches > 0, "diarization: the served burst launched no K1")
    check(got == direct and kserve_ok and direct == sequential,
          "diarization: served / KServe / batched / sequential results differ")
    check(stats["total_steps"] == len(served) + 1, f"diarization /stats {stats}")
    # the batched path with Silero: the segment fbank sliced from the VAD's rows
    spk.set_vad(True)
    _zero_k1()
    silero_batch = spk.diarize_pcm_batch(served[:4], utts=["unk"] * 4)
    out["served"]["silero_batch_k1_launches"] = _k1_launches()
    silero_seq = [spk.diarize_pcm(w) for w in served[:4]]
    out["served"]["silero_batch_equal_sequential"] = silero_batch == silero_seq
    log(f"[diar served] Silero VAD: diarize_pcm_batch == sequential {silero_batch == silero_seq}"
        f" on 4 conversations, last_diar_timings "
        + ", ".join(f"{k} {v:.3f} s" for k, v in spk.last_diar_timings.items()))
    check(silero_batch == silero_seq, "diarization: Silero batched != sequential")
    del service, spk

    # (d) device spectral against host at >= 2,000 windows
    seconds, n_spk = DIAR_LONG
    wav, turns = conversation(np.random.default_rng(DIAR_SEED + 3), seconds, n_spk)
    segs = [(b, e) for b, e, _ in turns if e - b >= 0.255]
    emb = card._extract_embedding_feats(windows(card, wav, segs))
    check(len(emb) >= DIAR_LONG_WINDOWS, f"diarization (d): {len(emb)} windows")
    dev = spectral_cluster(emb, num_spks=n_spk, seed=DIAR_SEED, impl="device", device=DEVICE)
    host = spectral_cluster(emb, num_spks=n_spk, seed=DIAR_SEED, impl="host")
    routed = []
    real = spectral_mod._spectral_eigh_device
    spectral_mod._spectral_eigh_device = lambda e, p, d: routed.append(1) or real(e, p, DEVICE)
    try:
        auto = spectral_cluster(emb, num_spks=n_spk, seed=DIAR_SEED, impl="auto", device="cuda")
    finally:
        spectral_mod._spectral_eigh_device = real
    lap = spectral_mod._laplacian(spectral_mod._prune(spectral_mod._cosine_similarity(emb), 0.01))
    if DEVICE == "cuda":
        dev_ms = host_median_ms(lambda: real(emb, 0.01, DEVICE), reps=5, warmup=1)
        lap_t = torch.from_numpy(lap).to(DEVICE)
        eigh_dev_ms = cuda_median_ms(lambda: torch.linalg.eigh(lap_t), reps=5, warmup=1)
    else:
        dev_ms = eigh_dev_ms = float("nan")
    import scipy.linalg

    t0 = time.perf_counter()
    scipy.linalg.eigh(lap)
    eigh_host_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    spectral_mod._laplacian(spectral_mod._prune(spectral_mod._cosine_similarity(emb), 0.01))
    host_pipe_ms = (time.perf_counter() - t0) * 1e3 + eigh_host_ms
    out["long"] = {"seconds": seconds, "speakers": n_spk, "windows": len(emb),
                   "same_partition": _same_partition(dev, host),
                   "auto_took_device": routed == [1] and _same_partition(auto, host),
                   "device_pipeline_ms": dev_ms, "device_eigh_ms": eigh_dev_ms,
                   "host_pipeline_ms": host_pipe_ms, "host_eigh_ms": eigh_host_ms,
                   "host_speakers_found": len(set(host))}
    log(f"[diar long] {seconds} s, {n_spk} speakers, {len(emb)} windows: device labels == host "
        f"labels (up to permutation) {out['long']['same_partition']}, auto took the device "
        f"{out['long']['auto_took_device']}; eigh {eigh_dev_ms:.2f} ms on the card "
        f"(torch.linalg.eigh, events), {eigh_host_ms:.1f} ms on the host (scipy); "
        f"similarity -> prune -> Laplacian -> eigh {dev_ms:.2f} ms on the card, "
        f"{host_pipe_ms:.1f} ms on the host")
    check(out["long"]["same_partition"] and out["long"]["auto_took_device"],
          "diarization (d): device spectral labels differ from the host's")
    return {k: out[k]["k1_launches"] for k in ("v2_spectral", "v2_density", "v1_oracle",
                                               "v1_system", "served")}


SCORE_SIZES = {"vox1_O": (40, 4874, 37720), "vox1_H": (1251, 153516, 552536)}


def _score_set(root, name, n_spk, n_utt, n_trials, seed):
    """Seeded 192-d embeddings with speaker structure (a speaker centre plus
    noise 2.2x its size per dimension), a balanced labeled trial list, and
    the cohort: 5,994 speaker means (each the mean of 8 noisy draws)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_spk, 192))
    spk = rng.integers(0, n_spk, n_utt)
    emb = (centers[spk] + 2.2 * rng.standard_normal((n_utt, 192))).astype(np.float32)
    keys = [f"{name}-s{s:04d}-u{i:06d}" for i, s in enumerate(spk)]
    by_spk = {}
    for i, s in enumerate(spk):
        by_spk.setdefault(s, []).append(i)
    multi = [s for s, us in by_spk.items() if len(us) > 1]
    half = n_trials // 2
    ts = rng.choice(multi, half)
    tgt = [rng.choice(by_spk[s], 2, replace=False) for s in ts]
    a, b = rng.integers(0, n_utt, 2 * n_trials), rng.integers(0, n_utt, 2 * n_trials)
    keep = spk[a] != spk[b]
    rows = [(keys[i], keys[j], "target") for i, j in tgt]
    rows += [(keys[i], keys[j], "nontarget")
             for i, j in list(zip(a[keep], b[keep]))[:n_trials - half]]
    cohort = (rng.standard_normal((RECIPE_SPEAKERS, 192))
              + 2.2 / math.sqrt(8) * rng.standard_normal((RECIPE_SPEAKERS, 192)))
    paths = {k: os.path.join(root, f"{name}.{k}") for k in ("emb.npz", "cohort.npz",
                                                             "mean.npy", "trials")}
    from wespeaker_hubert_tpu_torch.utils.embeddings import save_embeddings

    save_embeddings(paths["emb.npz"], keys, emb)
    save_embeddings(paths["cohort.npz"], [f"c{i:04d}" for i in range(RECIPE_SPEAKERS)],
                    cohort.astype(np.float32))
    np.save(paths["mean.npy"], emb.mean(0))
    Path(paths["trials"]).write_text("".join(f"{e} {t} {lab}\n" for e, t, lab in rows))
    return paths, emb, keys, rows, cohort.astype(np.float32)


def phase_score(report, root):
    """bin/score's cosine scoring, AS-Norm (top 300 of a 5,994-speaker
    cohort) and metrics at VoxCeleb1-O's and VoxCeleb1-H's sizes on seeded
    embeddings, on the card (timed) and on the CPU; the backend's numbers
    card against CPU: scores 1e-5, cohort means and stds 1e-6, AS-Norm
    2e-4; the EERs equal to 0.01 percentage points."""
    from wespeaker_hubert_tpu_torch.backend import score
    from wespeaker_hubert_tpu_torch.bin.score import compute_metrics, score_norm, score_trials

    out = report["score"] = {}
    for i, (name, (n_spk, n_utt, n_trials)) in enumerate(SCORE_SIZES.items()):
        paths, emb, keys, rows, cohort = _score_set(root, name, n_spk, n_utt, n_trials,
                                                    RECIPE_SEED + 10 + i)
        res = {"utterances": n_utt, "speakers": n_spk, "trials": len(rows)}
        for dev in (DEVICE, "cpu"):
            d = os.path.join(root, f"{name}-{dev}")
            t0 = time.perf_counter()
            sf = score_trials(paths["emb.npz"], [paths["trials"]], d, paths["mean.npy"],
                              device=dev)[0]
            t1 = time.perf_counter()
            nf = score_norm(sf, sf + ".asnorm", paths["emb.npz"], paths["cohort.npz"],
                            top_n=300, mean_vec_path=paths["mean.npy"], device=dev)
            t2 = time.perf_counter()
            metrics = [compute_metrics(sf), compute_metrics(nf)]
            t3 = time.perf_counter()
            res[dev] = {"score_trials_s": t1 - t0, "score_norm_s": t2 - t1,
                        "compute_metrics_s": t3 - t2,
                        "eer_mindcf": {"cosine": metrics[0], "asnorm": metrics[1]}}
        # the backend's numbers, card against CPU, on the same inputs
        key2i = {k: j for j, k in enumerate(keys)}
        e_idx = np.asarray([key2i[r[0]] for r in rows])
        t_idx = np.asarray([key2i[r[1]] for r in rows])
        mean_vec = emb.mean(0)
        got = {}
        for dev in (DEVICE, "cpu"):
            s = score.trial_cosine_scores(emb, e_idx, t_idx, mean_vec=mean_vec, device=dev)
            m, sd = score.cohort_mean_std(emb - mean_vec, cohort - mean_vec, 300, device=dev)
            got[dev] = (s, m, sd, score.apply_asnorm(s, e_idx, t_idx, m, sd, m, sd))
        errs = [float(np.abs(got[DEVICE][j] - got["cpu"][j]).max()) for j in range(4)]
        eer_diff = max(abs(res[DEVICE]["eer_mindcf"][k][0] - res["cpu"]["eer_mindcf"][k][0])
                       for k in ("cosine", "asnorm"))
        res.update({"max_abs_err": dict(zip(("score", "cohort_mean", "cohort_std", "asnorm"),
                                            errs)), "eer_diff_pp": eer_diff})
        out[name] = res
        c, p = res[DEVICE], res["cpu"]
        log(f"[score {name}] {n_utt} utterances, {len(rows)} trials, cohort {RECIPE_SPEAKERS} "
            f"top 300: card score_trials {c['score_trials_s']:.3f} s, score_norm "
            f"{c['score_norm_s']:.3f} s, compute_metrics {c['compute_metrics_s']:.3f} s (CPU "
            f"{p['score_trials_s']:.3f} / {p['score_norm_s']:.3f} / {p['compute_metrics_s']:.3f}"
            f" s); EER cosine {c['eer_mindcf']['cosine'][0]:.3f}% asnorm "
            f"{c['eer_mindcf']['asnorm'][0]:.3f}% (CPU {p['eer_mindcf']['cosine'][0]:.3f}% / "
            f"{p['eer_mindcf']['asnorm'][0]:.3f}%); card vs CPU max abs err score {errs[0]:.1e},"
            f" mean {errs[1]:.1e}, std {errs[2]:.1e}, asnorm {errs[3]:.1e}")
        check(errs[0] <= 1e-5 and errs[1] <= 1e-6 and errs[2] <= 1e-6 and errs[3] <= 2e-4,
              f"score {name}: card vs CPU {errs}")
        check(eer_diff <= 0.01, f"score {name}: EER differs by {eer_diff} pp")
        check(all(0 < v[0] < 50 for v in c["eer_mindcf"].values()),
              f"score {name}: EERs {c['eer_mindcf']}")
        del emb, got


SRE_CONFIG = RESNET_CONFIG  # ResNet34 (32 channels, TSTP, 256-d), SRE v2's extractor
SRE_SEED = 20251028
SRE_SR = 8000  # SRE's telephone speech
SRE_MELS = 64
# SRE v2's front end on resnet34.yaml: 8 kHz wavs, 64 mels (a 256-point FFT)
SRE_FRONT = [f"dataset_args.resample_rate={SRE_SR}",
             f"dataset_args.fbank_args.num_mel_bins={SRE_MELS}", f"model_args.feat_dim={SRE_MELS}"]
SRE_TRAIN = (64, 4)  # swbd_sre speakers, utterances each: 2 batches of 128 an epoch
SRE_EPOCH_STEPS = 2  # 2 epochs
SRE_EXTRA = []  # more overrides, for a CPU rehearsal (batch size, width)
SRE_CHAIN = "mean-subtract | length-norm | lda --dim 100 | length-norm"
# (speakers, segments, copies, adaptation segments, models, test segments,
# trials): the SRE16 / CTS-superset recipe's PLDA set (6,867 speakers,
# 605,760 segments, x3 with the augmented copies), sre16 major (2,272),
# enrollment (1,200 models of 1 or 3 segments) and test (9,300), 2 M trials;
# and the cut size run on the card and on the CPU
SRE_BACKEND = {"full": (6867, 605760, 3, 2272, 1200, 9300, 2_000_000),
               "cut": (700, 20300, 3, 2272, 1200, 9300, 200_000)}
SRE_DIM = 256
SRE_NUISANCE = (24, 2.5)  # in-domain channel: directions, std
SRE_WITHIN = 1.0


def write_sre_data(data, cts):
    """SRE v2's DATA directory and a CTS-superset root from seeded 8 kHz
    audio (`speechlike`, a pitch per speaker): MUSAN / RIR stand-ins;
    swbd_sre (SRE_TRAIN, 2.5-4.5 s) and sre (40 speakers x 4) with VAD
    files; sre16_major (64 unlabeled); sre16_eval_enroll (20 models of 1-3
    segments), sre16_eval_test (60 segments of those speakers) and their
    1,200 labeled trials; the CTS key TSV with 40 segments of 6 s over 20
    speakers.  Returns {set: audio seconds}."""
    from wespeaker_hubert_tpu_torch.data.wav_io import write_wav

    rng = np.random.default_rng(SRE_SEED)
    sr = SRE_SR

    def put(path, x):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_wav(str(path), x, sr)
        return str(path)

    scp = []
    for kind, n in (("noise", 3), ("music", 2), ("speech", 2)):
        for i in range(n):
            x = (rng.uniform(0.05, 0.2) * rng.standard_normal(6 * sr)).astype(np.float32)
            scp.append(f"{kind}-{i} {put(f'{data}/musan/{kind}-{i}.wav', x)}")
    Path(f"{data}/musan/wav.scp").write_text("\n".join(scp) + "\n")
    scp = []
    for i in range(4):
        n = int(0.25 * sr)
        x = rng.standard_normal(n) * np.exp(-np.arange(n) / rng.uniform(200, 800)) * 0.3
        x[0] = 1.0
        scp.append(f"rir-{i} {put(f'{data}/rirs/rir-{i}.wav', x.astype(np.float32))}")
    Path(f"{data}/rirs/wav.scp").write_text("\n".join(scp) + "\n")
    f0s = rng.uniform(90, 280, 200)
    seconds = {}
    eval_spk = rng.integers(0, 20, 60)
    # {set: [(speaker (its pitch), utterances, label)]}; enrollment labels
    # are the trial file's model ids
    layout = {"swbd_sre": [(s, SRE_TRAIN[1], f"spk{s}") for s in range(SRE_TRAIN[0])],
              "sre": [(100 + s, 4, f"spk{100 + s}") for s in range(40)],
              "sre16_major": [(140 + s % 32, 1, None) for s in range(64)],
              "sre16_eval_enroll": [(180 + m, 1 + m % 3, f"m{m}") for m in range(20)],
              "sre16_eval_test": [(180 + int(m), 1, None) for m in eval_spk]}
    for dset, speakers in layout.items():
        scp, u2s, vad, total = [], [], [], 0.0
        for j, (s, count, label) in enumerate(speakers):
            for k in range(count):
                d = float(rng.uniform(2.5, 4.5))
                x = speechlike(rng, d, f0s[s], sr)
                total += len(x) / sr
                utt = f"{dset}-{j:03d}-{k}"
                scp.append(f"{utt} {put(f'{data}/{dset}/wav/{utt}.wav', x)}")
                u2s.append(f"{utt} {label}")
                vad.append(f"{utt}-0000 {utt} 0.100 {d - 0.1:.3f}")
        Path(f"{data}/{dset}/wav.scp").write_text("\n".join(scp) + "\n")
        if dset in ("swbd_sre", "sre", "sre16_eval_enroll"):
            Path(f"{data}/{dset}/utt2spk").write_text("\n".join(u2s) + "\n")
        if dset in ("swbd_sre", "sre"):
            Path(f"{data}/{dset}/vad").write_text("\n".join(vad) + "\n")
        seconds[dset] = total
    tests = [ln.split()[0] for ln in Path(f"{data}/sre16_eval_test/wav.scp").read_text().split("\n")
             if ln]
    Path(f"{data}/trials").write_text("".join(
        f"m{m} {t} {'target' if m == s else 'nontarget'}\n"
        for m in range(20) for t, s in zip(tests, eval_spk)))
    rows = ["segmentid\tsubjectid\tspeakerid"]
    for j in range(40):
        s = 64 + j % 20  # pitches no other set uses
        seg = f"cts-{j:03d}"
        put(f"{cts}/data/{seg}.wav", speechlike(rng, 6.0, f0s[s], sr))
        rows.append(f"{seg}.sph\t{s}\tcts{s}")
    os.makedirs(f"{cts}/docs", exist_ok=True)
    Path(f"{cts}/docs/cts_superset_segment_key.tsv").write_text("\n".join(rows) + "\n")
    seconds["cts"] = 40 * 6.0
    return seconds


def _step_line(st):
    """'1.234 s, peak 5.67 GB, host share 0.123' of a timed back-end step
    (the seconds alone on the CPU)."""
    if isinstance(st["peak_gb"], str):  # a CPU run
        return f"{st['s']:.3f} s"
    return f"{st['s']:.3f} s, peak {st['peak_gb']:.2f} GB, host share {st['host_share']:.3f}"


def sre_backend_data(size, seed, device):
    """Seeded Gaussian embeddings at SRE_BACKEND[size], made on `device`:
    speaker centres with a decaying spectrum, segments a centre plus noise
    (SRE_WITHIN), each copied 3 times with small noise (the augmented
    copies); the in-domain sets (adaptation, enrollment, test) from other
    speakers, shifted in mean and with a nuisance of SRE_NUISANCE[1] in
    SRE_NUISANCE[0] random directions (the channel BUT adaptation is for).
    Trials: every test segment against its own model, the rest random
    pairs.  All float32 but the labels."""
    n_spk, n_seg, copies, n_adapt, n_models, n_test, n_trials = SRE_BACKEND[size]
    g = torch.Generator(device).manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g, device=device)

    def ints(hi, n):
        return torch.randint(0, hi, (n,), generator=g, device=device)

    d = SRE_DIM
    scale = torch.exp(-torch.arange(d, device=device) / 60.0) + 0.15
    nuis, _ = torch.linalg.qr(r(d, SRE_NUISANCE[0]))
    shift = r(d) * (8.0 / math.sqrt(d)) * 0.6

    def in_domain(x):
        return x + shift + (SRE_NUISANCE[1] * r(len(x), SRE_NUISANCE[0])) @ nuis.T

    centres = r(n_spk, d) * scale
    seg_spk = torch.cat([torch.arange(n_spk, device=device), ints(n_spk, n_seg - n_spk)])
    seg = centres[seg_spk] + SRE_WITHIN * r(n_seg, d)
    train = torch.cat([seg + 0.25 * r(n_seg, d) for _ in range(copies)])
    del seg
    adapt_centres = r(n_adapt, d) * scale
    adapt = in_domain(adapt_centres[ints(n_adapt, n_adapt)] + SRE_WITHIN * r(n_adapt, d))
    model_centres = r(n_models, d) * scale
    sessions = 1 + 2 * ints(2, n_models)
    e_model = torch.repeat_interleave(torch.arange(n_models, device=device), sessions)
    enroll = in_domain(model_centres[e_model] + SRE_WITHIN * r(len(e_model), d))
    t_spk = ints(n_models, n_test)
    test = in_domain(model_centres[t_spk] + SRE_WITHIN * r(n_test, d))
    e_idx = torch.cat([t_spk, ints(n_models, n_trials - n_test)])
    t_idx = torch.cat([torch.arange(n_test, device=device), ints(n_test, n_trials - n_test)])
    return {"train": train, "labels": seg_spk.repeat(copies), "adapt": adapt, "enroll": enroll,
            "e_model": e_model, "test": test, "e_idx": e_idx, "t_idx": t_idx,
            "target": (t_spk[t_idx] == e_idx)}


def sre_backend(data, device, timed):
    """The SRE v3 back end on `data` (sre_backend_data) on `device`, each
    step through `timed(name, fn)`: fit SRE_CHAIN on the training rows
    (speakers through an utt2spk over their keys), apply it, PLDA accumulate / 5 EM iterations / finalize, adaptation on
    the chain-processed in-domain rows, then enrollment and test through the
    chain and TwoCovPLDA.score_trials over the trial keys, before and after
    adaptation.  Returns {"psi", "scores", "adapted_scores", "adapt_info",
    "eer", "adapted_eer"} (EERs in percent, scores float64 on the host)."""
    from wespeaker_hubert_tpu_torch.backend.metrics import eer_from_scores
    from wespeaker_hubert_tpu_torch.backend.plda import TwoCovPLDA
    from wespeaker_hubert_tpu_torch.backend.processing import EmbeddingProcessingChain

    def on(x):
        return x.to(device)

    labels = on(data["labels"])
    # utterance and speaker keys, as an embedding set and its utt2spk give
    # them (set-up, not timed)
    keys = [f"u{i:07d}" for i in range(len(labels))]
    utt2spk = dict(zip(keys, (f"s{v:05d}" for v in data["labels"].tolist())))
    chain = timed("chain fit", lambda: EmbeddingProcessingChain(device=device).fit(
        SRE_CHAIN, on(data["train"]), utt2spk=utt2spk, keys=keys))
    x = timed("chain apply (train)", lambda: chain(on(data["train"])))
    plda = TwoCovPLDA(x.shape[1], normalize_length=True, device=device)
    timed("accumulate", lambda: plda.accumulate_rows(x, labels))
    del x

    def em():
        for _ in range(5):
            plda.em_one_iter()
    timed("EM (5 iterations)", em)
    timed("finalize", plda.finalize)
    adapted = timed("adapt", lambda: plda.adapt(chain(on(data["adapt"]))))
    # trial keys, as a trial file gives them (set-up, not timed)
    e_model = data["e_model"].cpu().numpy()
    m_keys = np.asarray([f"m{i:05d}" for i in range(int(e_model.max()) + 1)])
    t_keys = np.asarray([f"t{i:05d}" for i in range(len(data["test"]))])
    trials = list(zip(m_keys[data["e_idx"].cpu().numpy()].tolist(),
                      t_keys[data["t_idx"].cpu().numpy()].tolist()))
    target = data["target"].cpu().numpy().astype(np.int64)
    out = {"psi": plda.psi.cpu().numpy(), "adapt_info": adapted.adapt_info}
    for tag, model in (("scores", plda), ("adapted_scores", adapted)):
        def score(model=model):
            e = chain(on(data["enroll"])).cpu().numpy()
            t = chain(on(data["test"])).cpu().numpy()
            order = np.argsort(e_model, kind="stable")
            bounds = np.searchsorted(e_model[order], np.arange(len(m_keys) + 1))
            enroll = {m_keys[i]: e[order[bounds[i]:bounds[i + 1]]] for i in range(len(m_keys))}
            return model.score_trials(enroll, dict(zip(t_keys.tolist(), t)), trials,
                                      multisession_avg=False)
        out[tag] = timed(f"transform + score {len(trials):,} trials"
                         + (" (adapted)" if tag != "scores" else ""), score)
    out["eer"] = 100 * eer_from_scores(out["scores"], target)[0]
    out["adapted_eer"] = 100 * eer_from_scores(out["adapted_scores"], target)[0]
    return out


def phase_sre(report, root):
    """The NIST SRE recipes on the card.
    Part 1: recipes.sre_v2 stages 1-7 on resnet34.yaml (ResNet34, 32
    channels, TSTP, 256-d, batch 128 x 200 frames, float32) at 8 kHz with
    64 mels (SRE_FRONT), overriding only the paths and the run's length (2
    epochs of 2 steps), on write_sre_data's corpus; then bin/infer_export on
    the stage-7 program against bin/extract on one wav, bin/tools
    compute_feats (16 kHz, its signature's rate) on 8 wavs, and
    recipes.sre_v3 stages 1-2 (CTS key, energy-VAD system SAD at 8 kHz,
    voiced-duration filter, aug copies) and 4-8 on the same config and data
    (stage 3 skipped: v2's checkpoints are in the same exp_dir).  K1 is
    counted in each stage 4, compute_feats and infer_export (zeroed just
    before, read just after) and held to its plain version on every input
    it was given there.  Part 2: the back end (sre_backend) at the SRE16 /
    CTS-superset size on seeded Gaussian embeddings, each step timed with
    its peak memory and host share, and at the cut size on the card and on
    the CPU: scores within 1e-6, psi within 1e-9 relative, EERs within 0.01
    pp."""
    import contextlib
    import io

    from wespeaker_hubert_tpu_torch.bin import infer_export, tools
    from wespeaker_hubert_tpu_torch.bin import train as bin_train
    from wespeaker_hubert_tpu_torch.bin.extract import extract
    from wespeaker_hubert_tpu_torch.data.wav_io import write_wav
    from wespeaker_hubert_tpu_torch.ops import fbank_kernel
    from wespeaker_hubert_tpu_torch.ops.signal import mel_banks
    from wespeaker_hubert_tpu_torch.recipes import sre_v2, sre_v3
    from wespeaker_hubert_tpu_torch.utils.config import apply_overrides, load_config

    out = report["sre"] = {}
    t_phase = time.perf_counter()
    data, cts, exp = (os.path.join(root, n) for n in ("data", "cts", "exp"))
    out["audio_s"] = write_sre_data(data, cts)
    banks = mel_banks(SRE_MELS, 256, float(SRE_SR))
    out["empty_mel_filters"] = int((np.count_nonzero(banks, axis=0) == 0).sum())
    check(banks.shape == (129, SRE_MELS) and out["empty_mel_filters"] == 0,
          f"sre: {out['empty_mel_filters']} empty mel filters at 8 kHz / 256-point FFT")
    overrides = ([f"exp_dir={exp}", f"train_data={data}/swbd_sre/shard.list",
                  f"train_label={data}/swbd_sre/utt2spk",
                  f"dataset_args.reverb_data={data}/rirs_aug_store",
                  f"dataset_args.noise_data={data}/musan_aug_store",
                  "num_epochs=2", f"epoch_iter={SRE_EPOCH_STEPS}", "save_epoch_interval=1",
                  "num_avg=2"] + SRE_FRONT + SRE_EXTRA)
    config = apply_overrides(load_config(str(SRE_CONFIG)), overrides)
    trials = os.path.join(data, "trials")
    v2_args = ["--config", str(SRE_CONFIG), "--data_root", data, "--trials", trials,
               "--out_dir", os.path.join(root, "v2_scores"), "--device", DEVICE] + overrides
    k1_in, runs = [], {}

    def run(tag, fn):
        """fn() with K1's count zeroed just before and read just after, and
        its inputs kept; printed lines captured."""
        _zero_k1()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with _K1Spy(fbank_kernel) as spy, contextlib.redirect_stdout(buf):
            res = fn()
        runs[tag] = {"s": time.perf_counter() - t0, "k1": _k1_launches(),
                     "printed": [ln for ln in buf.getvalue().splitlines() if "EER " in ln]}
        k1_in.extend((tag, w, c) for w, c in zip(spy.inputs, spy.cfgs))
        log(f"[sre {tag}] {runs[tag]['s']:.1f} s, K1 launches {runs[tag]['k1']}"
            + "".join(f"; {ln.strip()}" for ln in runs[tag]["printed"]))
        return res

    def v2(a, b):
        return sre_v2.main(["--stage", str(a), "--stop_stage", str(b)] + v2_args)

    step_timer, make = _StepTimer(), bin_train.make_train_step
    bin_train.make_train_step = step_timer(make)
    try:
        run("v2 stages 1-3", lambda: v2(1, 3))
    finally:
        bin_train.make_train_step = make
    steps_ms = [1e3 * s for _, s in step_timer.calls]
    out["train_step_ms"] = steps_ms
    log(f"[sre] stage 3: {len(steps_ms)} steps of {config['model']} at "
        f"{config['dataloader_args']['batch_size']} x {config['dataset_args']['num_frms']} "
        f"frames, 8 kHz, {SRE_MELS} mels: " + ", ".join(f"{v:.2f}" for v in steps_ms)
        + f" ms (median of the steps after the first "
        f"{statistics.median(steps_ms[1:] or steps_ms):.2f} ms)")
    run("v2 stage 4", lambda: v2(4, 4))
    run("v2 stages 5-7", lambda: v2(5, 7))
    exported = os.path.join(exp, "exported")
    check(sorted(os.listdir(exported)) == ["avg_model.pt", "config.json", "model.pt2"],
          f"sre: stage 7 wrote {sorted(os.listdir(exported))}")
    # infer_export against bin/extract on one wav of exactly one extraction
    # bucket (200 frames): bin/extract pads nothing, both see the same frames
    one = os.path.join(root, "one.wav")
    write_wav(one, speechlike(np.random.default_rng(SRE_SEED + 1), 16120 / SRE_SR + 1e-6,
                              170.0, SRE_SR)[:16120], SRE_SR)
    Path(root, "one.list").write_text(json.dumps({"key": "one", "wav": one, "spk": "x"}) + "\n")
    _, want = extract(config, os.path.join(root, "one.list"), os.path.join(exp, "avg_model.pt"),
                      None, device=DEVICE)
    got = run("infer_export", lambda: infer_export.infer(
        os.path.join(exported, "model.pt2"),
        infer_export.compute_fbank(one, num_mel_bins=SRE_MELS, device=DEVICE), device=DEVICE))
    out["infer_export_cosine"] = float(cosine(got[0], want[0]))
    # compute_feats, 16 kHz as its signature fixes
    rng = np.random.default_rng(SRE_SEED + 2)
    scp = []
    for i in range(8):
        path = os.path.join(root, "feats", f"u{i}.wav")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_wav(path, speechlike(rng, float(rng.uniform(1.5, 6.0)), rng.uniform(90, 280)))
        scp.append(f"u{i} {path}")
    Path(root, "feats", "wav.scp").write_text("\n".join(scp) + "\n")
    n_feats = run("compute_feats", lambda: tools.compute_feats(
        os.path.join(root, "feats", "wav.scp"), os.path.join(root, "feats", "feats.ark"),
        os.path.join(root, "feats", "feats.scp"), device=DEVICE))
    emb = os.path.join(exp, "embeddings")
    v3_args = ["--config", str(SRE_CONFIG), "--data_root", data, "--cts_dir", cts,
               "--exp_dir", os.path.join(root, "v3"),
               "--eval_sets", "sre16_major,sre16_eval_enroll,sre16_eval_test",
               "--enroll_emb", os.path.join(emb, "sre16_eval_enroll.npz"),
               "--enroll_utt2spk", os.path.join(data, "sre16_eval_enroll", "utt2spk"),
               "--test_emb", os.path.join(emb, "sre16_eval_test.npz"), "--trials", trials,
               "--indomain_emb", os.path.join(emb, "sre16_major.npz"),
               "--device", DEVICE] + overrides
    run("v3 stages 1-2", lambda: sre_v3.main(["--stage", "1", "--stop_stage", "2"] + v3_args))
    run("v3 stage 4", lambda: sre_v3.main(["--stage", "4", "--stop_stage", "4"] + v3_args))
    run("v3 stages 5-8", lambda: sre_v3.main(["--stage", "5", "--stop_stage", "8"] + v3_args))
    out["runs"] = runs
    out["cts_kept"] = len(Path(data, "cts", "wav.scp").read_text().splitlines())
    out["vad_segments"] = len(Path(data, "cts", "vad").read_text().splitlines())
    eers = {ln.split(":")[0]: float(ln.split("EER ")[1].split("%")[0])
            for r in runs.values() for ln in r["printed"]}
    out["eers_random_weights"] = eers
    k1 = {t: runs[t]["k1"] for t in ("v2 stage 4", "v3 stage 4", "compute_feats", "infer_export")}
    out["k1_launches"] = k1
    if DEVICE == "cuda":
        rows = k1_on_inputs([(w, c) for _, w, c in k1_in])
        out["k1_checks"] = rows
        off = sum(r["off_bar"] for r in rows)
        log(f"[sre] K1 on all {len(k1_in)} inputs of the SRE paths against its plain version "
            f"(8 kHz 64 mels and compute_feats' 16 kHz 80 mels; {FBANK_TOL}): {off} elements "
            "past the bar; " + "; ".join(
                f"{tuple(r['shape'])} x{r['batches']} max {r['max_abs_err']:.2e}" for r in rows))
        check(off == 0 and all(r["finite"] for r in rows), f"sre: K1 off its bar {rows}")
        check(all(v > 0 for v in k1.values()) and k1["compute_feats"] == n_feats == 8
              and k1["infer_export"] == 1, f"sre: K1 launches {k1}")
        check(all(runs[t]["k1"] == 0 for t in ("v2 stages 1-3", "v2 stages 5-7",
                                               "v3 stages 1-2", "v3 stages 5-8")),
              f"sre: K1 launched outside the stage 4s {runs}")
    log(f"[sre] front end {out['empty_mel_filters']} empty mel filters (64 mels, 256-point FFT, "
        f"8 kHz); CTS {out['cts_kept']} of 40 kept by the voiced-duration filter "
        f"({out['vad_segments']} SAD segments); infer_export vs bin/extract cosine "
        f"{out['infer_export_cosine']:.7f}; EERs (random weights, 4 steps) {eers}")
    check(out["infer_export_cosine"] >= COS_MIN["f32"],
          f"sre: infer_export vs bin/extract cosine {out['infer_export_cosine']}")
    want_eers = {"cosine", "plda", "plda_adapt", "plda_ctsmean.score",
                 "plda_indomainmean.score", "plda_adapt.score"}
    check(set(eers) == want_eers and all(0 <= v <= 100 for v in eers.values()),
          f"sre: EER lines {eers}")
    check(out["cts_kept"] == 40, f"sre: the voiced-duration filter kept {out['cts_kept']}")
    out["part1_s"] = time.perf_counter() - t_phase

    # Part 2: the back end at full size on the card, then the cut size on the
    # card and on the CPU
    def timer(steps, device):
        def timed(name, fn):
            dev = torch.device(device)
            if dev.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) \
                        as prof:
                    t0 = time.perf_counter()
                    res = fn()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                busy, n = device_busy_us(prof)
                steps[name] = {"s": wall, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                               "device_busy_s": busy / 1e6, "kernels": n,
                               "host_share": 1.0 - busy / 1e6 / wall}
            else:
                t0 = time.perf_counter()
                res = fn()
                steps[name] = {"s": time.perf_counter() - t0, "peak_gb": "not measured",
                               "host_share": "not measured"}
            return res
        return timed

    back = out["backend"] = {}
    full_steps = {}
    if DEVICE == "cuda":
        empty_cache()
    t0 = time.perf_counter()
    full_data = sre_backend_data("full", SRE_SEED + 3, DEVICE)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    back["full_data_s"] = time.perf_counter() - t0
    full = sre_backend(full_data, DEVICE, timer(full_steps, DEVICE))
    del full_data
    back["full"] = {"size": dict(zip(("speakers", "segments", "copies", "adapt", "models",
                                      "test", "trials"), SRE_BACKEND["full"])),
                    "steps": full_steps, "eer": full["eer"], "adapted_eer": full["adapted_eer"],
                    "adapt_info": full["adapt_info"]}
    log(f"[sre backend full] {SRE_BACKEND['full']} (speakers, segments, copies, adaptation, "
        f"models, test, trials), data made on the {DEVICE} in {back['full_data_s']:.2f} s; "
        + "; ".join(f"{k} {_step_line(v)}" for k, v in full_steps.items()))
    log(f"[sre backend full] EER {full['eer']:.3f}% -> {full['adapted_eer']:.3f}% adapted; "
        f"adaptation {full['adapt_info']}")
    check(full["adapted_eer"] < full["eer"] and all(0 < e < 50 for e in (full["eer"],
                                                                      full["adapted_eer"])),
          f"sre backend full: EER {full['eer']} -> {full['adapted_eer']}")
    cut = {}
    for dev in (DEVICE, "cpu"):
        steps = {}
        cut[dev] = sre_backend(sre_backend_data("cut", SRE_SEED + 4, "cpu"), dev,
                               timer(steps, dev))
        cut[dev]["steps"] = steps
    a, b = cut[DEVICE], cut["cpu"]
    errs = {"scores": float(np.abs(a["scores"] - b["scores"]).max()),
            "adapted_scores": float(np.abs(a["adapted_scores"] - b["adapted_scores"]).max()),
            "psi_rel": float(np.linalg.norm(a["psi"] - b["psi"]) / np.linalg.norm(b["psi"])),
            "eer_pp": abs(a["eer"] - b["eer"]), "adapted_eer_pp": abs(a["adapted_eer"]
                                                                      - b["adapted_eer"])}
    back["cut"] = {"size": SRE_BACKEND["cut"], "card_vs_cpu": errs, **{
        dev: {k: v for k, v in r.items() if k in ("steps", "eer", "adapted_eer", "adapt_info")}
        for dev, r in cut.items()}}
    for dev, r in cut.items():
        log(f"[sre backend cut {dev}] EER {r['eer']:.3f}% -> {r['adapted_eer']:.3f}%; adaptation "
            f"{r['adapt_info']}; " + "; ".join(f"{k} {_step_line(v)}"
                                               for k, v in r["steps"].items()))
    log(f"[sre backend cut] card vs CPU {errs} (bars: scores 1e-6, psi 1e-9 relative, EER "
        "0.01 pp)")
    check(errs["scores"] <= 1e-6 and errs["adapted_scores"] <= 1e-6 and errs["psi_rel"] <= 1e-9
          and errs["eer_pp"] <= 0.01 and errs["adapted_eer_pp"] <= 0.01,
          f"sre backend cut: card vs CPU {errs}")
    check(a["adapt_info"]["n_above_1"] == b["adapt_info"]["n_above_1"],
          f"sre backend cut: adaptation {a['adapt_info']} vs {b['adapt_info']}")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[sre] phase {out['wall_s']:.1f} s (part 1 {out['part1_s']:.1f} s)")
    return k1


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    # the port: a missing package is a failure, not a skip
    from wespeaker_hubert_tpu_torch.ops import fbank_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, {kind}, "
        f"{torch.cuda.device_count()} visible; TF32 off for matmul and cuDNN")
    report = {"nvidia_smi": smi, "device": kind, "torch": torch.__version__}
    failures = []

    def run(name, fn, *args):
        try:
            return fn(*args)
        except Exception as e:  # noqa: BLE001 — every phase reports; the run fails below
            traceback.print_exc()
            failures.append(f"{name}: {type(e).__name__}: {e}")
            return None

    t_start = time.perf_counter()
    phase_s = report["phase_s"] = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = run(name, fn, *args)
        phase_s[name] = time.perf_counter() - t0
        return out

    timed("build", phase_build, report)
    k1 = timed("kernel checks", phase_kernel_checks, report)
    k2_row = timed("K2 checks", phase_k2_checks, report)
    with tempfile.TemporaryDirectory() as model_dir:
        write_model_dir(model_dir)
        launches = timed("serve", phase_serve, report, model_dir)
        timed("chunked timing", phase_chunked_timing, report, model_dir)
    timed("bf16 margin", phase_bf16_margin, report)
    with tempfile.TemporaryDirectory() as ssl_dir:
        k2_launches = timed("ssl extract", phase_ssl_extract, report, ssl_dir)
        if k2_launches is not None:
            timed("ssl timing", phase_ssl_timing, report, ssl_dir)
    k2_bwd_row = timed("K2 bwd checks", phase_k2_bwd_checks, report)
    with tempfile.TemporaryDirectory() as train_dir:
        train_launches = timed("train", phase_train, report, train_dir)
        if train_launches is not None:
            timed("train checks", phase_train_checks, report, train_dir)
    NET_TEMPLATES.clear()
    with tempfile.TemporaryDirectory() as recipe_dir:
        recipe_launches = timed("recipe", phase_recipe, report, recipe_dir)
        # the same data directory: stages 1-2 run again on it
        resnet_launches = timed("resnet recipe", phase_resnet_recipe, report, recipe_dir)
        campplus_launches = timed("campplus recipe", phase_campplus_recipe, report, recipe_dir)
        redimnet_launches = timed("redimnet recipe", phase_redimnet_recipe, report, recipe_dir)
        gemini_launches = timed("gemini recipe", phase_gemini_recipe, report, recipe_dir)
        wavlm_launches = timed("wavlm recipe", phase_wavlm_recipe, report, recipe_dir)
        NET_TEMPLATES.clear()
        # self-supervised training: DINO, then the CN-Celeb fine-tune from its
        # teacher, then MoCo and SimCLR, on the same data
        dino = timed("dino recipe", phase_dino_recipe, report, recipe_dir)
        cnceleb_launches = timed("cnceleb finetune", phase_cnceleb_finetune, report, recipe_dir)
        contrastive_launches = timed("contrastive recipe", phase_contrastive_recipe, report,
                                     recipe_dir)
    timed("ecapa step check", phase_ecapa_step_check, report)
    timed("resnet step check", phase_resnet_step_check, report)
    timed("zoo step check", phase_zoo_step_check, report)
    with tempfile.TemporaryDirectory() as whisper_dir:
        whisper_launches = timed("whisper recipe", phase_whisper_recipe, report, whisper_dir)
    with tempfile.TemporaryDirectory() as score_dir:
        timed("score", phase_score, report, score_dir)
    with tempfile.TemporaryDirectory() as diar_dir:
        diar_launches = timed("diarization", phase_diarization, report, diar_dir)
    with tempfile.TemporaryDirectory() as sre_dir:
        sre_launches = timed("sre", phase_sre, report, sre_dir)
    t0 = time.perf_counter()
    collect_deferred(failures)
    phase_s["waiting for the deferred checks"] = time.perf_counter() - t0
    report["wall_s"] = time.perf_counter() - t_start
    report["failures"] = failures
    report["k1_history"] = {
        "source": "PERF.md's kernel table, the earlier dense-DFT K1 (H100 80GB HBM3, "
                  "700.00 W); not measured by this script",
        "ms": {f"({b}, {w}) 80 mels": ms for (b, w), ms in K1_DENSE_DFT_MS.items()}}
    report["k2_history"] = {
        "source": "PERF.md's kernel table, the earlier mma.sync kernels (H100 80GB HBM3, "
                  "700.00 W); not measured by this script",
        "ms": {f"{kind} ({b}, {t}, 16, 64) bf16": ms
               for (kind, b, t), ms in MMA_SYNC_MS.items()}}
    log("[time] " + ", ".join(f"{k} {v:.1f} s" for k, v in phase_s.items())
        + f"; total {report['wall_s']:.1f} s")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    if (failures or k1 is None or launches is None or k2_row is None or k2_launches is None
            or k2_bwd_row is None or train_launches is None or recipe_launches is None
            or resnet_launches is None or whisper_launches is None or campplus_launches is None
            or wavlm_launches is None or redimnet_launches is None or gemini_launches is None
            or dino is None or cnceleb_launches is None or contrastive_launches is None
            or diar_launches is None or sre_launches is None):
        for f in failures:
            print(f"chip_smoke FAILED {f}", file=sys.stderr)
        return 1

    kernels = [{
        "name": "fbank",
        "route": "cuda",
        "source": "wespeaker_hubert_tpu_torch/csrc/fbank.cu",
        "replaces": "wespeaker_hubert_tpu/ops/fbank_pallas.py:117",
        "launches": launches["bf16"],
        "launches_f32_service": launches["f32"],
        "launches_recipe": recipe_launches,
        "launches_recipe_scope": "recipes.voxceleb_v2 stage 4: extraction of both lists",
        "launches_resnet_recipe": {"stage 4": resnet_launches[0],
                                   "stage 9 (its stage 4)": resnet_launches[1]},
        "launches_campplus_recipe": {"stage 4": campplus_launches[0],
                                     "stage 9 (its stage 4)": campplus_launches[1]},
        "launches_redimnet_recipe": {"stage 4 (72 mels)": redimnet_launches[0]},
        "launches_gemini_recipe": {"stage 4": gemini_launches[0],
                                   "stage 9 (its stage 4)": gemini_launches[1]},
        "launches_moco_recipe": {"stage 4": contrastive_launches["moco"]},
        "launches_simclr_recipe": {"stage 4": contrastive_launches["simclr"]},
        "launches_cnceleb_finetune": {"stage 4": cnceleb_launches},
        "launches_diarization": diar_launches,
        "launches_diarization_scope": "voxconverse_v2 (spectral, density) and voxconverse_v1 "
                                      "(oracle, system SAD) over 4 conversations of 120-600 s; "
                                      "8 concurrent /diarize posts",
        "launches_sre": sre_launches,
        "launches_sre_scope": "recipes.sre_v2 and sre_v3 stage 4 (8 kHz, 64 mels), "
                              "bin/tools compute_feats (8 utterances), bin/infer_export",
        "at_sre_shapes": [{k: r[k] for k in ("shape", "mels", "sample_rate", "max_abs_err", "ms",
                                             "plain_ms", "bound_ms", "bound_by", "library_ms")}
                          for r in report["fbank_checks"] if r["sample_rate"] == SRE_SR],
        "max_abs_err": max(r["max_abs_err"] for r in report["fbank_checks"]),
        "max_err": max(r["max_abs_err"] for r in report["fbank_checks"]),
        "ms": k1["ms"],
        "kernel_ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "roofline_share": k1["roofline_share"],
        "needed_gflop": k1["needed_gflop"],
        "library_ms": k1["library_ms"],
        "library_scope": "the plain rFFT path: torch.fft.rfft (cuFFT) + the mel matmul, "
                         "not one call",
        "shape": k1["shape"],
    }, {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "wespeaker_hubert_tpu_torch/csrc/flash_attention.cu",
        "replaces": "wespeaker_hubert_tpu/frontend/ssl_encoder.py:281",
        "launches": k2_launches,
        "launches_per_device_batch": 24,
        "max_abs_err": max(r["max_abs_err"] for r in report["k2_checks"] if r["dtype"] == "bf16"),
        "max_abs_err_f32": max(r["max_abs_err"] for r in report["k2_checks"] if r["dtype"] == "f32"),
        "ms": k2_row["ms"],
        "ms_scope": k2_row["ms_scope"],
        "wrapper_ms": k2_row["wrapper_ms"],
        "host_us_per_call": k2_row["host_us"],
        "tile_n": k2_row["tile_n"],
        "plain_ms": k2_row["plain_ms"],
        "bound_ms": k2_row["bound_ms"],
        "bound_by": k2_row["bound_by"],
        "roofline_share": k2_row["roofline_share"],
        "library_ms": k2_row["library_ms"],
        "library_scope": "scaled_dot_product_attention on the materialized bias",
        "materialize_bias_ms": k2_row["materialize_bias_ms"],
        "shape": k2_row["shape"],
        "bias": "factored gated bias: (h, T, T) table + (B, h, T) gate",
        "dtype": k2_row["dtype"],
        "launches_train": train_launches[0],
        "launches_wavlm_recipe": {f"stage {k}": v["fwd"] for k, v in wavlm_launches.items()},
    }]
    bwd_rows = [r for r in report["k2_bwd_checks"] if r["dtype"] == "bf16"]
    for name, key, outputs, launched in (
            ("flash_attention_bwd_dkv", "dkv", ("dk", "dv"), train_launches[1]),
            ("flash_attention_bwd_dq", "dq", ("dq", "dbias", "dgate", "delta", "dtable"),
             train_launches[2])):
        wavlm = {f"stage {k}": v[key] for k, v in wavlm_launches.items()}
        line = {
            "name": name,
            "route": "cuda",
            "source": "wespeaker_hubert_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": ("jax/experimental/pallas/ops/tpu/flash_attention.py:"
                         + ("941" if key == "dkv" else "1287")),
            "called_from": "wespeaker_hubert_tpu/frontend/ssl_encoder.py:281",
            "launches": launched,
            "launches_per_train_step": 24,
            "launches_wavlm_recipe": wavlm,
            "max_abs_err": max(r["max_abs_err"][o] for r in bwd_rows for o in outputs
                               if o in r["max_abs_err"]),
            "min_cosine": min(r["cosine"][o] for r in bwd_rows for o in outputs
                              if o in r["cosine"]),
            "max_abs_err_f32": max(r["max_abs_err"][o] for r in report["k2_bwd_checks"]
                                   if r["dtype"] == "f32" for o in outputs
                                   if o in r["max_abs_err"]),
            "ms": k2_bwd_row[key + "_ms"],
            ("tile_q" if key == "dkv" else "tile_k"): k2_bwd_row["tile_q"],
            "backward_ms": k2_bwd_row["ms"],
            "backward_host_us_per_call": k2_bwd_row["host_us"],
            "plain_ms": k2_bwd_row["plain_ms"],
            "plain_scope": "the whole plain backward (dq, dk, dv, dbias)",
            "bound_ms": k2_bwd_row[key + "_bound_ms"],
            "bound_by": k2_bwd_row[key + "_bound_by"],
            "backward_bound_ms": k2_bwd_row["bound_ms"],
            "library_ms": k2_bwd_row["library_bwd_ms"],
            "library_scope": "scaled_dot_product_attention's backward alone (dq, dk, dv in one "
                             "fused kernel; EFFICIENT_ATTENTION pinned, the materialized bias "
                             "as attn_mask, no mask gradient)",
            "library_fwd_bwd_ms": k2_bwd_row["library_ms"],
            "shape": k2_bwd_row["shape"],
            "dtype": k2_bwd_row["dtype"],
        }
        if line["ms"] is None:  # the profiler traced no device time
            line["ms"], line["ms_scope"] = k2_bwd_row["ms"], "the whole backward (both kernels)"
        line["roofline_share"] = line["bound_ms"] / line["ms"]
        kernels.append(line)
    # the float32 instances, at Whisper's shapes, on the Whisper recipe's path;
    # all three run 3xTF32 on the tensor cores (their bound_ms)
    fwd_rows = {tuple(r["shape"][:2]): r for r in report["k2_whisper_checks"]
                if r["dtype"] == "f32" and "max_abs_s" not in r}
    large = [r for r in report["k2_whisper_checks"] + report["k2_whisper_bwd_checks"]
             if "max_abs_s" in r]
    bwd_row = next(r for r in report["k2_whisper_bwd_checks"]
                   if r["dtype"] == "f32" and "max_abs_s" not in r)
    wl = whisper_launches
    fwd = fwd_rows[WHISPER_K2_FWD[1]]
    kernels.append({
        "name": "flash_fwd_f32_sm90",
        "route": "cuda",
        "source": "wespeaker_hubert_tpu_torch/csrc/flash_attention.cu",
        "replaces": "wespeaker_hubert_tpu/frontend/ssl_encoder.py:281",
        "called_from": "wespeaker_hubert_tpu/frontend/whisper.py:100",
        "launches": wl[3]["fwd"] + wl[4]["fwd"] + wl[7]["fwd"],
        "launches_by_stage": {"3": wl[3]["fwd"], "4": wl[4]["fwd"], "5": wl[7]["fwd"]},
        "max_abs_err": max(r["max_abs_err"] for r in fwd_rows.values()),
        "max_abs_err_large_logits": {str(r["shape"]): r["max_abs_err_vs_f64"] | {
            "vs_plain": r["max_abs_err"]} for r in large if "kernel" in r},
        "ms": fwd["ms"], "ms_scope": fwd["ms_scope"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["tf32x3_bound_ms"], "bound_by": fwd["tf32x3_bound_by"],
        "bound_scope": "3 x the FLOP at the tf32 tensor-core peak (3xTF32, the design)",
        "bound_fp32_cuda_cores_ms": fwd["bound_ms"],
        "roofline_share": fwd["tf32x3_roofline_share"], "library_ms": fwd["library_ms"],
        "library_scope": "scaled_dot_product_attention, scale 1.0, no mask",
        "shape": fwd["shape"], "dtype": "f32",
        "at_other_shapes": [{k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                               "tf32x3_bound_ms", "library_ms", "max_abs_err")}
                            for key, r in fwd_rows.items() if key != WHISPER_K2_FWD[1]],
    })
    for name, key in (("flash_bwd_dkv_f32_sm90", "dkv"), ("flash_bwd_dq_f32_sm90", "dq")):
        ms = bwd_row[key + "_ms"]
        outputs = ("dk", "dv") if key == "dkv" else ("dq", "delta")
        line = {
            "name": name,
            "route": "cuda",
            "source": "wespeaker_hubert_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": ("jax/experimental/pallas/ops/tpu/flash_attention.py:"
                         + ("941" if key == "dkv" else "1287")),
            "called_from": "wespeaker_hubert_tpu/frontend/whisper.py:100",
            "launches": wl[4][key],
            "launches_scope": "stage 4 (joint fine-tuning); stages 3 and 5 run no backward",
            "max_abs_err": max(bwd_row["max_abs_err"][o] for o in outputs),
            "max_abs_err_large_logits": [{o: r["max_abs_err_vs_f64"][o] | {
                "bar_vs_f64": r["bar_vs_f64"][o]} for o in outputs if o in r["bar_vs_f64"]}
                for r in large if "bar_vs_f64" in r],
            "ms": ms if ms is not None else bwd_row["ms"],
            "ms_scope": "profiler device time" if ms is not None
            else "the whole backward (both kernels), events",
            "plain_ms": bwd_row["plain_ms"],
            "plain_scope": "the whole plain backward (dq, dk, dv)",
            "bound_ms": bwd_row[key + "_tf32x3_bound_ms"],
            "bound_by": bwd_row[key + "_tf32x3_bound_by"],
            "bound_scope": "3 x the FLOP at the tf32 tensor-core peak (3xTF32, the design)",
            "bound_fp32_cuda_cores_ms": bwd_row[key + "_bound_ms"],
            "library_ms": bwd_row["library_ms"],
            "library_scope": "scaled_dot_product_attention's backward alone, scale 1.0 "
                             f"({bwd_row['sdpa']['backend']} pinned; dq, dk, dv in one fused "
                             "kernel: " + "; ".join(bwd_row["sdpa"]["bwd_kernels"]) + ")",
            "library_fwd_bwd_ms": bwd_row["library_fwd_bwd_ms"],
            "shape": bwd_row["shape"], "dtype": "f32",
        }
        line["roofline_share"] = line["bound_ms"] / line["ms"]
        kernels.append(line)
    log(json.dumps({"kernels": kernels}))
    log(f"[device] {smi}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
