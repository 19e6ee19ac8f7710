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
     (2 epochs of 8 steps; lm 1 epoch of 4 steps), on phase 12's data:
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
     OpenAI-layout checkpoint for stage 3 and the run's length (4 frozen
     steps at batch 64 x 5 s, 6 joint steps at batch 16), on seeded
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
     fine-tune at 64 x 6 s, margin 0.5) with phase 14's cut and checks, on
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
     and 3 timed steps at 128 x 2 s.

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


def device_busy_us(prof):
    """Union of the device-event intervals of a torch.profiler run (us)."""
    spans = sorted(
        (ev.time_range.start, ev.time_range.end) for ev in prof.events()
        if ev.device_type == torch.autograd.DeviceType.CUDA
        and ev.time_range.end > ev.time_range.start
    )
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
    # batches of 32 in EvalPipeline's 400- and 800-frame buckets), then 40 mels
    cases = [(16, 480000, 80), (16, 32000, 80), (1, 32240, 80), (32, 64240, 80),
             (32, 128240, 80), (16, 32000, 40)]
    rows = []
    for i, (b, w, m) in enumerate(cases):
        cfg = FbankConfig(num_mel_bins=m, spectrum_impl="kernel")
        rng = np.random.default_rng(100 + i)
        wav = torch.from_numpy(
            (rng.standard_normal((b, w)) * 0.1).astype(np.float32)
        ).cuda()
        fft_cfg = FbankConfig(num_mel_bins=m, spectrum_impl="fft")
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
        row = dict(shape=[b, w], mels=m, max_abs_err=err, max_abs_err_vs_fft_path=fft_err,
                   fft_path_off_plain=fft_off_n,
                   fft_path_max_abs_err=float((fft - want).abs().max()),
                   max_abs_err_vs_float64=vs64, ok=ok, ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound_ms,
                   bound_by=bound_by, needed_gflop=flop / 1e9, mbytes=nbytes / 1e6,
                   earlier_dense_dft_gflop=dense_flop / 1e9, roofline_share=bound_ms / k_ms)
        rows.append(row)
        earlier = K1_DENSE_DFT_MS.get((b, w))
        log(f"[K1] ({b}, {w}) mels={m}: max|err|={err:.3e} against the plain version, "
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
    """(name, device us, calls) of the device events, largest first."""
    rows = [
        (ev.key, ev.self_device_time_total, ev.count)
        for ev in prof.key_averages()
        if ev.device_type == torch.autograd.DeviceType.CUDA
        and ev.self_device_time_total > 0
    ]
    return sorted(rows, key=lambda r: -r[1])


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
    torch.manual_seed(0)
    net = build_speaker_net(cfg, 3 * TRAIN_SPEAKERS)
    load_speaker_state(net, torch.load(os.path.join(root, "init.pt"), weights_only=True))
    net.to(device)
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


def speechlike(rng, seconds, f0):
    """Two harmonics of f0 under a syllable-rate envelope over a noise floor,
    on the int16 grid."""
    t = np.arange(int(seconds * SR)) / SR
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
    input the run hands it, in order, and calls the wrapper unchanged, so
    each launch counts as the run's.  The copies are the only change to the
    run."""

    def __init__(self, module):
        self.module, self.fn, self.inputs = module, module.fbank_kernel, []

    def __enter__(self):
        def spy(wav, cfg):
            self.inputs.append(wav.clone())
            return self.fn(wav, cfg)
        self.module.fbank_kernel = spy
        return self

    def __exit__(self, *exc):
        self.module.fbank_kernel = self.fn


def k1_on_eval_batches(lists, caught=None):
    """K1 against its plain version and a float64 log-mel on every batch
    that EvalPipeline (bin/extract's batching, batch 32, 80 mels) makes of
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

    cfg = FbankConfig(num_mel_bins=80, dither=0.0, spectrum_impl="matmul")
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
            plain_off = ~torch.isclose(want.double(), truth, **FBANK_TOL)
            held = torch.where(plain_off, torch.isclose(got.double(), truth, **FBANK_TOL),
                               torch.isclose(got, want, **FBANK_TOL))
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


def recipe_against_cpu(data, exp, out, config=None, tag="recipe"):
    """What stages 4-6 wrote on the card against the CPU: the embeddings of
    the first 16 eval utterances by bin/extract on the CPU (the plain fbank,
    from the same avg_model.pt, `config`), and the cosine and AS-Norm score
    files recomputed on the CPU from the card's embeddings.  Returns the
    failures."""
    from wespeaker_hubert_tpu_torch.bin.extract import extract
    from wespeaker_hubert_tpu_torch.bin.score import score_norm, score_trials
    from wespeaker_hubert_tpu_torch.recipes import voxceleb_v2
    from wespeaker_hubert_tpu_torch.utils.embeddings import embeddings_dict

    emb_dir, score_dir = os.path.join(exp, "embeddings"), os.path.join(exp, "scores")
    cpu_dir = os.path.join(exp, "cpu_check")
    sub = os.path.join(cpu_dir, "vox1_16.list")
    os.makedirs(cpu_dir, exist_ok=True)
    lines = Path(data, "vox1", "raw.list").read_text().splitlines()[:16]
    Path(sub).write_text("\n".join(lines) + "\n")
    card = embeddings_dict(os.path.join(emb_dir, "vox1.npz"))
    keys, emb = extract(str(config or RECIPE_CONFIG), sub, os.path.join(exp, "avg_model.pt"), "",
                        device="cpu")
    cos = [cosine(card[k], e) for k, e in zip(keys, emb)]
    trials = os.path.join(data, "vox1", "vox1_O_cleaned.kaldi")
    mean_vec = os.path.join(emb_dir, "vox2_dev_mean.npy")
    cpu_score = score_trials(os.path.join(emb_dir, "vox1.npz"), [trials], cpu_dir, mean_vec,
                             device="cpu")[0]
    card_score = os.path.join(score_dir, os.path.basename(trials) + ".score")
    cpu_norm = score_norm(card_score, cpu_score + ".asnorm", os.path.join(emb_dir, "vox1.npz"),
                          os.path.join(emb_dir, "vox2_dev_spk_mean.npz"),
                          top_n=voxceleb_v2.parse_args([]).asnorm_top_n,
                          mean_vec_path=mean_vec, device="cpu")
    # the bars of phase_score, plus one rounding step of the files' {:.5f}
    score_err = float(np.abs(_score_column(card_score, 2) - _score_column(cpu_score, 2)).max())
    norm_err = float(np.abs(_score_column(card_score + ".asnorm", 2)
                            - _score_column(cpu_norm, 2)).max())
    out["against_cpu"] = {"embeddings": len(cos), "min_cosine": min(cos),
                          "cosine_bar": COS_MIN["f32"], "score_max_abs_err": score_err,
                          "asnorm_max_abs_err": norm_err, "score_bar": 1e-5 + 1.1e-5,
                          "asnorm_bar": 2e-4 + 1.1e-5}
    log(f"[{tag}] against the CPU: {len(cos)} stage-4 embeddings, min cosine {min(cos):.7f} "
        f"(bar {COS_MIN['f32']}); stage-5 scores max|d| {score_err:.2e} (bar 2.1e-5), stage-6 "
        f"AS-Norm max|d| {norm_err:.2e} (bar 2.11e-4)")
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
    from wespeaker_hubert_tpu_torch.train.state import TrainState, make_optimizer

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
    state = TrainState(net, make_optimizer(net), lr)
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
                          f"{3 * len(spk2id)} classes")
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
    # K1 on every input stage 4 gave it, against its plain version (the card only)
    k1_rows, k1_matched = k1_on_eval_batches(
        [os.path.join(data, d, "raw.list") for d in ("vox1", "vox2_dev")],
        k1_spy.inputs) if DEVICE == "cuda" else ([], False)
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
    cpu_bad = recipe_against_cpu(data, exp, out)
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


def _ecapa_net(device, num_steps=1, config_path=None, seed=ECAPA_CHECK_SEED):
    """A recipe config's model (the flagship ECAPA_TDNN_GLOB_c512 unless
    `config_path` names another) + ArcMargin over 17,982 classes with seeded
    weights, float32, dither 0 and SpecAug off, on `device`."""
    from wespeaker_hubert_tpu_torch.bin.train import _feature_cfg
    from wespeaker_hubert_tpu_torch.models.speaker_net import build_speaker_net, load_speaker_state
    from wespeaker_hubert_tpu_torch.train.executor import make_train_step
    from wespeaker_hubert_tpu_torch.train.schedulers import ExponentialDecrease, MarginSchedule
    from wespeaker_hubert_tpu_torch.train.state import TrainState, make_optimizer
    from wespeaker_hubert_tpu_torch.utils.config import load_config

    config = load_config(str(config_path or RECIPE_CONFIG))
    config["dataset_args"]["fbank_args"]["dither"] = 0.0
    config["dataset_args"]["spec_aug"] = False
    torch.manual_seed(0)
    net = build_speaker_net(config, 3 * RECIPE_SPEAKERS)
    load_speaker_state(net, seeded_state_dict(net, seed))
    net.to(device)
    lr = ExponentialDecrease(num_epochs=2, epoch_iter=4, initial_lr=0.1, final_lr=5e-5,
                             warm_up_epoch=1)
    state = TrainState(net, make_optimizer(net), lr)
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
# the recipes' cut (ResNet34, CAM++): 2 epochs of 8 steps, and 4 lm steps
# (PERF.md section 4 lists the earlier, longer cut)
RECIPE_EPOCH_STEPS, RECIPE_LM_STEPS = 8, 4
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
    return recipe_1_to_9(report, root, "resnet", RESNET_CONFIG, RESNET_LM_CONFIG,
                         ([1] * 2 * RECIPE_EPOCH_STEPS, [1] * RECIPE_LM_STEPS))


def recipe_1_to_9(report, root, fam, config_path, lm_config_path, want_calls):
    """recipes.voxceleb_v2 stages 1-9 on the card with a recipe config and
    its lm config as the port's reader parses them, overriding only paths
    and the run's length (base: 2 epochs of RECIPE_EPOCH_STEPS steps of 128
    x 200 frames, 2 checkpoints averaged; lm: 1 epoch of RECIPE_LM_STEPS
    steps of 64 x 600 frames, num_avg 1), on write_recipe_data's 1,536
    utterances in 2 shards.  Three calls, each with K1's count set to 0 just
    before and read just after: stages 1-3, stages 4-8, stage 9 (stages 3-8
    of the lm config).  Then the checks: the train step calls `want_calls`
    (base, lm), K1 on every stage-4 input (the base's, and the lm run's
    equal to them), 16 stage-4 embeddings and the score files against the
    CPU, the stage-8 program (torch.export.load) against the eager model on
    the card, the exported directory through cli.speaker.Speaker against
    stage 4, and 3 profiled base steps.  `fam` names the report's key and
    the log's tag.  Returns the K1 launches of the two stage 4s."""
    import logging

    from wespeaker_hubert_tpu_torch.bin import train as bin_train
    from wespeaker_hubert_tpu_torch.bin.export_model import load_program
    from wespeaker_hubert_tpu_torch.cli.speaker import Speaker
    from wespeaker_hubert_tpu_torch.models.speaker_net import build_speaker_net, load_speaker_state
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
    # the overrides: paths and the length of the run, nothing else
    overrides = ([f"exp_dir={exp}"] + paths
                 + ["num_epochs=2", f"epoch_iter={RECIPE_EPOCH_STEPS}", "save_epoch_interval=1",
                    "num_avg=2"]
                 + [f"lm.exp_dir={exp_lm}"] + ["lm." + o for o in paths]
                 + ["lm.num_epochs=1", f"lm.epoch_iter={RECIPE_LM_STEPS}",
                    "lm.save_epoch_interval=1", "lm.num_avg=1"])
    out["overrides"] = overrides
    common = ["--config", str(config_path), "--lm_config", str(lm_config_path),
              "--data_root", data, "--trials", trials, "--device", DEVICE] + overrides
    records = []
    handler = logging.Handler()
    handler.emit = lambda rec: records.append(rec.getMessage())
    for name in ("extract", "train"):
        logging.getLogger(name).addHandler(handler)
    make = bin_train.make_train_step
    runs = {}
    try:
        for tag, stages in (("base", (1, 3)), ("export", (4, 8)), ("lm", (9, 9))):
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
    done = {**runs["base"]["done"], **runs["export"]["done"], **runs["lm"]["done"]}
    lm_done = done[9]["stages"]
    base_cfg, lm_cfg = voxceleb_v2.load_configs(voxceleb_v2.parse_args(common))

    def steps(tag, cfg):
        calls = runs[tag]["timer"].calls
        ms = 1e3 * sum(t for _, t in calls[1:]) / max(1, sum(n for n, _ in calls[1:]))
        chunk_s = cfg["dataset_args"]["num_frms"] / 100
        batch = cfg["dataloader_args"]["batch_size"]
        return {"calls": [n for n, _ in calls], "step_ms_per_call": [1e3 * t / n for n, t in calls],
                "step_ms_after_first": ms, "audio_s_per_s": batch * chunk_s / (ms / 1e3),
                "batch": batch, "chunk_s": chunk_s, "margins": runs[tag]["timer"].margins,
                "peak_mem_gb": runs[tag]["peak_gb"]}

    out["train"] = {"base": steps("base", base_cfg), "lm": steps("lm", lm_cfg)}
    extract_base, rate_base = _stage_rates(runs["export"]["records"])
    extract_lm, rate_lm = _stage_rates(runs["lm"]["records"])
    init_lines = [r for r in runs["lm"]["records"] if r.startswith("model_init")]
    audio = seconds["vox1"] + seconds["vox2_dev"]
    out.update({
        "stage_s": {s: d["s"] for s, d in done.items()},
        "lm_stage_s": {s: d["s"] for s, d in lm_done.items()},
        "lines": {s: d["lines"] for s, d in done.items() if d.get("lines")},
        "lm_lines": {s: d["lines"] for s, d in lm_done.items() if d["lines"]},
        "k1_launches": {t: runs[t]["k1"] for t in runs},
        "extract_log": {"base": extract_base, "lm": extract_lm},
        "extract_audio_s_per_s": {"base": rate_base, "lm": rate_lm},
        "extract_stage4_audio_s_per_s": {"base": audio / done[4]["s"],
                                         "lm": audio / lm_done[4]["s"]},
        "lm_model_init": init_lines})
    for tag in ("base", "lm"):
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
        + f"; loop rates {rate_base:.0f} / {rate_lm:.0f} audio-s/s, stage wall rates "
        f"{out['extract_stage4_audio_s_per_s']['base']:.0f} / "
        f"{out['extract_stage4_audio_s_per_s']['lm']:.0f}; K1 launches {out['k1_launches']}")
    for s in (5, 6, 7):
        log(f"[{fam}] stage {s}: base " + "; ".join(done[s]["lines"]) + " | lm "
            + "; ".join(lm_done[s]["lines"]))
    log(f"[{fam}] stage 8: " + "; ".join(done[8]["lines"] + lm_done[8]["lines"])
        + f"; the lm run's {init_lines}")

    # the CPU's checks in a thread, beside the card's untimed ones below
    pool = ThreadPoolExecutor(1)
    cpu_run = pool.submit(recipe_against_cpu, data, exp, out, config_path, fam)
    try:
        # K1 on every stage-4 input: the base's against its plain version, and
        # the lm run's stage 4 gave it the same batches
        base_in, lm_in = runs["export"]["k1_inputs"], runs["lm"]["k1_inputs"]
        k1_rows, k1_matched = k1_on_eval_batches(
            [os.path.join(data, d, "raw.list") for d in ("vox1", "vox2_dev")],
            base_in) if DEVICE == "cuda" else ([], False)
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

        # the stage-8 program against the eager model, on the card
        program_cos = {}
        for d, cfg in ((exp, base_cfg), (exp_lm, lm_cfg)):
            exported = os.path.join(d, "exported")
            program = load_program(os.path.join(exported, "model.pt2"), device=DEVICE)
            net = build_speaker_net(json.loads(Path(exported, "config.json").read_text()))
            load_speaker_state(net, torch.load(os.path.join(exported, "avg_model.pt"),
                                               weights_only=True))
            net.to(DEVICE).eval()
            for b, t in PROGRAM_SHAPES:
                feats = torch.from_numpy(np.random.default_rng(b * t).standard_normal(
                    (b, t, cfg["model_args"]["feat_dim"])).astype(np.float32)).to(DEVICE)
                with torch.inference_mode():
                    got, want = program(feats), net.embed(feats)
                program_cos[f"{os.path.basename(d)} ({b}, {t})"] = float(
                    torch.nn.functional.cosine_similarity(got.float(), want, dim=1).min())
            del program, net
        out["program_min_cosine"] = program_cos
        log(f"[{fam}] stage-8 torch.export program on the card against the eager model: min cosine "
            + ", ".join(f"{k} {v:.7f}" for k, v in program_cos.items())
            + f" (bar {COS_MIN['f32']})")

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

    check(sorted(done) == list(range(1, 10)) and sorted(lm_done) == list(range(3, 9)),
          f"{fam}: stages {sorted(done)}, stage 9's {sorted(lm_done)}")
    check(out["train"]["base"]["calls"] == want_calls[0]
          and out["train"]["lm"]["calls"] == want_calls[1],
          f"{fam}: step calls {out['train']['base']['calls']} / {out['train']['lm']['calls']}")
    check(set(out["train"]["lm"]["margins"]) == {0.5},
          f"{fam}: the lm run's margins {out['train']['lm']['margins']}")
    check(init_lines == [f"model_init from {exp}/avg_model.pt (epoch 0, 0 missing, 0 unexpected)"],
          f"{fam}: the lm run's initialization {init_lines}")
    k1 = out["k1_launches"]
    check(k1["base"] == 0 and n_caught["stage 3"] == 0,
          f"{fam}: the dithered train step launched K1 {k1['base']} times")
    check(k1["export"] > 0 and k1_matched and n_caught["base"] == k1["export"],
          f"{fam}: stage 4's K1 inputs do not match EvalPipeline's batches ({n_caught}, {k1})")
    check(lm_same and k1["lm"] == k1["export"],
          f"{fam}: the lm run's K1 launches {k1['lm']} are not its stage 4's")
    check(all(r["off_bar"] == 0 and r["finite"] for r in k1_rows),
          f"{fam}: K1 disagrees with its plain version on a stage-4 input")
    check(not cpu_bad, f"{fam}: " + "; ".join(cpu_bad))
    check(min(program_cos.values()) >= COS_MIN["f32"], f"{fam}: program vs eager {program_cos}")
    check(min(speaker_cos) >= SPEAKER_COS_MIN, f"{fam}: Speaker vs stage 4 {speaker_cos}")
    for s in (5, 6, 7):
        for lines in (done[s]["lines"], lm_done[s]["lines"]):
            check(len(lines) == 1 and " EER " in lines[0], f"{fam}: stage {s} printed {lines}")
    return k1["export"], k1["lm"]


def phase_resnet_step_check(report):
    """One float32 train step of ResNet34 at full width (resnet34.yaml: 32
    channels, 80 mels, 256-d, TSTP, ArcMargin over 17,982 classes; batch 16
    x 2 s) on the card against the CPU, by step_vs_cpu."""
    report["resnet_step_check"] = step_vs_cpu(RESNET_CONFIG, RESNET_CHECK_SEED, "resnet step")


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
    that size, and the bar is relative to it.  Returns the report entry."""
    batch = _ecapa_check_batch(seed, RESNET_CHECK_BATCH)
    res = {}
    for kind, dev, scale in (("card", DEVICE, False), ("cpu", "cpu", False),
                             ("control", DEVICE, True)):
        net, state, step = _ecapa_net(dev, config_path=config_path, seed=seed)
        b = {k: v.to(dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        res[kind] = _one_step(net, state, step, _perturbed(b) if scale else b, prefix="")
        res[kind + "_s"] = time.perf_counter() - t0
        del net, state, step
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
        "cpu_step_s": res["cpu_s"], "card_step_s_first": res["card_s"]}
    name = Path(config_path).stem
    log(f"[{tag}] f32 {name} step at full width ({3 * RECIPE_SPEAKERS} classes, batch "
        f"{RESNET_CHECK_BATCH} x 2 s), card vs CPU: loss {res['card'][0]:.6f} vs "
        f"{res['cpu'][0]:.6f} (rel {loss_rel:.2e}, bar 1e-5); updates relative L2 "
        f"{out['updates_rel_l2']:.2e} (control {out['control_updates_rel_l2']:.2e}); of "
        f"{len(pair)} tensors {how['cosine']} at cosine >= 0.9999, {how['within_control']} "
        f"within the control, {how['noise_floor']} at the noise floor, {len(failing)} failing; "
        f"least cosines {worst}; CPU step {res['cpu_s']:.1f} s")
    check(loss_rel <= 1e-5 and not failing, f"{tag}: {name}'s card step vs CPU step")
    return out


# ----------------------------------------------- CAM++, Res2Net, ERes2Net
CAMPPLUS_CONFIG = Path(__file__).resolve().parent / "examples/voxceleb/v2/conf/campplus.yaml"
CAMPPLUS_LM_CONFIG = Path(__file__).resolve().parent / "examples/voxceleb/v2/conf/campplus_lm.yaml"
ZOO_CONFIGS = {name: Path(__file__).resolve().parent / f"examples/voxceleb/v2/conf/{name}.yaml"
               for name in ("eres2net", "res2net")}
ZOO_CHECK_SEED = 20251023
ZOO_TIMED_BATCH, ZOO_TIMED_STEPS = 128, 3  # the recipe's batch, 2 s chunks


def phase_campplus_recipe(report, root):
    """recipes.voxceleb_v2 stages 1-9 on the card with campplus.yaml and
    campplus_lm.yaml as the port's reader parses them (CAMPPlus, 80 mels,
    512-d, TSTP, ArcMargin over 3 x 5,994 classes, batch 128 x 2 s,
    `loop_steps: 8`, float32; the lm fine-tune at batch 64 x 600 frames,
    margin 0.5), by recipe_1_to_9 on phase_recipe's data.  Returns the K1
    launches of the two stage 4s."""
    # loop_steps 8: an epoch of 8 steps is one 8-step call
    return recipe_1_to_9(report, root, "campplus", CAMPPLUS_CONFIG, CAMPPLUS_LM_CONFIG,
                         ([8] * 2, [1] * RECIPE_LM_STEPS))


def phase_zoo_step_check(report):
    """ERes2Net34_Base (eres2net.yaml: 32 channels, 512-d) and
    Res2Net34_Base (res2net.yaml: 32 channels, 256-d) at full width with
    seeded weights: (a) one float32 train step on the card against the CPU
    (step_vs_cpu); (b) eval embeddings of a padded batch through
    make_eval_embed with K1 (3 x 3 s, lengths 3, 1.9 and 0.8 s), the card
    against the CPU's plain path, cosine >= 0.99999; (c) ZOO_TIMED_STEPS
    float32 steps at batch 128 x 2 s on the card, each timed with a device
    synchronize after a warm one, and the peak memory."""
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
    bad = []
    for name, path in ZOO_CONFIGS.items():
        r = out[name] = {"step": step_vs_cpu(path, ZOO_CHECK_SEED, f"zoo step {name}")}
        config = load_config(str(path))
        embs = {}
        for dev in ("cpu", DEVICE):
            net = build_speaker_net(config)
            missing, _ = load_speaker_state(net, seeded_state_dict(net.backbone, ZOO_CHECK_SEED))
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
        # timed steps at the recipe's batch
        net, state, step = _ecapa_net(DEVICE, config_path=path, seed=ZOO_CHECK_SEED)
        batch = {k: v.to(DEVICE) for k, v in _ecapa_check_batch(ZOO_CHECK_SEED + 1,
                                                                ZOO_TIMED_BATCH).items()}
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ms = []
        for i in range(1 + ZOO_TIMED_STEPS):
            sync()
            t0 = time.perf_counter()
            step(state, batch)
            sync()
            ms.append(1e3 * (time.perf_counter() - t0))
        r["timed"] = {"batch": ZOO_TIMED_BATCH, "chunk_s": 2.0, "step_ms": ms,
                      "step_ms_after_first": statistics.mean(ms[1:]),
                      "audio_s_per_s": ZOO_TIMED_BATCH * 2.0 / (statistics.mean(ms[1:]) / 1e3),
                      "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                                      if DEVICE == "cuda" else "not measured")}
        del net, state, step, batch
        empty_cache()
        t = r["timed"]
        log(f"[zoo {name}] {config['model']} eval embeddings through K1 ({r['k1_launches']} "
            f"launches), card vs CPU: min cosine {min(cos):.7f} (bar {COS_MIN['f32']}); "
            f"{ZOO_TIMED_STEPS} f32 steps at {ZOO_TIMED_BATCH} x 2 s: "
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

    torch.manual_seed(0)
    net = build_speaker_net(config, 3 * RECIPE_SPEAKERS)
    missing, unexpected = load_speaker_state(
        net, torch.load(ckpt, map_location="cpu", weights_only=True))
    check(not missing and not unexpected, f"wavlm step: {missing[:4]} {unexpected[:4]}")
    net.to(DEVICE)
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
WHISPER_STEPS = {3: 4, 4: 6}  # stage 3 at batch 64, stage 4 at batch 16
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
    for tag, dev, scale, dtype, impl in (
            ("card", DEVICE, False, None, "flash"), ("cpu", "cpu", False, None, "flash"),
            ("control", DEVICE, True, None, "flash"),
            ("float64", DEVICE, False, torch.float64, "einsum")):
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
    with tempfile.TemporaryDirectory() as recipe_dir:
        recipe_launches = timed("recipe", phase_recipe, report, recipe_dir)
        # the same data directory: stages 1-2 run again on it
        resnet_launches = timed("resnet recipe", phase_resnet_recipe, report, recipe_dir)
        campplus_launches = timed("campplus recipe", phase_campplus_recipe, report, recipe_dir)
        wavlm_launches = timed("wavlm recipe", phase_wavlm_recipe, report, recipe_dir)
    timed("ecapa step check", phase_ecapa_step_check, report)
    timed("resnet step check", phase_resnet_step_check, report)
    timed("zoo step check", phase_zoo_step_check, report)
    with tempfile.TemporaryDirectory() as whisper_dir:
        whisper_launches = timed("whisper recipe", phase_whisper_recipe, report, whisper_dir)
    with tempfile.TemporaryDirectory() as score_dir:
        timed("score", phase_score, report, score_dir)
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
            or wavlm_launches is None):
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
