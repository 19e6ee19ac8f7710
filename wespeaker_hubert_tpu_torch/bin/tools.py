"""Data-preparation tools.

Counterpart of `wespeaker_hubert_tpu/bin/tools.py`:

    python -m wespeaker_hubert_tpu_torch.bin.tools make_raw_list wav.scp utt2spk raw.list
    python -m wespeaker_hubert_tpu_torch.bin.tools make_feat_list feats.scp utt2spk feat.list
    python -m wespeaker_hubert_tpu_torch.bin.tools compute_feats wav.scp feats.ark feats.scp \
        [--num_mel_bins 80] [--frame_shift 10] [--frame_length 25] [--device cuda|cpu]
    python -m wespeaker_hubert_tpu_torch.bin.tools make_shard_list wav.scp utt2spk \\
        shards/ shard.list [--num_utts_per_shard 1000] [--compress gz|zstd]
    python -m wespeaker_hubert_tpu_torch.bin.tools vector_mean emb.npz utt2spk out.npz
    python -m wespeaker_hubert_tpu_torch.bin.tools wav2dur wav.scp utt2dur
    python -m wespeaker_hubert_tpu_torch.bin.tools generate_calibration_trial \\
        utt2dur utt2spk trials [--each_trial_num 10000] [--seed 42]
    python -m wespeaker_hubert_tpu_torch.bin.tools build_aug_store wav.scp out_dir

Raw lists are JSONL {key, wav, spk}, feat lists {key, feat, spk} with
`feat` a Kaldi matrix-ark rxspecifier 'file.ark:offset'; shards are tar archives of KEY.wav +
KEY.spk members, plain, gzip or zstd; embedding sets are `.npz`
(utils/embeddings.py).  The seeded draws (shard order, calibration trials)
are the JAX package's, so the same inputs give the same files.
"""

from __future__ import annotations

import io
import json
import os
import random
import tarfile
import wave
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "make_raw_list",
    "make_feat_list",
    "make_shard_list",
    "compute_feats",
    "vector_mean",
    "wav2dur",
    "generate_calibration_trial",
    "build_aug_store",
    "main",
]


def _read_table(path: str) -> List[List[str]]:
    with open(path) as f:
        return [line.split() for line in f if line.strip()]


def _read_vad(vad_file: Optional[str]) -> Dict[str, list]:
    """Segment lines `seg_id utt begin end` -> {utt: [(begin, end), ...]}."""
    vad: Dict[str, list] = {}
    if vad_file:
        for row in _read_table(vad_file):
            vad.setdefault(row[1], []).append((row[2], row[3]))
    return vad


def make_raw_list(wav_scp: str, utt2spk: str, out_list: str,
                  vad_file: Optional[str] = None) -> int:
    """wav.scp + utt2spk (+ VAD segments) -> a JSONL raw list; returns the
    number of lines written."""
    utt2wav = {u: w for u, w in (r[:2] for r in _read_table(wav_scp))}
    utt2spk_map = {u: s for u, s in (r[:2] for r in _read_table(utt2spk))}
    vad = _read_vad(vad_file)
    n = 0
    with open(out_list, "w") as f:
        for utt, wav in utt2wav.items():
            if utt not in utt2spk_map:
                continue
            obj = {"key": utt, "wav": wav, "spk": utt2spk_map[utt]}
            if utt in vad:
                obj["vad"] = vad[utt]
            f.write(json.dumps(obj) + "\n")
            n += 1
    return n


def make_feat_list(feat_scp: str, utt2spk: str, out_list: str) -> int:
    """feats.scp (utt -> 'file.ark:offset') + utt2spk -> a JSONL feat list
    {key, feat, spk} for `data_type: feat`; returns the lines written."""
    utt2feat = {u: p for u, p in (r[:2] for r in _read_table(feat_scp))}
    utt2spk_map = {u: s for u, s in (r[:2] for r in _read_table(utt2spk))}
    n = 0
    with open(out_list, "w") as f:
        for utt, feat in utt2feat.items():
            if utt not in utt2spk_map:
                continue
            f.write(json.dumps({"key": utt, "feat": feat, "spk": utt2spk_map[utt]}) + "\n")
            n += 1
    return n


def compute_feats(
    wav_scp: str,
    ark_path: str,
    scp_path: str,
    num_mel_bins: int = 80,
    frame_shift: int = 10,
    frame_length: int = 25,
    device="cuda",
) -> int:
    """Offline fbank: wav.scp -> a Kaldi matrix ark + scp, through the
    training fbank (ops/fbank.py) at 16 kHz, dither off: the CUDA fbank
    kernel on the card, its plain version on the CPU.  One utterance at a
    time, zero-padded to a power of two (at least 512 samples) as the JAX
    package buckets it; the frames past the utterance are dropped."""
    import torch

    from ..backend.kaldi_io import write_kaldi_matrices
    from ..data.wav_io import read_wav
    from ..ops.fbank import FbankConfig, fbank
    from ..utils.device import resolve_device

    device = resolve_device(device)
    cfg = FbankConfig(num_mel_bins=num_mel_bins, frame_shift_ms=frame_shift,
                      frame_length_ms=frame_length, dither=0.0, spectrum_impl="kernel")
    names, mats = [], []
    for utt, path in (r[:2] for r in _read_table(wav_scp)):
        wav, _sr = read_wav(path)
        n = len(wav)
        buf = np.zeros((max(1 << max(0, n - 1).bit_length(), 512),), np.float32)
        buf[:n] = wav
        x = torch.from_numpy(buf).to(device)[None]
        with torch.inference_mode():
            feats, t = fbank(x, cfg, lengths=torch.tensor([n], device=device))
        names.append(utt)
        mats.append(feats[0, :int(t[0])].cpu().numpy())
    write_kaldi_matrices(ark_path, names, mats, scp_path)
    return len(names)


def _write_shard(args) -> str:
    shard_path, items, compress = args
    if compress == "zstd":
        # a plain tar, then stream-compressed (tarfile has no zstd mode)
        plain = shard_path + ".plain.tmp"
        _write_shard((plain, items, None))
        from ..data.zstd_io import compress_file

        try:
            compress_file(plain, shard_path)
        finally:
            os.unlink(plain)
        return shard_path
    with tarfile.open(shard_path, "w:gz" if compress == "gz" else "w") as tf:
        for utt, wav_path, spk, vad in items:
            if vad:
                # only the speech segments are packed
                from ..data.wav_io import read_wav

                wav, sr = read_wav(wav_path)
                parts = [wav[int(float(b) * sr):int(float(e) * sr)] for b, e in vad]
                cropped = np.concatenate([p for p in parts if len(p)])
                pcm = np.clip(cropped * 32768.0, -32768, 32767).astype("<i2")
                buf = io.BytesIO()
                with wave.open(buf, "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(sr)
                    w.writeframes(pcm.tobytes())
                data = buf.getvalue()
                info = tarfile.TarInfo(f"{utt}.wav")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
            else:
                tf.add(wav_path, arcname=f"{utt}.wav")
            spk_bytes = spk.encode()
            info = tarfile.TarInfo(f"{utt}.spk")
            info.size = len(spk_bytes)
            tf.addfile(info, io.BytesIO(spk_bytes))
    return shard_path


def make_shard_list(
    wav_scp: str,
    utt2spk: str,
    shards_dir: str,
    out_list: str,
    num_utts_per_shard: int = 1000,
    num_workers: int = 4,
    shuffle: bool = True,
    seed: int = 42,
    vad_file: Optional[str] = None,
    compress: Optional[str] = None,
) -> List[str]:
    """Pack the utterances of wav.scp that utt2spk labels into tar shards
    of `num_utts_per_shard` (shuffled by `seed` first) and write their paths
    to `out_list`.  `compress`: None (plain tar), 'gz' or 'zstd'."""
    if compress not in (None, "gz", "zstd"):
        raise ValueError(f"compress must be None, 'gz' or 'zstd', got {compress!r}")
    if compress == "zstd":
        from ..data.zstd_io import zstd_available

        if not zstd_available():
            raise OSError("compress='zstd' needs libzstd on this host")
    os.makedirs(shards_dir, exist_ok=True)
    utt2wav = {u: w for u, w in (r[:2] for r in _read_table(wav_scp))}
    utt2spk_map = {u: s for u, s in (r[:2] for r in _read_table(utt2spk))}
    vad = _read_vad(vad_file)
    items = [(u, utt2wav[u], utt2spk_map[u], vad.get(u)) for u in utt2wav if u in utt2spk_map]
    if shuffle:
        np.random.default_rng(seed).shuffle(items)
    chunks = [items[i:i + num_utts_per_shard] for i in range(0, len(items), num_utts_per_shard)]
    suffix = {None: ".tar", "gz": ".tar.gz", "zstd": ".tar.zst"}[compress]
    tasks = [(os.path.join(shards_dir, f"shard_{i:06d}{suffix}"), chunk, compress)
             for i, chunk in enumerate(chunks)]
    if num_workers > 1 and len(tasks) > 1:
        # threads: a shard is file I/O and zlib, which release the GIL, and a
        # spawned process would first re-import the caller's main module
        # (torch with it: seconds per worker, more than a shard takes)
        with ThreadPoolExecutor(min(num_workers, len(tasks))) as pool:
            paths = list(pool.map(_write_shard, tasks))
    else:
        paths = [_write_shard(t) for t in tasks]
    with open(out_list, "w") as f:
        for p in paths:
            f.write(p + "\n")
    return paths


def vector_mean(emb_path: str, utt2spk: str, out_path: str) -> int:
    """Per-speaker mean embeddings -> an .npz set (the AS-Norm cohort);
    returns the number of speakers."""
    from ..utils.embeddings import load_embeddings, save_embeddings, speaker_means

    keys, emb = load_embeddings(emb_path)
    utt2spk_map = {u: s for u, s in (r[:2] for r in _read_table(utt2spk))}
    spks, means = speaker_means(keys, emb, utt2spk_map)
    save_embeddings(out_path, spks, means)
    return len(spks)


def wav2dur(wav_scp: str, out_path: str) -> Dict[str, float]:
    """utt -> duration in seconds (a QMF factor), written as `utt 1.234`."""
    out = {}
    with open(out_path, "w") as f:
        for utt, path in (r[:2] for r in _read_table(wav_scp)):
            with wave.open(path, "rb") as w:
                dur = w.getnframes() / w.getframerate()
            out[utt] = dur
            f.write(f"{utt} {dur:.3f}\n")
    return out


def generate_calibration_trial(
    utt2dur: str,
    utt2spk: str,
    trial_path: str,
    each_trial_num: int = 10000,
    seed: int = 42,
) -> int:
    """Calibration trials from the training set: per speaker a short pool
    (2-6 s) and a long pool (> 6 s), speakers kept when they have both; each
    round picks an enroll and a nontarget speaker and writes short-short,
    short-long and long-long target and nontarget pairs (a target pair never
    pairs an utterance with itself when its pool has two).  With fewer than
    two such speakers both pools are every utterance of the speaker.
    Returns the number of trials; the draws are the JAX package's."""
    durs = {u: float(d) for u, d in (r[:2] for r in _read_table(utt2dur))}
    spk_of = {u: s for u, s in (r[:2] for r in _read_table(utt2spk))}
    short: Dict[str, List[str]] = {}
    long_: Dict[str, List[str]] = {}
    for u, d in durs.items():
        s = spk_of.get(u)
        if s is None:
            continue
        if 2.0 < d < 6.0:
            short.setdefault(s, []).append(u)
        if d > 6.0:
            long_.setdefault(s, []).append(u)
    common = sorted(set(short) & set(long_))
    if len(common) >= 2:
        short = {s: short[s] for s in common}
        long_ = {s: long_[s] for s in common}
    else:
        pool: Dict[str, List[str]] = {}
        for u, s in spk_of.items():
            if u in durs:
                pool.setdefault(s, []).append(u)
        pool = {s: us for s, us in pool.items() if us}
        if len(pool) < 2:
            raise ValueError("need >= 2 speakers for calibration trials")
        short = long_ = pool
    spks = sorted(short)
    rng = random.Random(seed)

    def pick(pool, exclude=None):
        if exclude is not None and len(pool) > 1:
            c = rng.choice(pool)
            while c == exclude:
                c = rng.choice(pool)
            return c
        return rng.choice(pool)

    n = 0
    with open(trial_path, "w") as f:
        for _ in range(max(1, each_trial_num // 2)):
            enroll_spk = rng.choice(spks)
            others = [s for s in spks if s != enroll_spk]
            nontarget_spk = rng.choice(others)
            for e_pool, t_pool in ((short, short), (short, long_), (long_, long_)):
                enroll_utt = pick(e_pool[enroll_spk])
                test_utt = pick(t_pool[enroll_spk], exclude=enroll_utt)
                f.write(f"{enroll_utt} {test_utt} target\n")
                test_utt = pick(t_pool[nontarget_spk])
                f.write(f"{enroll_utt} {test_utt} nontarget\n")
                n += 2
    return n


def build_aug_store(wav_scp: str, out_dir: str):
    """A MUSAN / RIR wav.scp -> an AugStore directory (.npy + index.json);
    keys keep their noise / speech / music prefixes, which set the SNR band."""
    from ..data.aug_store import AugStore

    return AugStore.build_from_wavs(out_dir, [(u, p) for u, p in
                                              (r[:2] for r in _read_table(wav_scp))])


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("make_raw_list")
    s.add_argument("wav_scp")
    s.add_argument("utt2spk")
    s.add_argument("out_list")
    s.add_argument("--vad", default=None)

    s = sub.add_parser("make_feat_list")
    s.add_argument("feat_scp")
    s.add_argument("utt2spk")
    s.add_argument("out_list")

    s = sub.add_parser("compute_feats")
    s.add_argument("wav_scp")
    s.add_argument("ark_path")
    s.add_argument("scp_path")
    s.add_argument("--num_mel_bins", type=int, default=80)
    s.add_argument("--frame_shift", type=int, default=10)
    s.add_argument("--frame_length", type=int, default=25)
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    s = sub.add_parser("make_shard_list")
    s.add_argument("wav_scp")
    s.add_argument("utt2spk")
    s.add_argument("shards_dir")
    s.add_argument("out_list")
    s.add_argument("--num_utts_per_shard", type=int, default=1000)
    s.add_argument("--num_workers", type=int, default=4)
    s.add_argument("--vad_file", default=None)
    s.add_argument("--compress", default=None, choices=["gz", "zstd"])

    s = sub.add_parser("vector_mean")
    s.add_argument("emb_path")
    s.add_argument("utt2spk")
    s.add_argument("out_path")

    s = sub.add_parser("wav2dur")
    s.add_argument("wav_scp")
    s.add_argument("out_path")

    s = sub.add_parser("generate_calibration_trial")
    s.add_argument("utt2dur")
    s.add_argument("utt2spk")
    s.add_argument("trial_path")
    s.add_argument("--each_trial_num", type=int, default=10000)
    s.add_argument("--seed", type=int, default=42)

    s = sub.add_parser("build_aug_store")
    s.add_argument("wav_scp")
    s.add_argument("out_dir")

    args = p.parse_args()
    if args.cmd == "make_raw_list":
        print(make_raw_list(args.wav_scp, args.utt2spk, args.out_list, args.vad))
    elif args.cmd == "make_feat_list":
        print(make_feat_list(args.feat_scp, args.utt2spk, args.out_list))
    elif args.cmd == "compute_feats":
        print(compute_feats(args.wav_scp, args.ark_path, args.scp_path, args.num_mel_bins,
                            args.frame_shift, args.frame_length, device=args.device))
    elif args.cmd == "make_shard_list":
        print(len(make_shard_list(args.wav_scp, args.utt2spk, args.shards_dir, args.out_list,
                                  args.num_utts_per_shard, args.num_workers,
                                  vad_file=args.vad_file, compress=args.compress)))
    elif args.cmd == "vector_mean":
        print(vector_mean(args.emb_path, args.utt2spk, args.out_path))
    elif args.cmd == "wav2dur":
        print(len(wav2dur(args.wav_scp, args.out_path)))
    elif args.cmd == "generate_calibration_trial":
        print(generate_calibration_trial(args.utt2dur, args.utt2spk, args.trial_path,
                                         args.each_trial_num, args.seed))
    else:
        print(len(build_aug_store(args.wav_scp, args.out_dir)))


if __name__ == "__main__":
    main()
