"""User-facing Speaker API and CLI on PyTorch.

Counterpart of `wespeaker_hubert_tpu/cli/speaker.py`: embedding extraction
(with optional VAD), cosine similarity, in-memory enrollment, and
diarization (VAD -> per-segment fbank -> 1.5 s / 0.75 s subsegment windows
-> embeddings -> spectral or density clustering -> merged segments, RTTM),
one conversation at a time (`diarize_pcm`) or pooled over many
(`diarize_pcm_batch`, which serving and `diarize_list` use), and the CLI's
tasks embedding / embedding_kaldi / similarity / diarization /
diarization_list.

A model directory holds
  config.json   the training config (the YAML schema, as JSON): `model`,
                `model_args`, `dataset_args.fbank_args` and
                `dataset_args.resample_rate`;
  avg_model.pt  a torch state_dict with the WeSpeaker parameter names of
                the backbone (models/ecapa_tdnn.py, models/resnet.py).  Keys
                the backbone does not have, such as a WeSpeaker checkpoint's
                `projection.*`, are reported and skipped; a missing key
                raises;
  vad.npz       optional: Silero weights (diar/silero.py), which `set_vad`
                picks up; without them the energy VAD runs.

bin/export_model.py writes such a directory (recipe stage 8), from the
port's experiment directory or a JAX one; `load_model` also takes a hub
alias or a WeSpeaker bundle (cli/hub.py).

Everything runs on the Speaker's device (CUDA unless the caller asks for
the CPU): on the card the fbank of every VAD segment bucket is the
hand-written kernel K1 (`spectrum_impl="kernel"`).  The batched path keeps
the segment features on the device and gathers the sliding windows there.
Both paths run the same shapes (VAD batches of 16 rows, fbank batches of
SEG_ROWS rows at power-of-two sample buckets, embedding batches of
EMBED_ROWS windows), so a conversation's result does not depend on which
path, or which other conversations, it ran with.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.wav_io import read_wav
from ..diar import (
    density_cluster,
    energy_vad,
    make_seg_id,
    merge_segments,
    parse_subseg_id,
    spectral_cluster,
    subsegment_fbank,
    write_rttm,
)
from ..diar.subsegment import subsegment_windows
from ..models.speaker_net import build_speaker_net, load_speaker_state
from ..ops.fbank import FbankConfig, fbank
from ..ops.feature_utils import apply_cmvn
from ..ops.pipeline import FeaturePipelineConfig
from ..train.executor import make_eval_embed
from ..utils.device import resolve_device

__all__ = ["Speaker", "load_model", "main"]

logger = logging.getLogger(__name__)

SEG_ROWS = 32  # VAD segments per fbank batch
EMBED_ROWS = 32  # windows per embedding forward, in both diarization paths

# largest flat sample pool one upload of `_fbank_slices_device` carries (4
# GiB of float32); a larger pool is split into pools below it
_FLAT_SAMPLE_LIMIT = 1 << 30


def _pow2_bucket(n: int, floor: int = 1 << 14) -> int:
    """Smallest power-of-two >= n with a floor (~1 s at 16 kHz): the
    mask-aware path keeps results exact while shapes stay few."""
    return max(floor, 1 << (max(n, 2) - 1).bit_length())


def _resample(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling (scipy), WeSpeaker's torchaudio Resample role."""
    from scipy.signal import resample_poly

    g = math.gcd(sr_in, sr_out)
    return resample_poly(wav, sr_out // g, sr_in // g).astype(np.float32)


def _bucket_groups(lengths: List[int], keys=None):
    """Indices sorted by (key, length), grouped SEG_ROWS at a time within one
    key and one power-of-two sample bucket: [(bucket, [indices])]."""
    keys = keys or [0] * len(lengths)
    order = sorted(range(len(lengths)), key=lambda i: (keys[i], lengths[i]))
    groups, i = [], 0
    while i < len(order):
        key, bucket = keys[order[i]], _pow2_bucket(max(lengths[order[i]], 1))
        idx = []
        while (i < len(order) and keys[order[i]] == key and lengths[order[i]] <= bucket
               and len(idx) < SEG_ROWS):
            idx.append(order[i])
            i += 1
        groups.append((bucket, idx))
    return groups


class Speaker:
    def __init__(self, model_dir: str, device="cuda"):
        self.device = resolve_device(device)
        with open(os.path.join(model_dir, "config.json")) as f:
            config = json.load(f)
        ckpt = os.path.join(model_dir, "avg_model.pt")
        if not os.path.exists(ckpt):
            raise FileNotFoundError(f"no avg_model.pt under {model_dir}")

        self.config = config
        dataset_args = config.get("dataset_args", {})
        fb = dataset_args.get("fbank_args", {})
        self.resample_rate = dataset_args.get("resample_rate", 16000)
        # the fbank is the hand-written CUDA kernel on a GPU
        self.fbank_cfg = FbankConfig(
            sample_rate=self.resample_rate,
            num_mel_bins=fb.get("num_mel_bins", 80),
            frame_shift_ms=fb.get("frame_shift", 10),
            frame_length_ms=fb.get("frame_length", 25),
            dither=0.0,
            spectrum_impl="kernel",
        )
        self.apply_vad = False
        self.vad_model = None
        self.model_dir = model_dir
        self.net = build_speaker_net(config)
        self._load_weights(torch.load(ckpt, map_location="cpu", weights_only=True))
        self.net.to(self.device).eval()
        self._rebuild_embed_fn()
        self.table: Dict[str, np.ndarray] = {}
        # diarization parameters (WeSpeaker's CLI defaults)
        self.diar_window_secs = 1.5
        self.diar_period_secs = 0.75
        # True: CMN per 1.5 s window (diar/extract_emb.py, make_fbank.py's
        # --subseg-cmn default); False: CMN once per VAD segment
        self.diar_subseg_cmn = True
        # spectral clustering: 'host', 'device' or 'auto' (diar/spectral.py)
        self.diar_cluster_impl = "auto"
        self.last_diar_timings: Dict[str, float] = {}

    def _load_weights(self, state: Dict[str, torch.Tensor]) -> None:
        missing, unexpected = load_speaker_state(self.net, state)
        if missing:
            raise KeyError(f"checkpoint lacks backbone weights: {missing[:8]}")
        if unexpected:
            logger.warning(
                "skipping %d checkpoint keys the backbone does not have: %s",
                len(unexpected), unexpected[:8],
            )

    def _rebuild_embed_fn(self) -> None:
        self._embed_fn = make_eval_embed(
            self.net,
            feature_cfg=FeaturePipelineConfig(fbank=self.fbank_cfg, spec_aug=False),
        )

    # ------------------------------------------------------------ settings
    def set_vad(self, enable: bool, model_path: Optional[str] = None):
        """Enable VAD.  model_path: Silero weights (.npz, diar/silero.py);
        the model directory's vad.npz is picked up by default.  Without
        weights the energy VAD runs."""
        self.apply_vad = enable
        if model_path is None:
            cand = os.path.join(self.model_dir, "vad.npz")
            model_path = cand if os.path.exists(cand) else None
        if enable and model_path:
            from ..diar.silero import SileroVAD

            self.vad_model = SileroVAD.from_file(model_path, device=self.device)

    def _replace_fbank(self, **kwargs):
        import dataclasses

        self.fbank_cfg = dataclasses.replace(self.fbank_cfg, **kwargs)
        self._rebuild_embed_fn()

    def set_resample_rate(self, resample_rate: int):
        """Target sample rate: audio at other rates is resampled to it and
        the fbank runs at it."""
        self.resample_rate = resample_rate
        self._replace_fbank(sample_rate=resample_rate)

    def set_window_type(self, window_type: str):
        self._replace_fbank(window_type=window_type)

    def set_wavform_norm(self, wavform_norm: bool):
        """True: the fbank reads [-1, 1] floats as they are (CAM++ and
        ERes2Net's training), not scaled to int16."""
        self._replace_fbank(scale_to_int16=not wavform_norm)

    def set_diarization_params(
        self,
        window_secs: float = 1.5,
        period_secs: float = 0.75,
        subseg_cmn: bool = True,
        cluster_impl: str = "auto",
    ):
        """Sliding-window subsegmentation, CMN placement (True: per window;
        False: once per VAD segment) and the spectral path ('host',
        'device', or 'auto': the device only for fixed speaker counts)."""
        if cluster_impl not in ("auto", "host", "device"):
            raise ValueError(f"cluster_impl must be auto|host|device, got {cluster_impl!r}")
        self.diar_window_secs = window_secs
        self.diar_period_secs = period_secs
        self.diar_subseg_cmn = subseg_cmn
        self.diar_cluster_impl = cluster_impl

    # ---------------------------------------------------------- embedding
    def _load_audio(self, audio_path: str) -> np.ndarray:
        wav, sr = read_wav(audio_path)
        if sr != self.resample_rate:
            wav = _resample(wav, sr, self.resample_rate)
        return wav

    def _vad_segments(self, wav: np.ndarray) -> List[Tuple[float, float]]:
        """(begin_s, end_s) speech segments with the configured VAD."""
        if self.vad_model is None:
            return energy_vad(wav, self.resample_rate)
        from ..diar.silero import SR as VAD_SR
        from ..diar.silero import get_speech_timestamps

        # Silero runs at 16 kHz whatever the model's rate; timestamps are
        # seconds, so they map back directly
        vad_wav = wav if self.resample_rate == VAD_SR else _resample(
            wav, self.resample_rate, VAD_SR)
        ts = get_speech_timestamps(vad_wav, self.vad_model)
        return [(t["start"] / VAD_SR, t["end"] / VAD_SR) for t in ts]

    def extract_embedding_from_pcm(self, wav: np.ndarray) -> np.ndarray:
        """Float samples at the model rate -> embedding.  The wav is padded
        to a power-of-two bucket (few distinct shapes) with its length, so
        CMN and pooling see only its valid frames."""
        wav = np.asarray(wav, np.float32).reshape(-1)
        if self.apply_vad:
            segs = self._vad_segments(wav)
            if segs:
                sr = self.resample_rate
                wav = np.concatenate([wav[int(b * sr): int(e * sr)] for b, e in segs])
        n = len(wav)
        padded = np.zeros(_pow2_bucket(n), np.float32)
        padded[:n] = wav
        emb = self._embed_fn({
            "wav": torch.from_numpy(padded[None]).to(self.device),
            "length": torch.tensor([n], dtype=torch.int32, device=self.device),
        })
        return emb[0].cpu().numpy()

    def extract_embedding(self, audio_path: str) -> np.ndarray:
        return self.extract_embedding_from_pcm(self._load_audio(audio_path))

    def extract_embedding_list(self, scp_path: str):
        """wav.scp (utt path per line) -> (names, embeddings)."""
        names, embs = [], []
        with open(scp_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                names.append(parts[0])
                embs.append(self.extract_embedding(parts[1]))
        return names, embs

    def compute_similarity(self, audio_path1: str, audio_path2: str) -> float:
        e1 = self.extract_embedding(audio_path1)
        e2 = self.extract_embedding(audio_path2)
        return self.cosine_similarity(e1, e2)

    @staticmethod
    def cosine_similarity(e1: np.ndarray, e2: np.ndarray) -> float:
        """Cosine mapped from [-1,1] to [0,1]."""
        s = float(np.dot(e1, e2) / (np.linalg.norm(e1) * np.linalg.norm(e2)))
        return (s + 1.0) / 2.0

    def register(self, name: str, audio_path: str):
        if name in self.table:
            raise ValueError(f"speaker {name} already registered")
        self.table[name] = self.extract_embedding(audio_path)

    def recognize(self, audio_path: str):
        q = self.extract_embedding(audio_path)
        best_name, best_score = "", 0.0
        for name, e in self.table.items():
            score = self.cosine_similarity(q, e)
            if score > best_score:
                best_name, best_score = name, score
        return {"name": best_name, "confidence": best_score}

    # ------------------------------------------------ diarization pieces
    def _frame_shift(self) -> int:
        return int(self.fbank_cfg.frame_shift_ms)

    def _window_frames(self) -> Tuple[int, int]:
        fs_ms = self.fbank_cfg.frame_shift_ms
        return (int(self.diar_window_secs * 1000 / fs_ms),
                int(self.diar_period_secs * 1000 / fs_ms))

    def _fbank_rows(self, wavs: torch.Tensor, lens: torch.Tensor):
        """(SEG_ROWS, bucket) zero-padded segment rows -> (feats, feat_lens)
        on the device, CMN'd per segment when CMN is not per window."""
        with torch.inference_mode():
            feats, feat_lens = fbank(wavs, self.fbank_cfg, lengths=lens)
            if not self.diar_subseg_cmn:
                feats = apply_cmvn(feats, lengths=feat_lens)
        return feats, feat_lens

    def _embed_windows(self, windows: torch.Tensor) -> torch.Tensor:
        """(EMBED_ROWS, win, F) windows on the device -> embeddings."""
        with torch.inference_mode():
            if self.diar_subseg_cmn:
                windows = apply_cmvn(windows)
            return self.net.embed(windows).float()

    def _segment_fbanks(self, wav, vad_segments):
        """Per-VAD-segment fbank (frames never cross a segment boundary)."""
        sr = self.resample_rate
        return self._fbank_slices([wav[int(b * sr): int(e * sr)] for b, e in vad_segments])

    def _fbank_slices(self, segs):
        """Bucket-batched fbank over waveform slices, to the host: one
        (T_i, F) array per slice."""
        batches, meta = self._fbank_slices_device(segs)
        host = [f.cpu().numpy() for f in batches]
        return [host[b][row, :nf] for b, row, nf in meta]

    def _extract_embedding_feats(self, fbanks: np.ndarray) -> np.ndarray:
        """(N, win, F) window features -> (N, D) embeddings, in forwards of
        EMBED_ROWS windows (the tail padded with zero windows)."""
        out = []
        for s in range(0, len(fbanks), EMBED_ROWS):
            chunk = np.zeros((EMBED_ROWS,) + fbanks.shape[1:], np.float32)
            k = len(fbanks[s: s + EMBED_ROWS])
            chunk[:k] = fbanks[s: s + EMBED_ROWS]
            emb = self._embed_windows(torch.from_numpy(chunk).to(self.device))
            out.append(emb[:k].cpu().numpy())
        return np.concatenate(out)

    def _fbank_slices_device(self, segs):
        """Bucket-batched fbank over waveform slices, kept on the device.

        One upload of the exact segment samples, from which
        `_fbank_slices_from_rows` gathers the zero-padded (SEG_ROWS,
        bucket) rows.  Returns (feature batches, per slice (batch index,
        row, frames)).  A pool past _FLAT_SAMPLE_LIMIT samples is processed
        in pools below it, the batch indices offset."""
        total = sum(len(s) for s in segs)
        if total > _FLAT_SAMPLE_LIMIT and len(segs) > 1:
            batches, meta = [], []
            group, gtotal = [], 0
            for s in list(segs) + [None]:
                if group and (s is None or gtotal + len(s) > _FLAT_SAMPLE_LIMIT):
                    b, m = self._fbank_slices_device(group)
                    off = len(batches)
                    batches += b
                    meta += [(bi + off, row, nf) for bi, row, nf in m]
                    group, gtotal = [], 0
                if s is not None:
                    group.append(s)
                    gtotal += len(s)
            return batches, meta
        if total > _FLAT_SAMPLE_LIMIT:
            raise ValueError(
                f"a single {total}-sample VAD segment (~{total / 16000 / 3600:.1f} h at "
                f"16 kHz) exceeds the {_FLAT_SAMPLE_LIMIT}-sample upload limit; split the "
                "recording before diarization"
            )
        flat = np.concatenate(segs).astype(np.float32) if segs else np.zeros(1, np.float32)
        starts = np.cumsum([0] + [len(x) for x in segs[:-1]])
        return self._fbank_slices_from_rows(
            [torch.from_numpy(flat).to(self.device)[None]],
            [(0, 0, int(st), len(x)) for st, x in zip(starts, segs)])

    def _fbank_slices_from_rows(self, srcs, seg_locs):
        """Bucket-batched segment fbank sliced out of conversation rows that
        are already on the device (the VAD's batches), features kept on the
        device.  seg_locs: per segment (src index, row, start sample,
        samples).  Returns (feature batches, per segment (batch index, row,
        frames)); a row holds the segment's samples, then zeros."""
        batches, meta, pending = [], [None] * len(seg_locs), []
        groups = _bucket_groups([loc[3] for loc in seg_locs], keys=[loc[0] for loc in seg_locs])
        for bucket, idx in groups:
            src = srcs[seg_locs[idx[0]][0]]
            rows = np.zeros((SEG_ROWS,), np.int64)
            starts = np.zeros((SEG_ROWS,), np.int64)
            lens = np.zeros((SEG_ROWS,), np.int64)
            for row, j in enumerate(idx):
                _, rows[row], starts[row], lens[row] = seg_locs[j]
            rows_d, starts_d, lens_d = (torch.from_numpy(a).to(self.device)
                                        for a in (rows, starts, lens))
            pos = torch.arange(bucket, device=self.device)[None, :]
            cols = torch.clamp_max(starts_d[:, None] + pos, src.shape[1] - 1)
            w = src[rows_d[:, None], cols] * (pos < lens_d[:, None])
            feats, feat_lens = self._fbank_rows(w, lens_d)
            batches.append(feats)
            pending.append((feat_lens, idx))
        for bpos, (feat_lens, idx) in enumerate(pending):
            fl = feat_lens.cpu().numpy()
            for row, j in enumerate(idx):
                meta[j] = (bpos, row, int(fl[row]))
        return batches, meta

    def _embed_windows_device(self, feats_dev, windows):
        """Embed sliding windows gathered on the device from a (SEG_ROWS, T,
        F) feature batch.  windows: (row, start, m) with m valid frames
        (np.resize's tiling: window frame r reads frame start + (r mod m);
        m == 0 gives zeros).  Returns (N, D) embeddings on the device."""
        win, _ = self._window_frames()
        r = torch.arange(win, device=self.device)[None, :]
        out = []
        for s in range(0, len(windows), EMBED_ROWS):
            part = windows[s: s + EMBED_ROWS]
            tab = np.zeros((EMBED_ROWS, 3), np.int64)
            tab[: len(part)] = part
            tab = torch.from_numpy(tab).to(self.device)
            rows, starts, ms = tab[:, 0], tab[:, 1], tab[:, 2]
            idx = starts[:, None] + r % torch.clamp_min(ms, 1)[:, None]
            idx = torch.clamp_max(idx, feats_dev.shape[1] - 1)
            w = feats_dev[rows[:, None], idx]
            w = torch.where((ms > 0)[:, None, None], w, torch.zeros((), device=self.device))
            out.append(self._embed_windows(w)[: len(part)])
        return torch.cat(out)

    def _cluster(self, embeddings: np.ndarray, clusterer: str) -> List[int]:
        if clusterer == "spectral":
            return spectral_cluster(embeddings, impl=self.diar_cluster_impl,
                                    device=self.device)
        return density_cluster(embeddings)

    def _merged(self, utt: str, subsegs: List[str], labels: List[int]):
        items = []
        for sub, lab in zip(subsegs, labels):
            _, b, e = parse_subseg_id(sub, frame_shift=self._frame_shift())
            items.append((b, e, str(lab)))
        items.sort()
        return [(u, b, e, int(lab)) for (u, b, e, lab) in merge_segments({utt: items})]

    # --------------------------------------------------------- diarization
    def diarize(self, audio_path: str, utt: str = "unk", clusterer: str = "density"):
        """(utt, begin, end, speaker) list: VAD -> per-segment fbank ->
        subsegment windows -> embeddings -> clustering -> merged segments."""
        return self.diarize_pcm(self._load_audio(audio_path), utt=utt, clusterer=clusterer)

    def diarize_segments(self, wav, vad_segments, utt: str = "unk",
                         clusterer: str = "density"):
        """Diarize with external speech segments (oracle SAD: WeSpeaker's
        voxconverse sad_type=oracle)."""
        return self.diarize_pcm(wav, utt=utt, clusterer=clusterer, vad_segments=vad_segments)

    def diarize_pcm(self, wav: np.ndarray, utt: str = "unk", clusterer: str = "density",
                    vad_segments: Optional[List[Tuple[float, float]]] = None):
        """diarize() on in-memory samples at the model rate."""
        wav = np.asarray(wav, np.float32).reshape(-1)
        if vad_segments is None:
            vad_segments = self._vad_segments(wav)
        if not vad_segments:
            return []
        win, period = self._window_frames()
        subsegs, fbanks = [], []
        for (begin, end), feats in zip(vad_segments, self._segment_fbanks(wav, vad_segments)):
            seg_id = make_seg_id(utt, int(begin * 1000), int(end * 1000))
            s, m = subsegment_fbank(feats, seg_id, window_fs=win, period_fs=period,
                                    frame_shift=self._frame_shift())
            subsegs += s
            fbanks += m
        embeddings = self._extract_embedding_feats(np.stack(fbanks))
        return self._merged(utt, subsegs, self._cluster(embeddings, clusterer))

    def _vad_segments_batch(self, wavs, return_device: bool = False):
        """Per-conversation (begin_s, end_s) lists, Silero pooled over the
        batch (diar/silero.silero_probs_batch); the threshold state machine
        runs per conversation on the host.  With ``return_device=True`` it
        also returns the VAD's device batches and conversation -> (batch,
        row) map when they hold the audio at the diarization rate, else
        (segs, None, None)."""
        if self.vad_model is None:
            segs = [energy_vad(w, self.resample_rate) for w in wavs]
            return (segs, None, None) if return_device else segs
        from ..diar.silero import SR as VAD_SR
        from ..diar.silero import get_speech_timestamps, silero_probs_batch

        reusable = self.resample_rate == VAD_SR
        vad_wavs = [w if reusable else _resample(w, self.resample_rate, VAD_SR) for w in wavs]
        probs, batches, locs = silero_probs_batch(self.vad_model, vad_wavs, return_device=True)
        out = []
        for w, p in zip(vad_wavs, probs):
            ts = get_speech_timestamps(w, model=lambda _w, _p=p: _p)
            out.append([(t["start"] / VAD_SR, t["end"] / VAD_SR) for t in ts])
        if return_device:
            return out, (batches if reusable else None), (locs if reusable else None)
        return out

    def diarize_pcm_batch(self, wavs: List[np.ndarray], utts: Optional[List[str]] = None,
                          clusterer: str = "density", cluster_workers: int = 4):
        """Diarization of many conversations with the device work pooled:
        one VAD forward per length bucket, fbank batches of segments from
        every conversation, features kept on the device and the windows
        gathered there, embedding forwards over the pooled windows; the
        clustering runs per conversation in a thread pool.  Each result
        equals `diarize_pcm`'s for that conversation.

        Phase wall times of the last call land in ``last_diar_timings``
        (vad / fbank / embed / cluster seconds)."""
        wavs = [np.asarray(w, np.float32).reshape(-1) for w in wavs]
        timings = {}
        t0 = time.perf_counter()
        if utts is None:
            utts = [f"utt{i}" for i in range(len(wavs))]
        vad_segs, vad_dev, vad_locs = self._vad_segments_batch(wavs, return_device=True)
        timings["vad"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        sr = self.resample_rate
        if not any(vad_segs):
            feat_batches, meta = [], []
        elif vad_dev is not None:
            seg_locs = []
            for ci, segs in enumerate(vad_segs):
                src_idx, row = vad_locs[ci]
                for begin, end in segs:
                    b_idx = int(begin * sr)
                    e_idx = min(int(end * sr), len(wavs[ci]))
                    seg_locs.append((src_idx, row, b_idx, max(e_idx - b_idx, 0)))
            feat_batches, meta = self._fbank_slices_from_rows(vad_dev, seg_locs)
        else:
            slices = [wav[int(b * sr): int(e * sr)]
                      for wav, segs in zip(wavs, vad_segs) for b, e in segs]
            feat_batches, meta = self._fbank_slices_device(slices)
        timings["fbank"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        # window tables per conversation on the host; contents gathered on
        # the device per feature batch
        win, period = self._window_frames()
        conv_subsegs: List[List[str]] = [[] for _ in wavs]
        per_batch: List[List[Tuple[int, int, int, int]]] = [[] for _ in feat_batches]
        n_windows, seg_ptr = 0, 0
        for ci, segs in enumerate(vad_segs):
            for begin, end in segs:
                b_idx, row, n_frames = meta[seg_ptr]
                seg_ptr += 1
                seg_id = make_seg_id(utts[ci], int(begin * 1000), int(end * 1000))
                ids, table = subsegment_windows(seg_id, n_frames, window_fs=win,
                                                period_fs=period,
                                                frame_shift=self._frame_shift())
                conv_subsegs[ci] += ids
                for start, m in table:
                    per_batch[b_idx].append((n_windows, row, start, m))
                    n_windows += 1
        embeddings = np.zeros((n_windows, 0), np.float32)
        parts = [(wins, self._embed_windows_device(feat_batches[b], [w[1:] for w in wins]))
                 for b, wins in enumerate(per_batch) if wins]
        for wins, emb in parts:
            emb = emb.cpu().numpy()
            if embeddings.shape[1] == 0:
                embeddings = np.zeros((n_windows, emb.shape[1]), emb.dtype)
            embeddings[[w[0] for w in wins]] = emb
        timings["embed"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        bounds = np.cumsum([0] + [len(s) for s in conv_subsegs])

        def one(ci):
            emb = embeddings[bounds[ci]: bounds[ci + 1]]
            if not len(emb):
                return []
            return self._merged(utts[ci], conv_subsegs[ci], self._cluster(emb, clusterer))

        with ThreadPoolExecutor(max_workers=max(1, cluster_workers)) as ex:
            results = list(ex.map(one, range(len(wavs))))
        timings["cluster"] = time.perf_counter() - t0
        self.last_diar_timings = timings
        return results

    def warm_diarize(self, max_seconds: float = 30.0) -> None:
        """Build K1 and set up cuDNN's convolutions and LSTM for the
        diarization path before the first request: one fbank batch per
        sample bucket up to `max_seconds`, an embedding forward of windows,
        and one synthetic conversation through `diarize_pcm_batch`."""
        sr = self.resample_rate
        bucket, top = _pow2_bucket(1), _pow2_bucket(int(max_seconds * sr))
        while True:
            self._fbank_rows(torch.zeros((SEG_ROWS, bucket), device=self.device),
                             torch.full((SEG_ROWS,), bucket, device=self.device))
            if bucket >= top:
                break
            bucket *= 2
        win, _ = self._window_frames()
        self._embed_windows(torch.zeros((EMBED_ROWS, win, self.fbank_cfg.num_mel_bins),
                                        device=self.device))
        t = np.arange(int(min(max_seconds, 8.0) * sr)) / sr
        tone = (0.1 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
        self.diarize_pcm_batch([tone], utts=["warm"])

    def diarize_list(self, scp_path: str, clusterer: str = "density", batch: int = 8):
        """wav.scp -> {utt: merged segments}, conversations diarized through
        `diarize_pcm_batch` in groups of `batch`."""
        entries = []
        with open(scp_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    entries.append((parts[0], parts[1]))
        results = {}
        for s in range(0, len(entries), max(1, batch)):
            group = entries[s: s + max(1, batch)]
            wavs = [self._load_audio(p) for _, p in group]
            outs = self.diarize_pcm_batch(wavs, utts=[u for u, _ in group], clusterer=clusterer)
            for (u, _), segs in zip(group, outs):
                results[u] = segs
        return results

    def make_rttm(self, merged_segments, outfile: str):
        write_rttm(outfile, [(u, b, e, f"spk{lab}") for (u, b, e, lab) in merged_segments])


def load_model(model_dir_or_alias: str, device="cuda") -> Speaker:
    """A Speaker from a local model directory (a WeSpeaker bundle is
    converted) or a hub alias (cli/hub.py, local directories only)."""
    from .hub import Hub, ensure_native_checkpoint

    if os.path.isdir(model_dir_or_alias):
        return Speaker(ensure_native_checkpoint(model_dir_or_alias), device=device)
    return Speaker(Hub.get_model(model_dir_or_alias), device=device)


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser("wespeaker-torch")
    parser.add_argument(
        "-t", "--task",
        choices=["embedding", "embedding_kaldi", "similarity", "diarization",
                 "diarization_list"],
        default="embedding",
    )
    parser.add_argument("-p", "--pretrain", default="",
                        help="model directory or hub alias (cli/hub.py)")
    parser.add_argument("-l", "--language", choices=["chinese", "english"],
                        default="chinese")
    parser.add_argument("--campplus", action="store_true",
                        help="use the campplus_cn_common hub model")
    parser.add_argument("--eres2net", action="store_true",
                        help="use the eres2net_cn_common hub model")
    parser.add_argument("--vblinkp", action="store_true",
                        help="use the samresnet34 voxblink2-pretrained model")
    parser.add_argument("--vblinkf", action="store_true",
                        help="use the samresnet34 voxblink2+voxceleb2 model")
    parser.add_argument("--audio_file", default=None)
    parser.add_argument("--audio_file2", default=None)
    parser.add_argument("--wav_scp", default=None)
    parser.add_argument("--output_file", default=None)
    parser.add_argument("--resample_rate", type=int, default=16000)
    parser.add_argument("--vad", action="store_true")
    parser.add_argument("--diar_window_secs", type=float, default=1.5)
    parser.add_argument("--diar_period_secs", type=float, default=0.75)
    parser.add_argument(
        "--diar_subseg_cmn", default=True, type=lambda x: x.lower() == "true",
        help="true: CMN per window (the default); false: CMN once per VAD segment",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    if args.pretrain:
        model = load_model(args.pretrain, args.device)
    elif args.campplus or args.eres2net:
        model = load_model("campplus" if args.campplus else "eres2net", args.device)
        model.set_wavform_norm(True)
        model.set_window_type("povey")
    elif args.vblinkp:
        model = load_model("vblinkp", args.device)
    elif args.vblinkf:
        model = load_model("vblinkf", args.device)
    else:
        model = load_model(args.language, args.device)
    model.set_resample_rate(args.resample_rate)
    model.set_vad(args.vad)
    model.set_diarization_params(
        window_secs=args.diar_window_secs,
        period_secs=args.diar_period_secs,
        subseg_cmn=args.diar_subseg_cmn,
    )

    if args.task == "embedding":
        emb = model.extract_embedding(args.audio_file)
        out = args.output_file or "embedding.txt"
        np.savetxt(out, emb)
        print(f"embedding -> {out}")
    elif args.task == "embedding_kaldi":
        from ..utils.embeddings import save_embeddings

        names, embs = model.extract_embedding_list(args.wav_scp)
        save_embeddings(args.output_file, names, np.stack(embs))
        print(f"{len(names)} embeddings -> {args.output_file}")
    elif args.task == "similarity":
        print(model.compute_similarity(args.audio_file, args.audio_file2))
    elif args.task == "diarization":
        segs = model.diarize(args.audio_file)
        if args.output_file:
            model.make_rttm(segs, args.output_file)
        else:
            for u, b, e, lab in segs:
                print(f"{u} {b:.3f} {e:.3f} spk{lab}")
    elif args.task == "diarization_list":
        with open(args.wav_scp) as f, open(args.output_file, "w") as out:
            for line in f:
                utt, path = line.split()[:2]
                for u, b, e, lab in model.diarize(path, utt=utt):
                    out.write(f"SPEAKER {u} 1 {b:.3f} {e - b:.3f} "
                              f"<NA> <NA> spk{lab} <NA> <NA>\n")


if __name__ == "__main__":
    main()
