"""Host-side input: data lists, the training pipeline and bucketed eval
batches.

Counterpart of `wespeaker_hubert_tpu/data/dataset.py`: `load_data_list`,
`iter_raw_list` (JSONL {key, wav, spk}), `iter_feat_list` (JSONL {key,
feat, spk} with Kaldi matrix rxspecifiers), `iter_tar_shards` (tar
archives of KEY.wav + KEY.spk members: plain, gzip or zstd),
`chunk_samples_for_frames`, `shard_list_for_rank`, `buffer_shuffle`,
`TrainPipelineConfig`, `TrainPipeline`, `PrefetchPipeline`,
`NativeTrainPipeline` and `EvalPipeline`.  The host
decodes and selects (list striping, shuffle, chunk choice, augmentation
parameters) and ships fixed-shape numpy batches; the DSP runs on the device
(ops/augment.py).  `TrainPipeline` makes the same `random.Random` and
`np.random.default_rng` draws in the same order as the JAX package's, so its
batches are identical for the same list, seed and stores.  For `shard` data
the list's lines are tar paths: the epoch's shuffle and the rank / worker
striping act on whole shards, and the buffer shuffle on the utterances
streamed out of them.

`PrefetchPipeline` runs N TrainPipelines over the `[worker::N]` stripes
in threads and takes their batches round-robin; `NativeTrainPipeline`
runs the C++ loader (data/native_loader.py).  Both give the JAX package's
counterparts' batches exactly; `bin/train` picks them by
`dataloader_args.num_workers`, as the JAX package's does.

The readers, so every pipeline, refuse a wav whose header rate is not the
configured rate (`dataset_args.resample_rate`, 16 kHz by default) with a
`WavRateError` naming the key, its rate and the configured one: nothing
here resamples, and framing it at the configured rate would be wrong
without a word.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import queue
import random
import tarfile
import threading
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from ..ops.augment import speed_input_len
from .aug_store import AugStore, snr_range_for_key
from .wav_io import WavRateError, read_wav, read_wav_bytes

__all__ = [
    "chunk_samples_for_frames",
    "load_data_list",
    "iter_raw_list",
    "iter_feat_list",
    "iter_tar_shards",
    "shard_list_for_rank",
    "buffer_shuffle",
    "TrainPipelineConfig",
    "TrainPipeline",
    "PrefetchPipeline",
    "NativeRefusal",
    "NativeTrainPipeline",
    "EvalPipeline",
]

logger = logging.getLogger(__name__)


def chunk_samples_for_frames(
    num_frms: int, frame_shift_ms: float = 10.0, frame_length_ms: float = 25.0,
    sample_rate: int = 16000,
) -> int:
    """Samples required for exactly num_frms fbank frames."""
    return int(
        ((num_frms - 1) * frame_shift_ms + frame_length_ms) * sample_rate / 1000
    )


def load_data_list(path: str) -> List[str]:
    """A data-list file -> its non-empty lines."""
    with open(path, "r", encoding="utf-8") as f:
        return [ln.strip() for ln in f if ln.strip()]


def _check_rate(key: str, rate: int, sample_rate: int) -> None:
    if rate != sample_rate:
        raise WavRateError(key, rate, sample_rate)


def iter_raw_list(entries: Iterable[str], sample_rate: int = 16000) -> Iterator[dict]:
    """JSON entry lines -> {key, wav (float32), sample_rate, spk}; an entry
    that fails to read is logged and skipped, and a wav at another rate
    than `sample_rate` raises WavRateError."""
    for line in entries:
        try:
            obj = json.loads(line)
            wav, sr = read_wav(obj["wav"])
            _check_rate(obj["key"], sr, sample_rate)
            if "vad" in obj:
                parts = [
                    wav[int(float(s) * sr) : int(float(e) * sr)]
                    for s, e in obj["vad"]
                ]
                wav = np.concatenate(parts) if parts else wav[:0]
            yield {
                "key": obj["key"],
                "spk": obj.get("spk", ""),
                "wav": wav,
                "sample_rate": sr,
            }
        except WavRateError:
            raise
        except Exception as e:  # corrupt sample: warn + skip
            logger.warning("failed to read sample: %s", e)


def iter_feat_list(entries: Iterable[str]) -> Iterator[dict]:
    """JSON entry lines {key, feat, spk} -> {key, feat (T, F float32), spk};
    'feat' is a Kaldi matrix-ark rxspecifier 'file.ark:offset'."""
    from ..backend.kaldi_io import read_kaldi_matrix

    for line in entries:
        try:
            obj = json.loads(line)
            feat = np.asarray(read_kaldi_matrix(obj["feat"]), np.float32)
            yield {"key": obj["key"], "spk": obj.get("spk", ""), "feat": feat}
        except Exception as e:  # corrupt sample: warn + skip
            logger.warning("failed to read feat sample: %s", e)


def iter_tar_shards(paths: Iterable[str], sample_rate: int = 16000) -> Iterator[dict]:
    """Tar shards -> {key, wav (float32), sample_rate, spk}: KEY.wav and
    KEY.spk (or KEY.txt) members grouped by their shared prefix, streamed.
    A shard that fails to read is logged and skipped from that point; a
    wav at another rate than `sample_rate` raises WavRateError."""
    from .zstd_io import open_maybe_zstd

    for path in paths:
        zf = None
        try:
            # tarfile reads plain and gzip streams; zstd goes through libzstd
            zf = open_maybe_zstd(path)
            ctx = (tarfile.open(fileobj=zf, mode="r|") if zf is not None
                   else tarfile.open(path, "r|*"))
            with ctx as tf:
                cur_key: Optional[str] = None
                cur: dict = {}
                for member in tf:
                    if not member.isfile():
                        continue
                    base, _, ext = member.name.rpartition(".")
                    if base != cur_key:
                        if cur_key is not None and "wav" in cur:
                            yield cur | {"key": cur_key, "spk": cur.get("spk", "")}
                        cur_key, cur = base, {}
                    data = tf.extractfile(member).read()
                    if ext == "wav":
                        cur["wav"], cur["sample_rate"] = read_wav_bytes(data)
                        _check_rate(base, cur["sample_rate"], sample_rate)
                    elif ext in ("spk", "txt"):
                        cur["spk"] = data.decode("utf-8").strip()
                if cur_key is not None and "wav" in cur:
                    yield cur | {"key": cur_key, "spk": cur.get("spk", "")}
        except WavRateError:
            raise
        except Exception as e:  # corrupt shard: warn + skip
            logger.warning("failed to read shard %s: %s", path, e)
        finally:
            if zf is not None:
                zf.close()


_READERS = {"raw": iter_raw_list, "feat": iter_feat_list, "shard": iter_tar_shards}


def _reader(data_type: str):
    if data_type not in _READERS:
        raise ValueError(f"unknown data_type {data_type!r} (raw, shard or feat)")
    return _READERS[data_type]


def _read(data_type: str, entries: Iterable[str], sample_rate: int) -> Iterator[dict]:
    """The data type's reader over `entries`, wavs held to `sample_rate`."""
    if data_type == "feat":
        return iter_feat_list(entries)
    return _reader(data_type)(entries, sample_rate)


def shard_list_for_rank(
    entries: Sequence[str],
    epoch: int,
    rank: int = 0,
    world_size: int = 1,
    worker: int = 0,
    num_workers: int = 1,
    shuffle: bool = True,
    seed: int = 42,
) -> List[str]:
    """The epoch's list for one rank and worker: an epoch-seeded shuffle,
    then `[rank::world_size][worker::num_workers]`."""
    data = list(entries)
    if shuffle:
        rng = random.Random(seed + epoch)
        rng.shuffle(data)
    return data[rank::world_size][worker::num_workers]


def buffer_shuffle(it: Iterator, buffer_size: int, rng: random.Random) -> Iterator:
    """Streaming shuffle with a bounded buffer."""
    buf = []
    for x in it:
        buf.append(x)
        if len(buf) >= buffer_size:
            idx = rng.randrange(len(buf))
            buf[idx], buf[-1] = buf[-1], buf[idx]
            yield buf.pop()
    rng.shuffle(buf)
    yield from buf


def _random_chunk(x: np.ndarray, chunk_len: int, rng: random.Random) -> np.ndarray:
    """A random crop, or a tiled pad when short; samples (1-D) or frames
    (2-D, axis 0)."""
    n = len(x)
    if n >= chunk_len:
        start = rng.randint(0, n - chunk_len)
        return x[start : start + chunk_len]
    reps = chunk_len // max(n, 1) + 1
    return np.tile(x, (reps,) + (1,) * (x.ndim - 1))[:chunk_len]


@dataclasses.dataclass
class TrainPipelineConfig:
    data_type: str = "raw"  # 'raw' | 'shard' | 'feat'
    num_frms: int = 200
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    sample_rate: int = 16000
    shuffle: bool = True
    shuffle_size: int = 2500
    filter_min_frames: int = 100
    filter_max_frames: int = 800
    speed_perturb: bool = True
    aug_prob: float = 0.6
    rir_max_samples: int = 8000
    batch_size: int = 64
    drop_last: bool = True
    seed: int = 42
    # packed layout: each batch sorted into fixed-count slots [reverb |
    # noise | clean], so the device FFT-convolves only the reverb rows;
    # counts rounded to multiples of aug_align
    packed_aug: bool = True
    aug_align: int = 1


class TrainPipeline:
    """Data list -> device-ready numpy training batches.

    Batch fields: wav (B, L_in) float32 (L_in = speed_input_len(chunk) with
    speed perturbation, else the chunk), speed_idx (B,) int32 (with speed
    perturbation), label (B,) int32 (x3-expanded with speed perturbation);
    unpacked: aug_type (B,) int32 (0 none, 1 reverb, 2 noise), rir (B, R),
    noise (B, chunk), snr (B,); packed: rir (n_reverb, R), noise
    (n_noise, chunk), snr (n_noise,), rows ordered [reverb | noise | clean].
    `data_type='feat'` batches carry feat (B, num_frms, F) and label.
    """

    def __init__(
        self,
        data_list: Sequence[str],
        spk2id: Dict[str, int],
        cfg: TrainPipelineConfig = TrainPipelineConfig(),
        reverb_store: Optional[AugStore] = None,
        noise_store: Optional[AugStore] = None,
        rank: int = 0,
        world_size: int = 1,
        worker: int = 0,
        num_workers: int = 1,
    ):
        _reader(cfg.data_type)
        self.data_list = list(data_list)
        self.spk2id = spk2id
        self.cfg = cfg
        self.reverb_store = reverb_store
        self.noise_store = noise_store
        self.rank = rank
        self.world_size = world_size
        self.worker = worker
        self.num_workers = max(1, num_workers)
        self.epoch = 0
        self.chunk_samples = chunk_samples_for_frames(
            cfg.num_frms, cfg.frame_shift_ms, cfg.frame_length_ms, cfg.sample_rate
        )
        self.input_samples = (
            speed_input_len(self.chunk_samples) if cfg.speed_perturb else self.chunk_samples
        )
        self.aug_counts = self._compute_aug_counts()

    def _compute_aug_counts(self):
        """(n_reverb, n_noise) per batch for the packed layout: the expected
        shares of per-sample Bernoulli(aug_prob) draws split 50/50, a missing
        store's share falling through as in the unpacked path."""
        cfg = self.cfg
        if cfg.data_type == "feat" or not cfg.packed_aug:
            return (0, 0)
        a = max(1, cfg.aug_align)

        def rnd(x):
            return max(0, int(round(x / a)) * a)

        b, p = cfg.batch_size, cfg.aug_prob
        if self.reverb_store and self.noise_store:
            return (rnd(b * p / 2), rnd(b * p / 2))
        if self.noise_store:  # reverb draws fall through to noise
            return (0, rnd(b * p))
        if self.reverb_store:  # noise draws are dropped
            return (rnd(b * p / 2), 0)
        return (0, 0)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _samples(self) -> Iterator[dict]:
        cfg = self.cfg
        entries = shard_list_for_rank(
            self.data_list, self.epoch, self.rank, self.world_size,
            worker=self.worker, num_workers=self.num_workers,
            shuffle=cfg.shuffle, seed=cfg.seed,
        )
        it = _read(cfg.data_type, entries, cfg.sample_rate)
        rng = random.Random(cfg.seed + 77 * self.epoch + self.rank + 10007 * self.worker)
        if cfg.shuffle:
            it = buffer_shuffle(it, cfg.shuffle_size, rng)

        if cfg.data_type == "feat":
            for s in it:
                feat = s["feat"]
                if not cfg.filter_min_frames <= len(feat) <= cfg.filter_max_frames:
                    continue
                if s["spk"] not in self.spk2id:
                    continue
                yield {
                    "feat": _random_chunk(feat, cfg.num_frms, rng).astype(np.float32),
                    "label": np.int32(self.spk2id[s["spk"]]),
                }
            return

        min_samp = int(cfg.filter_min_frames * cfg.frame_shift_ms / 1000 * cfg.sample_rate)
        max_samp = int(cfg.filter_max_frames * cfg.frame_shift_ms / 1000 * cfg.sample_rate)
        nprng = np.random.default_rng(
            cfg.seed + 1000 * self.epoch + self.rank + 10007 * self.worker
        )
        n_rev, n_noise = self.aug_counts
        pos = 0  # slot within the current batch (packed layout)
        for s in it:
            wav = s["wav"]
            if not min_samp <= len(wav) <= max_samp:
                continue
            spk = s["spk"]
            if spk not in self.spk2id:
                continue
            label = self.spk2id[spk]
            speed_idx = 0
            if cfg.speed_perturb:
                speed_idx = rng.randint(0, 2)
                label = label + len(self.spk2id) * speed_idx  # x3 label space
            chunk = _random_chunk(wav, self.input_samples, rng)
            sample = {"wav": chunk.astype(np.float32), "label": np.int32(label)}
            if cfg.speed_perturb:
                sample["speed_idx"] = np.int32(speed_idx)
            if cfg.packed_aug:
                # the slot decides the augmentation; parameters drawn only
                # where needed
                if pos < n_rev:
                    _, r = self.reverb_store.random_one(nprng)
                    r = np.asarray(r, np.float32)[: cfg.rir_max_samples]
                    rir = np.zeros((cfg.rir_max_samples,), np.float32)
                    rir[: len(r)] = r
                    sample["rir"] = rir
                elif pos < n_rev + n_noise:
                    key, nz = self.noise_store.random_one(nprng)
                    sample["noise"] = _random_chunk(
                        np.asarray(nz, np.float32), self.chunk_samples, rng
                    ).astype(np.float32)
                    lo, hi = snr_range_for_key(key)
                    sample["snr"] = np.float32(rng.uniform(lo, hi))
            else:
                aug_type, snr = 0, 0.0
                rir = np.zeros((cfg.rir_max_samples,), np.float32)
                noise = np.zeros((self.chunk_samples,), np.float32)
                if cfg.aug_prob > rng.random() and (self.reverb_store or self.noise_store):
                    aug_type = rng.randint(1, 2)
                    if aug_type == 1 and self.reverb_store is not None:
                        _, r = self.reverb_store.random_one(nprng)
                        r = np.asarray(r, np.float32)[: cfg.rir_max_samples]
                        rir[: len(r)] = r
                    elif self.noise_store is not None:
                        aug_type = 2
                        key, nz = self.noise_store.random_one(nprng)
                        noise = _random_chunk(np.asarray(nz, np.float32), self.chunk_samples, rng)
                        lo, hi = snr_range_for_key(key)
                        snr = rng.uniform(lo, hi)
                    else:
                        aug_type = 0
                sample.update(
                    aug_type=np.int32(aug_type),
                    rir=rir,
                    noise=noise.astype(np.float32),
                    snr=np.float32(snr),
                )
            yield sample
            pos = (pos + 1) % cfg.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        buf: List[dict] = []
        for s in self._samples():
            buf.append(s)
            if len(buf) == self.cfg.batch_size:
                yield self._collate(buf)
                buf = []
        if buf and not self.cfg.drop_last:
            yield self._collate(buf)

    def _collate(self, samples: List[dict]) -> Dict[str, np.ndarray]:
        if not self.cfg.packed_aug:
            return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        n_rev, n_noise = self.aug_counts
        n = len(samples)
        n_rev = min(n_rev, n)
        n_noise = min(n_noise, max(0, n - n_rev))
        batch = {
            k: np.stack([s[k] for s in samples])
            for k in ("wav", "feat", "speed_idx", "label")
            if k in samples[0]
        }
        if n_rev or n_noise:
            batch["rir"] = (
                np.stack([s["rir"] for s in samples[:n_rev]]) if n_rev
                else np.zeros((0, self.cfg.rir_max_samples), np.float32)
            )
            noise_rows = samples[n_rev : n_rev + n_noise]
            batch["noise"] = (
                np.stack([s["noise"] for s in noise_rows]) if n_noise
                else np.zeros((0, self.chunk_samples), np.float32)
            )
            batch["snr"] = np.asarray([s["snr"] for s in noise_rows], np.float32)
        return batch


class PrefetchPipeline:
    """N worker threads, each a TrainPipeline over the `[worker::N]` stripe
    of this rank's list filling its own bounded queue, taken ROUND-ROBIN:
    the batch order is a pure function of (seed, epoch, N), whatever the
    threads' timing.  A worker that fails fails the epoch."""

    _END = object()

    def __init__(
        self,
        data_list: Sequence[str],
        spk2id: Dict[str, int],
        cfg: TrainPipelineConfig = TrainPipelineConfig(),
        reverb_store: Optional[AugStore] = None,
        noise_store: Optional[AugStore] = None,
        rank: int = 0,
        world_size: int = 1,
        num_workers: int = 4,
        prefetch: int = 4,
    ):
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.workers = [
            TrainPipeline(data_list, spk2id, cfg, reverb_store, noise_store, rank=rank,
                          world_size=world_size, worker=w, num_workers=self.num_workers)
            for w in range(self.num_workers)
        ]
        w0 = self.workers[0]  # TrainPipeline's surface, for bin/train
        self.cfg, self.spk2id = w0.cfg, w0.spk2id
        self.chunk_samples, self.input_samples = w0.chunk_samples, w0.input_samples
        self.aug_counts = w0.aug_counts

    def set_epoch(self, epoch: int) -> None:
        for w in self.workers:
            w.set_epoch(epoch)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        qs = [queue.Queue(maxsize=self.prefetch) for _ in self.workers]
        stop = threading.Event()

        def put(q, item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def feed(pipe, q):
            err = None
            try:
                for b in pipe:
                    if not put(q, b):
                        return
            except BaseException as e:  # noqa: BLE001 — raised in the consumer
                err = e
            finally:
                put(q, (self._END, err))

        threads = [threading.Thread(target=feed, args=(p, q), daemon=True)
                   for p, q in zip(self.workers, qs)]
        for t in threads:
            t.start()
        try:
            live = collections.deque(range(self.num_workers))
            while live:
                w = live[0]
                b = qs[w].get()
                if isinstance(b, tuple) and len(b) == 2 and b[0] is self._END:
                    if b[1] is not None:
                        raise RuntimeError(f"prefetch worker {w} failed") from b[1]
                    live.popleft()  # exhausted: the next worker keeps the turn
                    continue
                yield b
                live.rotate(-1)
        finally:
            stop.set()
            for q, t in zip(qs, threads):  # drain until each feeder sees stop
                for _ in range(50):
                    if not t.is_alive():
                        break
                    try:
                        while True:
                            q.get_nowait()
                    except queue.Empty:
                        pass
                    t.join(timeout=0.1)


class NativeRefusal(ValueError):
    """A training config the C++ loader does not take (bin/train runs
    PrefetchPipeline instead, as the JAX package's does)."""


class NativeTrainPipeline:
    """TrainPipeline's surface over the deterministic C++ loader: decode,
    filter, chunk, the speed draw and batch assembly run in C++ threads;
    Python draws the packed augmentation rows (rir / noise / snr) per
    batch.  Its sample order differs from TrainPipeline's (a full
    permutation, not a bounded-buffer shuffle) and is the JAX package's
    NativeTrainPipeline's, batch for batch.  Raw lists run Loader2, tar
    shards Loader3.

    Refused (NativeRefusal): `feat` data, unpacked augmentation with
    stores, `shuffle: false`, `drop_last: false`, VAD-cropped entries, xz
    shards, and zstd shards where the library has no libzstd."""

    def __init__(
        self,
        data_list: Sequence[str],
        spk2id: Dict[str, int],
        cfg: TrainPipelineConfig = TrainPipelineConfig(),
        reverb_store: Optional[AugStore] = None,
        noise_store: Optional[AugStore] = None,
        rank: int = 0,
        world_size: int = 1,
        num_threads: int = 8,
    ):
        from .native_loader import (
            DeterministicNativeLoader,
            DeterministicNativeShardLoader,
            native_zstd_available,
        )

        if cfg.data_type not in ("raw", "shard"):
            raise NativeRefusal(f"data_type {cfg.data_type!r} needs the python pipeline")
        if not cfg.packed_aug and (reverb_store or noise_store):
            raise NativeRefusal("the native pipeline needs packed_aug with aug stores")
        if not cfg.shuffle:
            raise NativeRefusal("the native pipeline always shuffles; shuffle=false needs "
                                "the python pipeline")
        if not cfg.drop_last:
            raise NativeRefusal("the native pipeline drops the last partial batch; "
                                "drop_last=false needs the python pipeline")
        self.cfg = cfg
        self.spk2id = spk2id
        self.reverb_store = reverb_store
        self.noise_store = noise_store
        self.rank = rank
        self.epoch = 0
        self.chunk_samples = chunk_samples_for_frames(
            cfg.num_frms, cfg.frame_shift_ms, cfg.frame_length_ms, cfg.sample_rate)
        self.input_samples = (
            speed_input_len(self.chunk_samples) if cfg.speed_perturb else self.chunk_samples)
        self.aug_counts = TrainPipeline._compute_aug_counts(self)
        min_samp = int(cfg.filter_min_frames * cfg.frame_shift_ms / 1000 * cfg.sample_rate)
        max_samp = int(cfg.filter_max_frames * cfg.frame_shift_ms / 1000 * cfg.sample_rate)
        common = dict(chunk_samples=self.input_samples, batch_size=cfg.batch_size,
                      num_spks=len(spk2id) if cfg.speed_perturb else 0, min_samples=min_samp,
                      max_samples=max_samp, seed=cfg.seed, num_threads=num_threads, rank=rank,
                      world_size=world_size, sample_rate=cfg.sample_rate)
        if cfg.data_type == "shard":
            unsupported = {(0xFD, 0x37): "xz"}
            if not native_zstd_available():
                unsupported[(0x28, 0xB5)] = "zstd"
            for sp in data_list:
                with open(sp, "rb") as f:
                    magic = tuple(f.read(2))
                if magic in unsupported:
                    raise NativeRefusal(f"{unsupported[magic]} shard {sp!r}: the native tar "
                                        "reader of this build does not stream it")
            self._loader = DeterministicNativeShardLoader(
                list(data_list), spk2id, shuffle_size=cfg.shuffle_size, **common)
        else:
            paths, labels, keys = [], [], []
            for line in data_list:
                obj = json.loads(line)
                if "vad" in obj:
                    raise NativeRefusal("VAD-cropped entries need the python pipeline")
                spk = obj.get("spk", "")
                if spk not in spk2id:
                    continue
                paths.append(obj["wav"])
                labels.append(spk2id[spk])
                keys.append(obj["key"])
            self._loader = DeterministicNativeLoader(paths, labels, keys=keys, **common)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        cfg = self.cfg
        n_rev, n_noise = self.aug_counts
        nprng = np.random.default_rng(cfg.seed + 1000 * self.epoch + self.rank)
        rng = random.Random(cfg.seed + 77 * self.epoch + self.rank)
        for wav, label, speed in self._loader.epoch(self.epoch):
            batch = {"wav": wav, "label": label}
            if cfg.speed_perturb:
                batch["speed_idx"] = speed
            if n_rev:
                rir = np.zeros((n_rev, cfg.rir_max_samples), np.float32)
                for i in range(n_rev):
                    _, r = self.reverb_store.random_one(nprng)
                    r = np.asarray(r, np.float32)[: cfg.rir_max_samples]
                    rir[i, : len(r)] = r
                batch["rir"] = rir
            elif n_noise:
                batch["rir"] = np.zeros((0, cfg.rir_max_samples), np.float32)
            if n_noise:
                noise = np.empty((n_noise, self.chunk_samples), np.float32)
                snr = np.empty((n_noise,), np.float32)
                for i in range(n_noise):
                    key, nz = self.noise_store.random_one(nprng)
                    noise[i] = _random_chunk(np.asarray(nz, np.float32), self.chunk_samples, rng)
                    lo, hi = snr_range_for_key(key)
                    snr[i] = rng.uniform(lo, hi)
                batch["noise"], batch["snr"] = noise, snr
            elif n_rev:
                batch["noise"] = np.zeros((0, self.chunk_samples), np.float32)
                batch["snr"] = np.zeros((0,), np.float32)
            yield batch
        failures = self._loader.decode_failures()
        if failures:
            logger.warning("native loader: %d item(s) skipped (wavs the C parser cannot "
                           "decode, or compressed / unreadable shards); such data needs the "
                           "python pipeline (num_workers: 0)", failures)

    def close(self) -> None:
        self._loader.close()


class EvalPipeline:
    """Whole-utterance extraction batches with length bucketing.

    Utterances are padded to a small set of lengths (powers-of-two frames)
    and their lengths travel with them, so masks keep results exact.
    Utterances longer than the largest base bucket are not cropped: the
    bucket set extends by doubling up to `max_bucket_frames`, with the
    bucket's batch size shrunk so batch x length stays bounded; only past
    `max_bucket_frames` is audio cropped, with a warning.
    """

    def __init__(
        self,
        data_list: Sequence[str],
        data_type: str = "raw",
        batch_size: int = 32,
        bucket_frames: Sequence[int] = (200, 400, 800, 1600, 3200),
        frame_shift_ms: float = 10.0,
        frame_length_ms: float = 25.0,
        sample_rate: int = 16000,
        extend_buckets: bool = True,
        max_bucket_frames: int = 51200,
    ):
        _reader(data_type)
        self.data_list = list(data_list)
        self.data_type = data_type
        self.batch_size = batch_size
        self.sample_rate = sample_rate
        if data_type == "feat":
            # precomputed features: bucket units are frames
            self.bucket_samples = list(bucket_frames)
            self.max_bucket_samples = max_bucket_frames
        else:
            self.bucket_samples = [
                chunk_samples_for_frames(b, frame_shift_ms, frame_length_ms, sample_rate)
                for b in bucket_frames
            ]
            self.max_bucket_samples = chunk_samples_for_frames(
                max_bucket_frames, frame_shift_ms, frame_length_ms, sample_rate
            )
        self.extend_buckets = extend_buckets

    def _bucket_for(self, n: int) -> int:
        for b in self.bucket_samples:
            if n <= b:
                return b
        b = self.bucket_samples[-1]
        if not self.extend_buckets:
            return b
        while n > b and b < self.max_bucket_samples:
            b = min(b * 2, self.max_bucket_samples)
        return b

    def _batch_for(self, bucket: int) -> int:
        """Shrink the batch for extended buckets so batch x samples stays
        bounded by batch_size x the largest base bucket."""
        base = self.bucket_samples[-1]
        if bucket <= base:
            return self.batch_size
        return max(1, self.batch_size * base // bucket)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        is_feat = self.data_type == "feat"
        it = _read(self.data_type, self.data_list, self.sample_rate)
        buckets: Dict[int, List[dict]] = {}
        for s in it:
            x = s["feat"] if is_feat else s["wav"]
            b = self._bucket_for(len(x))
            if len(x) > b:  # only past max_bucket_samples
                logger.warning(
                    "cropping %s from %d to %d %s (max_bucket_frames)",
                    s["key"], len(x), b, "frames" if is_feat else "samples",
                )
                x = x[:b]
            buckets.setdefault(b, []).append({"key": s["key"], "x": x, "length": len(x)})
            if len(buckets[b]) >= self._batch_for(b):
                yield self._collate(buckets.pop(b), b)
        for b, samples in buckets.items():
            if samples:
                yield self._collate(samples, b)

    def _collate(self, samples: List[dict], bucket: int) -> Dict[str, np.ndarray]:
        n = len(samples)
        lengths = np.asarray([s["length"] for s in samples], np.int32)
        keys = [s["key"] for s in samples]
        if self.data_type == "feat":
            feat = np.zeros((n, bucket, samples[0]["x"].shape[1]), np.float32)
            for i, s in enumerate(samples):
                feat[i, : s["length"]] = s["x"]
            return {"feat": feat, "feat_length": lengths, "keys": keys}
        wav = np.zeros((n, bucket), np.float32)
        for i, s in enumerate(samples):
            wav[i, : s["length"]] = s["x"]
        return {"wav": wav, "length": lengths, "keys": keys}
