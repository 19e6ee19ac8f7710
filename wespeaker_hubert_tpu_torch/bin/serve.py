"""Batch embedding and diarization server on PyTorch / CUDA.

Counterpart of `wespeaker_hubert_tpu/bin/serve.py`: a stdlib HTTP server
whose handler threads enqueue requests into micro-batching queues.  One
device thread drains up to `max_batch` embedding requests every
`batch_window_ms` and runs the chunked fixed-shape embedding path
(train/chunked.py); a second thread drains up to `diar_max_batch`
diarization requests per window and runs them as one
`Speaker.diarize_pcm_batch` (float32), whose per-conversation results equal
one-at-a-time `diarize_pcm`'s.  Endpoints:

  POST /embed        body: WAV bytes            -> {"embedding": [...]}
  POST /similarity   body: WAV||WAV (separator b"--8<--")
                                                -> {"similarity": s}
  POST /diarize      body: WAV bytes            -> {"segments": [{"utt",
                                                   "begin", "end", "speaker"}]}
  GET  /stats                                   -> throughput counters, the
                                                   diarization's under
                                                   "diarization"

and the KServe-v2 (Triton HTTP) protocol:

  GET  /v2/health/live | /v2/health/ready       -> 200
  GET  /v2/models/<name>                        -> model metadata
  POST /v2/models/<name>/infer                  -> outputs
       <name> = feature_extractor: wav -> CMN'd fbank "speech"
                speaker_model:     feats -> "embs"
                run, diarization:  "input" wav -> "LABELS" FP32 [N, 3]
                                   (begin, end, speaker) rows
                anything else:     WAV -> EMBEDDINGS

The KServe gRPC protocol is not ported (`--grpc_port` is refused).

    python -m wespeaker_hubert_tpu_torch.bin.serve --model_dir DIR \\
        [--device cuda] [--port 8501] [--f32]
"""

from __future__ import annotations

import copy
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..cli.speaker import Speaker
from ..data.wav_io import read_wav_bytes
from ..ops.fbank import fbank
from ..ops.feature_utils import apply_cmvn
from ..train.chunked import make_chunked_embed
from ..train.executor import cast_variables_bf16, make_eval_embed
from ..utils.observability import ThroughputMeter

__all__ = ["EmbeddingService", "make_http_server", "serve", "BOUNDARY"]

BOUNDARY = b"--8<--"
NOT_PORTED = "not ported yet"
_DIAR_MODELS = ("run", "diarization")

logger = logging.getLogger(__name__)

# queue item: (job or None for an embed request, payload, reply queue)
_Item = Tuple[Optional[Callable], object, "queue.Queue"]


class EmbeddingService:
    """Micro-batching wrapper around a Speaker model directory."""

    def __init__(
        self,
        model_dir: str,
        device="cuda",
        max_batch: int = 16,
        batch_window_ms: float = 5.0,
        max_seconds: float = 30.0,
        chunk_frames: int = 198,
        bf16: bool = True,
    ):
        self.speaker = Speaker(model_dir, device=device)
        self.device = self.speaker.device
        self.max_batch = max_batch
        self.window = batch_window_ms / 1000.0
        sr = self.speaker.resample_rate
        self.max_samples = int(max_seconds * sr)
        # length buckets: a batch pads to the smallest bucket covering its
        # longest utterance, and always to max_batch rows, so a request's
        # embedding does not depend on what it was batched with
        self.buckets = []
        s = 2.0
        while s < max_seconds:
            self.buckets.append(int(s * sr))
            s *= 2
        self.buckets.append(self.max_samples)
        self._compute_dtype = torch.bfloat16 if bf16 else None
        net = self.speaker.net
        if bf16:
            net = cast_variables_bf16(copy.deepcopy(net))
        self._net = net
        self._embed = make_chunked_embed(
            net, self.speaker.fbank_cfg, chunk_frames,
            compute_dtype=self._compute_dtype,
        )
        self._feats_embed = make_eval_embed(net, compute_dtype=self._compute_dtype)
        self.embed_dim = int(net.backbone.embed_dim)
        self.meter = ThroughputMeter()
        # /diarize has its own counters: mixed into the embedding meter it
        # would corrupt that path's rtf and audio_seconds_per_s
        self.diar_meter = ThroughputMeter()
        self.diar_max_batch = 8
        self._diar_window = max(self.window, 0.02)
        self._q: "queue.Queue[_Item]" = queue.Queue()
        self._diar_q: "queue.Queue[Tuple[np.ndarray, str, queue.Queue]]" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()
        # run every bucket shape once before serving, so the first request
        # of a length does not pay the kernel build or library set-up
        for b in self.buckets:
            self._call(self._embed_batch, [np.zeros(b, np.float32)], False)
        self.speaker.warm_diarize(max_seconds)
        self._diar_worker = threading.Thread(target=self._diar_loop, daemon=True)
        self._diar_worker.start()

    # ------------------------------------------------------------- device
    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            embeds: List[_Item] = []
            jobs: List[_Item] = []
            (jobs if first[0] is not None else embeds).append(first)
            if embeds:
                deadline = time.perf_counter() + self.window
                while len(embeds) < self.max_batch:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    try:
                        item = self._q.get(timeout=remaining)
                    except queue.Empty:
                        break
                    (jobs if item[0] is not None else embeds).append(item)
                self._run_embeds(embeds)
            for fn, args, out_q in jobs:
                try:
                    out_q.put((True, fn(*args)))
                except Exception as e:  # noqa: BLE001 — report to the caller
                    logger.exception("device job failed")
                    out_q.put((False, e))

    def _diar_loop(self):
        while not self._stop.is_set():
            try:
                first = self._diar_q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self._diar_window
            while len(batch) < self.diar_max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._diar_q.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                outs = self.speaker.diarize_pcm_batch(
                    [w for w, _, _ in batch], utts=[u for _, u, _ in batch])
                results = [(True, o) for o in outs]
            except Exception as e:  # noqa: BLE001 — report to every waiting client
                logger.exception("diarization batch failed")
                results = [(False, e)] * len(batch)
            for (_, _, out_q), res in zip(batch, results):
                out_q.put(res)

    def _run_embeds(self, items: List[_Item]):
        try:
            emb = self._embed_batch([w for _, w, _ in items])
            results = [(True, e) for e in emb]
        except Exception as e:  # noqa: BLE001 — report to every waiting client
            logger.exception("embedding batch failed")
            results = [(False, e)] * len(items)
        for (_, _, out_q), res in zip(items, results):
            out_q.put(res)

    def _embed_batch(self, wavs: List[np.ndarray], count: bool = True) -> np.ndarray:
        n = len(wavs)
        longest = max(len(w) for w in wavs)
        bucket = self.bucket_for(longest)
        wav = np.zeros((self.max_batch, bucket), np.float32)
        lengths = np.zeros((self.max_batch,), np.int32)
        for i, w in enumerate(wavs):
            w = w[: self.max_samples]
            wav[i, : len(w)] = w
            lengths[i] = len(w)
        emb = self._embed({
            "wav": torch.from_numpy(wav).to(self.device),
            "length": torch.from_numpy(lengths).to(self.device),
        })
        out = emb[:n].cpu().numpy()
        if count:
            audio_s = float(lengths[:n].sum()) / self.speaker.resample_rate
            self.meter.update(audio_s, n)
        return out

    def _call(self, fn: Callable, *args):
        """Run fn(*args) on the device thread and return its result."""
        out_q: queue.Queue = queue.Queue()
        self._q.put((fn, args, out_q))
        return self._reply(out_q)

    @staticmethod
    def _reply(out_q: queue.Queue):
        ok, payload = out_q.get(timeout=300)
        if not ok:
            raise payload
        return payload

    def bucket_for(self, n: int) -> int:
        """Padded length of a batch whose longest wav has n samples."""
        return next(b for b in self.buckets if b >= min(n, self.max_samples))

    # --------------------------------------------------------------- api
    def _samples(self, data: bytes) -> np.ndarray:
        """A request's WAV body -> float32 samples at the model rate."""
        wav, sr = read_wav_bytes(data)
        if sr != self.speaker.resample_rate:
            raise ValueError(
                f"sample rate {sr}, the model takes {self.speaker.resample_rate}"
            )
        return wav

    def embed_wav_bytes(self, data: bytes) -> np.ndarray:
        return self.embed_samples(self._samples(data))

    def embed_samples(self, wav: np.ndarray) -> np.ndarray:
        """Embed raw float32 samples at the model sample rate."""
        out_q: queue.Queue = queue.Queue()
        self._q.put((None, np.asarray(wav, np.float32).reshape(-1), out_q))
        return self._reply(out_q)

    def diarize_wav_bytes(self, data: bytes, utt: str = "unk"):
        return self.diarize_samples(self._samples(data), utt=utt)

    def diarize_samples(self, wav: np.ndarray, utt: str = "unk"):
        """Diarize float32 samples at the model rate through the
        diarization queue: (utt, begin, end, speaker) segments."""
        wav = np.asarray(wav, np.float32).reshape(-1)
        out_q: queue.Queue = queue.Queue()
        self._diar_q.put((wav, utt, out_q))
        ok, payload = out_q.get(timeout=600)
        if not ok:
            raise payload
        self.diar_meter.update(len(wav) / self.speaker.resample_rate, 1)
        return payload

    def similarity(self, a: bytes, b: bytes) -> float:
        e1 = self.embed_wav_bytes(a)
        e2 = self.embed_wav_bytes(b)
        return self.speaker.cosine_similarity(e1, e2)

    def features_samples(self, wav: np.ndarray) -> np.ndarray:
        """Kaldi fbank + per-utterance CMN -> (T, num_mel_bins): the
        'feature_extractor' KServe model."""
        wav = np.asarray(wav, np.float32).reshape(-1)[: self.max_samples]
        return self._call(self._features, wav)

    def _features(self, wav: np.ndarray) -> np.ndarray:
        n = len(wav)
        w = np.zeros((self.bucket_for(n),), np.float32)
        w[:n] = wav
        with torch.inference_mode():
            feats, lens = fbank(
                torch.from_numpy(w[None]).to(self.device),
                self.speaker.fbank_cfg,
                lengths=torch.tensor([n], dtype=torch.int32, device=self.device),
            )
            feats = apply_cmvn(feats, lengths=lens)
        return feats[0, : int(lens[0])].cpu().numpy()

    def embed_feats_samples(self, feats: np.ndarray) -> np.ndarray:
        """(T, num_mel_bins) features -> embedding: the 'speaker_model'
        KServe model.  Pow2-bucketed T with a validity mask; the eval path
        re-applies mean-CMN, a no-op on already-CMN'd input."""
        feats = np.asarray(feats, np.float32)
        if feats.ndim == 3:
            feats = feats[0]
        return self._call(self._embed_feats, feats)

    def _embed_feats(self, feats: np.ndarray) -> np.ndarray:
        t, f = feats.shape
        bucket = max(128, 1 << max(t - 1, 1).bit_length())
        pad = np.zeros((1, bucket, f), np.float32)
        pad[0, :t] = feats
        emb = self._feats_embed({
            "feat": torch.from_numpy(pad).to(self.device),
            "feat_length": torch.tensor([t], dtype=torch.int32, device=self.device),
        })
        return emb[0].cpu().numpy()

    def stats(self) -> dict:
        t = self.meter.totals()
        t["audio_seconds_per_s"] = self.meter.audio_seconds_per_s
        t["rtf"] = self.meter.rtf
        t["device"] = (
            torch.cuda.get_device_name(self.device)
            if self.device.type == "cuda" else "cpu"
        )
        d = self.diar_meter.totals()
        d["audio_seconds_per_s"] = self.diar_meter.audio_seconds_per_s
        d["rtf"] = self.diar_meter.rtf
        t["diarization"] = d
        return t

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5)
        self._diar_worker.join(timeout=5)


def _make_handler(service: EmbeddingService):
    nm = int(service.speaker.fbank_cfg.num_mel_bins)

    def metadata(name):
        if name in _DIAR_MODELS:
            inputs = [{"name": "input", "datatype": "FP32", "shape": [1, -1]}]
            outputs = [{"name": "LABELS", "datatype": "FP32", "shape": [-1, 3]}]
        elif name == "feature_extractor":
            inputs = [{"name": "wav", "datatype": "FP32", "shape": [1, -1]}]
            outputs = [{"name": "speech", "datatype": "FP32", "shape": [-1, nm]}]
        elif name == "speaker_model":
            inputs = [{"name": "feats", "datatype": "FP32", "shape": [-1, nm]}]
            outputs = [{"name": "embs", "datatype": "FP32",
                        "shape": [service.embed_dim]}]
        else:
            inputs = [{"name": "WAV", "datatype": "FP32", "shape": [1, -1]}]
            outputs = [{"name": "EMBEDDINGS", "datatype": "FP32",
                        "shape": [1, service.embed_dim]}]
        return {"name": name, "platform": "pytorch", "inputs": inputs,
                "outputs": outputs}

    def infer(model, req):
        tensors = {t["name"]: t for t in req.get("inputs", [])}
        if model in _DIAR_MODELS:
            if "input" not in tensors:
                raise ValueError("missing input tensor 'input'")
            wav = np.asarray(tensors["input"]["data"], np.float32).reshape(-1)
            rows = [[float(b), float(e), float(s)]
                    for _u, b, e, s in service.diarize_samples(wav)]
            return {"name": "LABELS", "datatype": "FP32", "shape": [len(rows), 3],
                    "data": [x for r in rows for x in r]}
        if model == "feature_extractor":
            if "wav" not in tensors:
                raise ValueError("missing input tensor 'wav'")
            wav = np.asarray(tensors["wav"]["data"], np.float32).reshape(-1)
            feats = service.features_samples(wav)
            return {"name": "speech", "datatype": "FP32",
                    "shape": [int(feats.shape[0]), int(feats.shape[1])],
                    "data": [float(x) for x in feats.ravel()]}
        if model == "speaker_model":
            if "feats" not in tensors:
                raise ValueError("missing input tensor 'feats'")
            tf = tensors["feats"]
            shape = ([d for d in tf["shape"] if d != 1]
                     if len(tf["shape"]) > 2 else tf["shape"])
            feats = np.asarray(tf["data"], np.float32).reshape(shape)
            emb = service.embed_feats_samples(feats)
            return {"name": "embs", "datatype": "FP32",
                    "shape": [int(emb.shape[-1])],
                    "data": [float(x) for x in emb.ravel()]}
        if "WAV" not in tensors:
            raise ValueError("missing input tensor 'WAV'")
        wav = np.asarray(tensors["WAV"]["data"], np.float32).reshape(-1)
        emb = service.embed_samples(wav)
        # honor the requested output name (reference Triton clients read
        # back "EMBEDDINGS"; older clients used "EMB")
        reqs = req.get("outputs", [])
        oname = (reqs[0].get("name") if reqs else None) or "EMBEDDINGS"
        return {"name": oname, "datatype": "FP32",
                "shape": [1, int(emb.shape[-1])],
                "data": [float(x) for x in emb.ravel()]}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/stats":
                self._json(200, service.stats())
            elif self.path in ("/v2/health/live", "/v2/health/ready", "/v2"):
                self._json(200, {})
            elif self.path.startswith("/v2/models/"):
                name = self.path[len("/v2/models/"):].split("/")[0]
                self._json(200, metadata(name))
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(n)
            try:
                if self.path == "/embed":
                    emb = service.embed_wav_bytes(data)
                    self._json(200, {"embedding": emb.tolist()})
                elif self.path == "/similarity":
                    a, b = data.split(BOUNDARY, 1)
                    self._json(200, {"similarity": service.similarity(a, b)})
                elif self.path == "/diarize":
                    segs = service.diarize_wav_bytes(data)
                    self._json(200, {"segments": [
                        {"utt": u, "begin": b, "end": e, "speaker": s}
                        for u, b, e, s in segs
                    ]})
                elif self.path.startswith("/v2/models/") and self.path.endswith(
                    "/infer"
                ):
                    model = self.path.split("/")[3]
                    out = infer(model, json.loads(data))
                    self._json(200, {"model_name": model, "outputs": [out]})
                else:
                    self._json(404, {"error": "unknown path"})
            except Exception as e:  # noqa: BLE001 — report to client
                self._json(400, {"error": str(e)})

    return Handler


class _HTTPServer(ThreadingHTTPServer):
    # a burst of concurrent clients must not overflow socketserver's
    # default listen backlog of 5
    request_queue_size = 128
    daemon_threads = True


def make_http_server(service: EmbeddingService, host: str, port: int):
    """The HTTP front end of `service` (port 0 picks a free port)."""
    return _HTTPServer((host, port), _make_handler(service))


def serve(model_dir: str, host: str = "0.0.0.0", port: int = 8501,
          grpc_port: Optional[int] = None, **kwargs):
    if grpc_port:
        raise NotImplementedError(f"the KServe gRPC protocol is {NOT_PORTED}")
    service = EmbeddingService(model_dir, **kwargs)
    server = make_http_server(service, host, port)
    print(f"serving {model_dir} on {host}:{port} ({service.stats()['device']})")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.close()


def main():
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--model_dir", required=True)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8501)
    p.add_argument("--grpc_port", type=int, default=None,
                   help="the KServe gRPC protocol: not ported, refused")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--max_batch", type=int, default=16)
    p.add_argument("--f32", action="store_true",
                   help="disable bf16 inference (default: bf16 on)")
    args = p.parse_args()
    serve(args.model_dir, args.host, args.port, grpc_port=args.grpc_port, device=args.device,
          max_batch=args.max_batch, bf16=not args.f32)


if __name__ == "__main__":
    main()
