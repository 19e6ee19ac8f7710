"""The port stands alone: no file of `wespeaker_hubert_tpu_torch` or
`chip_smoke.py` imports JAX, flax, optax, msgpack or the JAX package (the
port reads flax's msgpack checkpoints with its own reader), nor sklearn,
umap or hdbscan (the card's machine has none: the diarization's k-means,
spectral embedding and HDBSCAN are the port's own), and a process that
imports every port module, serves and diarizes on the CPU never loads
any of them."""

import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import setuptools

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "wespeaker_hubert_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "wespeaker_hubert_tpu",
             "sklearn", "umap", "hdbscan"}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_jax_imports(path):
    bad = FORBIDDEN.intersection(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def _module_names():
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


@pytest.mark.parametrize("name", [
    "bin.train", "train.state", "train.schedulers", "ops.augment", "models.projections",
    "data.aug_store", "utils.checkpoint", "utils.config", "ops.pipeline", "train.executor",
    "data.dataset", "data.zstd_io", "utils.embeddings", "backend.score", "backend.metrics",
    "backend.calibration", "bin.score", "bin.score_calibration", "bin.tools",
    "bin.average_model", "recipes.voxceleb_v2", "models.resnet", "utils.flax_msgpack",
    "bin.import_torch", "bin.export_torch", "bin.export_model",
    "ops.whisper_mel", "frontend.whisper", "models.whisper_pmfa",
    "recipes.voxceleb_v1_whisper_pmfa", "models.campplus", "models.res2net", "models.eres2net",
    "recipes.voxceleb_v2_wavlm", "models.tdnn", "models.xi_vector", "models.gemini_dfresnet",
    "models.samresnet", "models.repvgg", "models.redimnet",
    "ssl.dataset", "ssl.dino", "ssl.contrastive", "bin.train_dino", "bin.train_contrastive",
    "recipes.voxceleb_v3_dino", "recipes.voxceleb_v3_contrastive", "recipes.cnceleb_v3_finetune",
    "diar.rttm", "diar.subsegment", "diar.der", "diar.sad", "diar.silero", "diar.spectral",
    "diar.pahc", "diar.density", "cli.speaker", "cli.hub", "bin.serve",
    "recipes.voxconverse_v1", "recipes.voxconverse_v2",
    "backend.plda", "backend.processing", "backend.kaldi_io", "bin.plda_bins",
    "bin.train_plda", "bin.eval_plda", "bin.adapt_plda", "bin.embd_proc", "bin.compute_det",
    "bin.datadir", "utils.file_utils", "bin.infer_export", "recipes.sre_v2", "recipes.sre_v3",
])
def test_training_modules_are_checked(name):
    """The training, recipe, interop, Whisper, model-zoo, SSL, diarization and
    back-end (PLDA, SRE) slices' modules are among those the checks above and the no-JAX process below import."""
    assert "wespeaker_hubert_tpu_torch." + name in set(_module_names())
    assert not FORBIDDEN.intersection(_imported_roots(PORT / (name.replace(".", "/") + ".py")))


def test_cpu_service_runs_without_jax(tmp_path):
    script = textwrap.dedent(f"""
        import importlib, json, os, sys
        import numpy as np, torch
        for name in {list(_module_names())!r}:
            importlib.import_module(name)
        from wespeaker_hubert_tpu_torch.bin.serve import EmbeddingService
        from wespeaker_hubert_tpu_torch.models.registry import get_speaker_model

        d = {str(tmp_path)!r}
        cfg = {{"model": "ECAPA_TDNN_c512",
               "model_args": {{"feat_dim": 24, "embed_dim": 8}},
               "dataset_args": {{"fbank_args": {{"num_mel_bins": 24}}}}}}
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(cfg, f)
        torch.manual_seed(0)
        model = get_speaker_model("ECAPA_TDNN_c512")(feat_dim=24, embed_dim=8)
        torch.save(model.state_dict(), os.path.join(d, "avg_model.pt"))
        svc = EmbeddingService(d, device="cpu", max_batch=2, max_seconds=2.0,
                               chunk_frames=50)
        emb = svc.embed_samples(np.zeros(8000, np.float32) + 0.01)
        t = np.arange(64000) / 16000
        conv = (0.3 * np.sin(2 * np.pi * np.where(t % 2 < 1, 150, 240) * t)
                * (t % 1 < 0.8)).astype(np.float32)
        for clusterer in ("spectral", "density"):
            assert svc.speaker.diarize_pcm(conv, clusterer=clusterer)
        svc.close()
        print(json.dumps({{"dim": int(emb.shape[-1]),
                          "jax": sorted(m for m in sys.modules
                                        if m.split(".")[0] in {sorted(FORBIDDEN)!r})}}))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        cwd=str(tmp_path), env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"dim": 8, "jax": []}


def test_packaging_finds_the_port():
    found = setuptools.find_packages(where=str(ROOT), include=["wespeaker_hubert_tpu*"])
    for sub in ("", ".ops", ".models", ".train", ".data", ".utils", ".cli", ".bin",
                ".frontend", ".backend", ".recipes", ".ssl", ".diar"):
        assert "wespeaker_hubert_tpu_torch" + sub in found
    assert "wespeaker_hubert_tpu" in found
