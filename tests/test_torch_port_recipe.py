"""Port parity for the flagship recipe's training half and the recipe
itself, on the CPU at a small size.

- the port's YAML reader against `yaml.safe_load` on every config under
  `examples/` and on YAML 1.1's edge scalars, and its dotted overrides
  against the JAX package's `apply_overrides`;
- tar shards (plain, gzip, zstd) written by both packages: the port's
  `TrainPipeline(data_type="shard")` yields the JAX pipeline's batches;
- two fbank ECAPA train steps (narrow ECAPA, batch 4, dither 0, SpecAug
  off, speed perturbation and packed augmentation) against JAX's
  `make_train_step`: loss and updates within STEP_TOL (the first step's
  loss within 1e-4);
- `make_train_step(num_steps=2)` against two single steps, SpecAug applied
  once per step (torch only);
- `recipes.voxceleb_v2` stages 1-7 with `--device cpu` on a tiny config.
"""

import glob
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from tests.torch_port_refs import FastJit
from tests.test_torch_port_train import _randomize, _store_arrays
from tests.test_torch_port_train_step import STEP_TOL
from wespeaker_hubert_tpu.bin import tools as jax_tools
from wespeaker_hubert_tpu.data import AugStore as JaxAugStore
from wespeaker_hubert_tpu.data import TrainPipeline as JaxTrainPipeline
from wespeaker_hubert_tpu.data import TrainPipelineConfig as JaxPipelineConfig
from wespeaker_hubert_tpu.models.ecapa_tdnn import EcapaTdnn as JaxEcapa
from wespeaker_hubert_tpu.models.projections import ArcMarginProduct as JaxArcMargin
from wespeaker_hubert_tpu.models.speaker_net import SpeakerNet as JaxSpeakerNet
from wespeaker_hubert_tpu.ops.fbank import FbankConfig as JaxFbankConfig
from wespeaker_hubert_tpu.ops.pipeline import FeaturePipelineConfig as JaxFeatureConfig
from wespeaker_hubert_tpu.train import schedulers as jax_sched
from wespeaker_hubert_tpu.train.executor import make_train_step as jax_make_train_step
from wespeaker_hubert_tpu.train.state import TrainState as JaxTrainState
from wespeaker_hubert_tpu.train.state import make_optimizer as jax_make_optimizer
from wespeaker_hubert_tpu.utils.config import apply_overrides as jax_apply_overrides
from wespeaker_hubert_tpu_torch.bin import tools
from wespeaker_hubert_tpu_torch.data.aug_store import AugStore
from wespeaker_hubert_tpu_torch.data.dataset import TrainPipeline, TrainPipelineConfig
from wespeaker_hubert_tpu_torch.data.wav_io import write_wav
from wespeaker_hubert_tpu_torch.data.zstd_io import zstd_available
from wespeaker_hubert_tpu_torch.models.convert_jax import from_jax_variables
from wespeaker_hubert_tpu_torch.models.ecapa_tdnn import EcapaTdnn
from wespeaker_hubert_tpu_torch.models.projections import ArcMarginProduct
from wespeaker_hubert_tpu_torch.models.speaker_net import (
    SpeakerNet,
    load_speaker_state,
    speaker_state_dict,
)
from wespeaker_hubert_tpu_torch.ops import pipeline as port_pipeline
from wespeaker_hubert_tpu_torch.ops.fbank import FbankConfig
from wespeaker_hubert_tpu_torch.ops.pipeline import FeaturePipelineConfig
from wespeaker_hubert_tpu_torch.recipes import voxceleb_v2
from wespeaker_hubert_tpu_torch.train import executor, schedulers
from wespeaker_hubert_tpu_torch.train.executor import make_train_step
from wespeaker_hubert_tpu_torch.train.state import TrainState, make_optimizer
from wespeaker_hubert_tpu_torch.utils.config import (YamlSubsetError, apply_overrides, coerce_value,
                                                  loads)

ROOT = Path(__file__).resolve().parents[1]
T = torch.from_numpy


# ------------------------------------------------------------------ YAML
@pytest.mark.parametrize(
    "path", sorted(glob.glob(str(ROOT / "examples" / "**" / "*.yaml"), recursive=True)),
    ids=lambda p: os.path.relpath(p, ROOT / "examples"))
def test_yaml_reader_matches_pyyaml(path):
    text = Path(path).read_text()
    assert loads(text) == yaml.safe_load(text)


EDGE_SCALARS = [
    "1e-3", "1.0e-3", "1.0e+3", "1.0e3", ".5", "-.5", "+.inf", "-.INF", ".NaN", "010", "0o10",
    "0x1F", "0b101", "1_000", "1:3x", "09", "3.", "yes", "No", "off", "ON",
    "y", "~", "null", "NULL", "", "2024-01-02x", "True",
    "'it''s'", '"tab\\tand \\u00e9"', "a:b", "plain text # comment", "[1, 2.0, x, 'y', [a]]",
    "{a: 1, b: {c: null}, d: [1e-3, 1.0e-3]}", "[a: 1, b]",
]


def test_yaml_reader_edge_scalars_and_blocks():
    for text in EDGE_SCALARS:
        got, want = loads(text), yaml.safe_load(text)
        if isinstance(want, float) and want != want:
            assert got != got, text
        else:
            assert got == want and type(got) is type(want), (text, got, want)
    doc = ("a:\n  - 1\n  - b: 2\n    c: [x, y]\n  -\n    - nested\nk:\n- same indent\n- two\n"
           "m: {x: 1}   # c\n\"q k\": 'v'\n---tail: 1\n")
    doc = doc.replace("---tail: 1\n", "")
    assert loads(doc) == yaml.safe_load(doc)
    for bad in ("a: &x 1", "a: !!str 1", "a: |\n  text", "a: [1,\n  2]", '"\\N"'):
        with pytest.raises(ValueError):
            loads(bad)
    # PyYAML reads these as sexagesimal numbers or timestamps: refused
    for bad in ("190:20:30", "1:30.5", "-1:30", "2024-01-02", "2001-12-14t21:59:43.10-05:00",
                "a: [2024-01-02]"):
        assert not isinstance(yaml.safe_load(bad), str)
        with pytest.raises(YamlSubsetError):
            loads(bad)


def test_overrides_match_jax():
    conf = loads((ROOT / "examples/voxceleb/v2/conf/ecapa_tdnn.yaml").read_text())
    items = ["dataset_args.num_frms=150", "scheduler_args.final_lr=1e-5", "loop_steps=2",
             "model_init=null", "dataset_args.fbank_args={num_mel_bins: 64, dither: 0.0}",
             "exp_dir=exp/x", "new.deep.key=[1, on]", "seed=0x10"]
    assert apply_overrides(conf, items) == jax_apply_overrides(conf, items)
    for raw in ("1e-3", "1.5", "true", "abc", "[1, 2]"):
        assert coerce_value(raw) == jax_apply_overrides({}, [f"k={raw}"])["k"]


# ---------------------------------------------------------------- shards
def _write_corpus(root, n=10, seed=0):
    rng = np.random.default_rng(seed)
    scp, u2s = [], []
    for i in range(n):
        x = (rng.standard_normal(int(16000 * rng.uniform(0.7, 1.4))) * 0.1).astype(np.float32)
        path = os.path.join(root, f"u{i}.wav")
        write_wav(path, x)
        scp.append(f"u{i} {path}")
        u2s.append(f"u{i} s{i % 3}")
    Path(root, "wav.scp").write_text("\n".join(scp) + "\n")
    Path(root, "utt2spk").write_text("\n".join(u2s) + "\n")


@pytest.mark.parametrize("compress", [None, "gz", "zstd"], ids=["plain", "gz", "zstd"])
def test_shard_pipeline_matches_jax(tmp_path, compress):
    if compress == "zstd" and not zstd_available():
        pytest.skip("libzstd is not on this host")
    _write_corpus(str(tmp_path))
    lists = {}
    for tag, mod in (("jax", jax_tools), ("port", tools)):
        paths = mod.make_shard_list(str(tmp_path / "wav.scp"), str(tmp_path / "utt2spk"),
                                    str(tmp_path / f"{tag}_shards"), str(tmp_path / f"{tag}.list"),
                                    num_utts_per_shard=3, num_workers=1, compress=compress)
        assert len(paths) == 4
        lists[tag] = [ln for ln in (tmp_path / f"{tag}.list").read_text().splitlines() if ln]
    spk2id = {"s0": 0, "s1": 1, "s2": 2}
    rirs, noises = _store_arrays()
    kw = dict(data_type="shard", num_frms=30, shuffle_size=4, filter_min_frames=50,
              filter_max_frames=200, aug_prob=0.6, rir_max_samples=400, batch_size=4, seed=7,
              drop_last=False)
    want_pipe = JaxTrainPipeline(lists["jax"], spk2id, JaxPipelineConfig(**kw),
                                 JaxAugStore(arrays=rirs), JaxAugStore(arrays=noises))
    for tag in ("port", "jax"):  # the port reads its own shards and JAX's
        got_pipe = TrainPipeline(lists[tag], spk2id, TrainPipelineConfig(**kw),
                                 AugStore(arrays=rirs), AugStore(arrays=noises))
        for epoch in (0, 1):
            got_pipe.set_epoch(epoch)
            want_pipe.set_epoch(epoch)
            got, want = list(got_pipe), list(want_pipe)
            assert len(got) == len(want) == 3
            for g, w in zip(got, want):
                assert sorted(g) == sorted(w)
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=f"{tag} {epoch} {k}")


# -------------------------------------------------------- fbank train step
CHUNK = 8240  # num_frms 50
N_CLASS = 9


def _voiced_list(root, n=8, seed=21):
    """JSONL raw-list lines of speech-like utterances: a harmonic stack
    under a syllable-rate envelope and a noise floor, each with its own
    pitch, rate, depth and level.  Stationary (e.g. white-noise) utterances
    would give the pooled statistics almost no variance over a batch of 4
    (under 1e-4 of their square), and flax's E[x^2] - E[x]^2 in the
    BatchNorm after pooling would turn float32 rounding into update
    differences past STEP_TOL: JAX's step against itself on the wav times
    (1 + 2^-20 noise) differs by 2.8e-3 (relative L2) on white noise,
    2.3e-3 on steady tones, and 2.8e-4 on these utterances."""
    import json

    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        t = np.arange(int(16000 * rng.uniform(0.7, 1.4))) / 16000
        f0 = rng.uniform(90, 300)
        x = sum(rng.uniform(0.02, 0.1) * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6))
                for h in range(1, 6))
        env = np.clip(np.sin(2 * np.pi * rng.uniform(2, 7) * t + rng.uniform(0, 6)), 0, None)
        x = x * env ** rng.uniform(0.3, 3) * rng.uniform(0.2, 3)
        x = x + rng.uniform(0.002, 0.05) * rng.standard_normal(len(t))
        path = os.path.join(root, f"v{i}.wav")
        write_wav(path, x.astype(np.float32))
        lines.append(json.dumps({"key": f"v{i}", "wav": path, "spk": f"s{i % 3}"}))
    return lines


def _fbank_batches(tmp_path):
    """Two packed batches of 4 (one reverb row, one noise row each) with
    speed perturbation, from the JAX pipeline."""
    lines = _voiced_list(str(tmp_path))
    rirs, noises = _store_arrays(22)
    cfg = JaxPipelineConfig(num_frms=50, shuffle_size=4, filter_min_frames=50,
                            filter_max_frames=200, aug_prob=0.5, rir_max_samples=400,
                            batch_size=4, seed=3)
    pipe = JaxTrainPipeline(lines, {"s0": 0, "s1": 1, "s2": 2}, cfg, JaxAugStore(arrays=rirs),
                            JaxAugStore(arrays=noises))
    batches = list(pipe)[:2]
    assert len(batches) == 2 and batches[0]["rir"].shape[0] == 1
    return batches


SCHED = dict(num_epochs=2, epoch_iter=2, initial_lr=0.001, final_lr=0.00025, warm_up_epoch=1)
MARGIN = dict(epoch_iter=2, increase_start_epoch=1, fix_start_epoch=2, initial_margin=0.0,
              final_margin=0.2)


def _port_ecapa(sd=None, dither=0.0, spec_aug=False, num_steps=1, seed=0):
    port = SpeakerNet(EcapaTdnn(32, 32, 16, "ASTP", True), None,
                      ArcMarginProduct(16, N_CLASS, 32.0))
    if sd is not None:
        missing, unexpected = load_speaker_state(port, sd)
        assert not missing and not unexpected
    state = TrainState(port, make_optimizer(port, "SGD", 0.9, True, 1e-4),
                       schedulers.ExponentialDecrease(**SCHED))
    fcfg = FeaturePipelineConfig(fbank=FbankConfig(num_mel_bins=32, dither=dither),
                                 spec_aug=spec_aug)
    step = make_train_step(port, state.lr_schedule, schedulers.MarginSchedule(**MARGIN),
                           feature_cfg=fcfg, chunk_samples=CHUNK, num_steps=num_steps, seed=seed)
    return port, state, step


def test_fbank_ecapa_train_step_matches_jax(tmp_path):
    """Two steps of the flagship recipe's step at a narrow width: fbank (32
    mels, dither 0) -> CMVN -> ECAPA (GLOB, 32 channels) -> ArcMargin -> SGD
    with Nesterov and weight decay, float32."""
    net = JaxSpeakerNet(backbone=JaxEcapa(32, 32, 16, "ASTP", True, False),
                        projection=JaxArcMargin(16, N_CLASS, 32.0))
    jlr, jmargin = jax_sched.ExponentialDecrease(**SCHED), jax_sched.MarginSchedule(**MARGIN)
    tx = jax_make_optimizer(jlr, "SGD", 0.9, True, 1e-4)
    shapes = jax.eval_shape(lambda: net.init(
        jax.random.key(0), jnp.zeros((1, 50, 32)), jnp.zeros((1,), jnp.int32), 0.0, train=True))
    rng = np.random.default_rng(29)
    params, stats = _randomize(shapes["params"], rng), _randomize(shapes["batch_stats"], rng)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                          opt_state=tx.init(params))
    jfcfg = JaxFeatureConfig(fbank=JaxFbankConfig(num_mel_bins=32, dither=0.0), spec_aug=False)
    jstep = FastJit(jax_make_train_step(net, tx, jlr, jmargin, feature_cfg=jfcfg,
                                        chunk_samples=CHUNK))
    port, pstate, pstep = _port_ecapa(
        from_jax_variables("ECAPA_TDNN_GLOB_c512", {"params": params, "batch_stats": stats}))

    for step, batch in enumerate(_fbank_batches(tmp_path)):
        before = {k: v.clone() for k, v in speaker_state_dict(port).items()}
        jbefore = from_jax_variables("ECAPA_TDNN_GLOB_c512",
                                     {"params": state.params, "batch_stats": state.batch_stats})
        state, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.key(1))
        pm = pstep(pstate, {k: T(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=STEP_TOL[step][0])
        np.testing.assert_allclose([pm["lr"], pm["margin"]],
                                   [float(jm["lr"]), float(jm["margin"])], rtol=1e-6)
        after = speaker_state_dict(port)
        jafter = from_jax_variables("ECAPA_TDNN_GLOB_c512",
                                    {"params": state.params, "batch_stats": state.batch_stats})
        ups, jups = [], []
        for name, w in jafter.items():
            if name.endswith("num_batches_tracked"):
                continue
            upd, jupd = (after[name] - before[name]).numpy(), (w - jbefore[name]).numpy()
            ups.append(upd.ravel())
            jups.append(jupd.ravel())
            if np.linalg.norm(jupd) > 1e-5:
                cos = upd.ravel() @ jupd.ravel() / (np.linalg.norm(upd) * np.linalg.norm(jupd))
                assert cos >= STEP_TOL[step][2], (step, name, cos)
        ups, jups = np.concatenate(ups), np.concatenate(jups)
        rel = np.linalg.norm(ups - jups) / np.linalg.norm(jups)
        assert rel <= STEP_TOL[step][1], (step, rel)
    assert pstate.step == 2


def test_two_step_call_equals_two_single_steps(tmp_path, monkeypatch):
    """num_steps=2 on stacked batches is two single steps, bit for bit,
    with dither and SpecAug on; SpecAug runs once per step for an fbank
    model (in wav_to_features, not again in the step)."""
    calls = []

    def counted(fn):
        def wrapper(*a, **k):
            calls.append(fn)
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(port_pipeline, "spec_aug", counted(port_pipeline.spec_aug))
    monkeypatch.setattr(executor, "spec_aug", counted(executor.spec_aug))
    batches = _fbank_batches(tmp_path)
    torch.manual_seed(0)
    init = speaker_state_dict(_port_ecapa()[0])
    one, s1, step1 = _port_ecapa(init, dither=1.0, spec_aug=True, seed=5)
    for b in batches:
        m1 = step1(s1, {k: T(v) for k, v in b.items()})
    assert len(calls) == 2 and all(c is calls[0] for c in calls)
    two, s2, step2 = _port_ecapa(init, dither=1.0, spec_aug=True, num_steps=2, seed=5)
    m2 = step2(s2, {k: T(np.stack([b[k] for b in batches])) for k in batches[0]})
    assert m2["loss"].shape == (2,) and len(m2["lr"]) == 2 and s2.step == s1.step == 2
    assert float(m2["loss"][-1]) == float(m1["loss"]) and m2["lr"][-1] == m1["lr"]
    a, b = speaker_state_dict(one), speaker_state_dict(two)
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="made for 2"):
        step2(s2, {k: T(v) for k, v in batches[0].items()})


# ------------------------------------------------------------ the recipe
def _write_recipe_data(root: Path):
    """MUSAN / RIR stand-ins, a 24-utterance training set over 4 speakers
    (2.5-7 s, so both QMF duration pools fill) whose utt2spk also names 2
    speakers without audio, and 8 eval utterances with a labeled trial
    list over all their pairs."""
    rng = np.random.default_rng(0)

    def wav(path, x):
        path.parent.mkdir(parents=True, exist_ok=True)
        write_wav(str(path), x.astype(np.float32))
        return str(path)

    for sub, key, n, length in (("musan", "noise", 3, 8000), ("rirs", "rir", 2, 800)):
        lines = []
        for i in range(n):
            x = rng.standard_normal(length) * (0.1 if sub == "musan"
                                               else np.exp(-np.arange(length) / 100))
            lines.append(f"{key}-{i} {wav(root / sub / f'{key}-{i}.wav', x)}")
        (root / sub / "wav.scp").write_text("\n".join(lines) + "\n")

    def voice(spk, seconds):
        t = np.arange(int(seconds * 16000)) / 16000
        return 0.1 * np.sin(2 * np.pi * (200 + 100 * spk) * t) + 0.05 * rng.standard_normal(len(t))

    for dset, n, secs in (("vox2_dev", 24, (2.5, 3.0, 6.5, 7.0)), ("vox1", 8, (2.0,))):
        scp, u2s = [], []
        for i in range(n):
            spk, key = i % 4, f"{dset[:4]}-{i:03d}"
            scp.append(f"{key} {wav(root / dset / f'{key}.wav', voice(spk, secs[i // 6 % len(secs)]))}")
            u2s.append(f"{key} spk{spk}")
        if dset == "vox2_dev":
            u2s += ["absent-4 spk4", "absent-5 spk5"]
        (root / dset / "wav.scp").write_text("\n".join(scp) + "\n")
        (root / dset / "utt2spk").write_text("\n".join(u2s) + "\n")
    trials = [f"vox1-{a:03d} vox1-{b:03d} {'target' if a % 4 == b % 4 else 'nontarget'}"
              for a in range(8) for b in range(a + 1, 8)]
    (root / "vox1" / "trials.kaldi").write_text("\n".join(trials) + "\n")


def test_recipe_stages_1_to_7_on_cpu(tmp_path, capsys):
    data = tmp_path / "data"
    _write_recipe_data(data)
    conf = ROOT / "examples/voxceleb/v2/conf/ecapa_tdnn.yaml"
    argv = ["--stage", "1", "--stop_stage", "7", "--config", str(conf), "--data_root", str(data),
            "--trials", str(data / "vox1" / "trials.kaldi"), "--device", "cpu",
            "--calibration_trial_num", "20",
            f"exp_dir={tmp_path / 'exp'}", f"train_data={data / 'vox2_dev' / 'shard.list'}",
            f"train_label={data / 'vox2_dev' / 'utt2spk'}",
            f"dataset_args.reverb_data={data / 'rirs_aug_store'}",
            f"dataset_args.noise_data={data / 'musan_aug_store'}",
            "num_epochs=2", "epoch_iter=3", "save_epoch_interval=1", "num_avg=2",
            "loop_steps=2", "dataloader_args.batch_size=8", "dataset_args.num_frms=50",
            "model_args.feat_dim=24", "model_args.embed_dim=16",
            "dataset_args.fbank_args.num_mel_bins=24"]
    done = voxceleb_v2.main(argv)
    out = capsys.readouterr().out
    assert sorted(done) == [1, 2, 3, 4, 5, 6, 7]
    for stage in range(1, 8):
        assert f"stage {stage}:" in out
    for name in ("trials.kaldi.score", "trials.kaldi.score.asnorm",
                 "trials.kaldi.score.asnorm.qmf"):
        assert any(ln.startswith(f"{name}: EER ") and "minDCF" in ln for ln in out.splitlines())
    assert [len(done[s]["lines"]) for s in (5, 6, 7)] == [1, 1, 1]
    exp = tmp_path / "exp"
    assert sorted(os.listdir(exp / "models"))[:2] == ["model_1.pt", "model_1.pt.json"]
    assert (exp / "avg_model.pt").exists() and (exp / "calibration.trials").exists()
    shards = (data / "vox2_dev" / "shard.list").read_text().split()
    assert shards and all(s.endswith(".tar") for s in shards)
    # stage 9 without its lm config fails before any stage runs
    with pytest.raises(SystemExit):
        voxceleb_v2.main(["--stage", "3", "--stop_stage", "9", "--config", str(conf)])
    assert "stage 3" not in capsys.readouterr().out
