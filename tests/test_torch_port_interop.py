"""Checkpoint interop and export on the port, on the CPU.

- `utils/flax_msgpack.py` against `flax.serialization.msgpack_restore`:
  float32, bf16, int, scalar and Python leaves and empty dicts, and a leaf in
  flax's chunked form (its own chunking at a small chunk size); equal, bit
  for bit;
- a `.ckpt` written by the JAX package's `save_checkpoint` through
  `load_partial`: nothing missing or unexpected, embeddings within atol
  1e-5 of the JAX model's (float32);
- `bin/import_torch` then `bin/export_torch` on a WeSpeaker-style `.pt`
  (nested under `model`, `module.` prefixes, a head): the backbone comes
  back bit-identical, for ECAPA and ResNet; a wrong shape is refused;
- `bin/export_model` from a JAX experiment directory (`config.yaml` +
  `avg_model.ckpt`, and the bf16 one JAX's export writes): the port's model
  directory embeds as the JAX model does (atol 1e-5; the bf16 tensors equal
  JAX's bits); `export_program`'s `torch.export` program against the eager
  model at two (B, T) shapes, atol 1e-5;
- `recipes.voxceleb_v2` stages 1-9 on a tiny ResNet config (1 epoch of 2
  steps each), and its up-front refusals of stage 9.
"""

import json
import os
from pathlib import Path

import flax.serialization as flax_ser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_ecapa import random_variables
from tests.test_torch_port_recipe import _write_recipe_data
from tests.test_torch_port_resnet import jax_narrow, port_narrow
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from wespeaker_hubert_tpu.bin.export_model import export_model as jax_export_model
from wespeaker_hubert_tpu.models.projections import ArcMarginProduct as JaxArcMargin
from wespeaker_hubert_tpu.models.resnet import ResNet18 as JaxResNet18
from wespeaker_hubert_tpu.models.speaker_net import SpeakerNet as JaxSpeakerNet
from wespeaker_hubert_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from wespeaker_hubert_tpu.utils.config import dump_config as jax_dump_config
from wespeaker_hubert_tpu_torch.bin.export_model import export_model, export_program, load_program
from wespeaker_hubert_tpu_torch.bin.export_torch import export_torch
from wespeaker_hubert_tpu_torch.bin.import_torch import import_torch
from wespeaker_hubert_tpu_torch.models.projections import ArcMarginProduct
from wespeaker_hubert_tpu_torch.models.registry import get_speaker_model
from wespeaker_hubert_tpu_torch.models.speaker_net import (SpeakerNet, build_speaker_net,
                                                           load_speaker_state,
                                                           speaker_state_dict)
from wespeaker_hubert_tpu_torch.recipes import voxceleb_v2
from wespeaker_hubert_tpu_torch.utils import flax_msgpack
from wespeaker_hubert_tpu_torch.utils.checkpoint import load_partial, load_state

ROOT = Path(__file__).resolve().parents[1]
T = torch.from_numpy


def _assert_same_tree(got, want, path="/"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}{k}/")
    elif isinstance(got, torch.Tensor):  # bf16: the same bits
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16, path
        assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16)), path
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want), path
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("chunked", [False, True], ids=["tree", "chunked"])
def test_msgpack_reader_matches_flax(chunked, monkeypatch):
    rng = np.random.default_rng(0)
    bf16 = np.asarray(jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16))
    if chunked:  # flax's own chunking, at 64 bytes a chunk
        monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)
        tree = {"w": rng.standard_normal((10, 7)).astype(np.float32), "bf": bf16,
                "small": np.arange(3, dtype=np.int64)}
        data = flax_ser.msgpack_serialize(tree)
        assert b"__msgpack_chunked_array__" in data
    else:
        tree = {"params": {"kernel": rng.standard_normal((2, 3, 4)).astype(np.float32),
                           "bf16": bf16, "ids": np.arange(6, dtype=np.int32).reshape(2, 3),
                           "empty": {}},
                "step": np.int64(12), "lr": np.float32(0.5), "epoch": 3, "neg": -40,
                "big": 1 << 40, "rate": 0.25, "name": "x" * 40, "none": None, "flag": True,
                "z": 1 - 2j, "seq": [1, 2.5, "a"]}
        data = flax_ser.to_bytes(tree)
    _assert_same_tree(flax_msgpack.loads(data), flax_ser.msgpack_restore(data))
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.loads(data[:-3])


def _jax_speaker_net(seed=9):
    """A narrow JAX ResNet (BasicBlock, 8 channels, 16 mels) + ArcMargin
    with seeded variables."""
    net = JaxSpeakerNet(backbone=jax_narrow("basic", s2d_stem=False),
                        projection=JaxArcMargin(8, 6, 32.0))
    shapes = jax.eval_shape(lambda: net.init(
        jax.random.key(0), jnp.zeros((1, 40, 16)), jnp.zeros((1,), jnp.int32), 0.0,
        train=False))
    return net, random_variables(shapes, seed)


def test_jax_checkpoint_through_load_partial(tmp_path):
    net, variables = _jax_speaker_net()
    path = str(tmp_path / "models" / "model_3.ckpt")
    jax_save_checkpoint(path, variables, meta={"epoch": 3})
    port = SpeakerNet(port_narrow("basic"), None, ArcMarginProduct(8, 6, 32.0))
    missing, unexpected = load_partial(path, port, "ResNet18")
    assert missing == [] and unexpected == []
    x = np.random.default_rng(1).standard_normal((2, 40, 16)).astype(np.float32)
    want = jax.jit(lambda v, f: net.apply(v, f, method=net.embed))(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = port.eval().embed(T(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="needs the model name"):
        load_state(path)


@pytest.mark.parametrize("model", ["ECAPA_TDNN_c512", "ResNet34"])
def test_import_then_export_is_bit_identical(tmp_path, model):
    args = {"feat_dim": 16, "embed_dim": 8}
    torch.manual_seed(0)
    module = get_speaker_model(model)(**args)
    sd = {k: (torch.randn(v.shape) if v.is_floating_point() else torch.full_like(v, 7))
          for k, v in module.state_dict().items()}
    wrapped = {"model": {"module." + k: v for k, v in sd.items()}}
    wrapped["model"]["module.projection.weight"] = torch.randn(6, 8)
    torch.save(wrapped, tmp_path / "wespeaker.pt")
    imported = import_torch(model, str(tmp_path / "wespeaker.pt"),
                            str(tmp_path / "exp" / "avg_model.pt"), **args)
    (tmp_path / "exp" / "config.json").write_text(json.dumps({"model": model,
                                                               "model_args": args}))
    out = export_torch(str(tmp_path / "exp"), str(tmp_path / "exported.pt"))
    back = torch.load(out, weights_only=True)
    assert list(back) == list(sd)
    kept = torch.load(imported, weights_only=True)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
        assert torch.equal(kept[k], v), k
    with pytest.raises(RuntimeError, match="size mismatch"):
        import_torch(model, str(tmp_path / "wespeaker.pt"), str(tmp_path / "bad.pt"),
                     feat_dim=24, embed_dim=8)


@pytest.mark.parametrize("model", ["ResNet18", "REPVGG_TINY_A0"])
def test_import_refuses_2d_backbone_with_multi_head_pooling(tmp_path, model):
    """The port's frame map flattens frequency-major for MHASTP / MQMHASTP
    where WeSpeaker's flattens channel-major: with names and shapes equal,
    import_torch and the hub's bundle conversion refuse such a checkpoint,
    and the hub leaves the bundle as it was."""
    from wespeaker_hubert_tpu_torch.cli.hub import ensure_native_checkpoint

    args = {"feat_dim": 16, "embed_dim": 8, "pooling_func": "MHASTP"}
    module = get_speaker_model(model)(**args)
    bundle = tmp_path / "bundle"
    bundle.mkdir()
    torch.save({"model": module.state_dict()}, bundle / "avg_model.pt")
    with pytest.raises(ValueError, match="frequency-major .* channel-major"):
        import_torch(model, str(bundle / "avg_model.pt"), str(tmp_path / "out.pt"), **args)
    assert not (tmp_path / "out.pt").exists()
    (bundle / "config.yaml").write_text(
        f"model: {model}\nmodel_args:\n" + "".join(f"  {k}: {v}\n" for k, v in args.items()))
    with pytest.raises(ValueError, match="MHASTP"):
        ensure_native_checkpoint(str(bundle))
    assert sorted(os.listdir(bundle)) == ["avg_model.pt", "config.yaml"]


def test_export_model_from_jax_exp_dir(tmp_path):
    config = {"model": "ResNet18", "model_args": {"feat_dim": 16, "embed_dim": 8},
              "projection_args": {"project_type": "arc_margin"}}
    net = JaxSpeakerNet(backbone=JaxResNet18(16, 8, s2d_stem=False),
                        projection=JaxArcMargin(8, 6, 32.0))
    shapes = jax.eval_shape(lambda: net.init(
        jax.random.key(0), jnp.zeros((1, 40, 16)), jnp.zeros((1,), jnp.int32), 0.0,
        train=False))
    variables = random_variables(shapes, 10)
    jax_dir = tmp_path / "jax_exp"
    jax_dir.mkdir()
    jax_dump_config(config, str(jax_dir / "config.yaml"))
    jax_save_checkpoint(str(jax_dir / "avg_model.ckpt"), variables)
    np.save(tmp_path / "mean.npy", np.arange(8, dtype=np.float32))
    out = export_model(str(jax_dir), str(tmp_path / "port"), mean_vec=str(tmp_path / "mean.npy"))
    assert sorted(os.listdir(out)) == ["avg_model.pt", "config.json", "mean_vec.npy"]
    port_config = json.loads(Path(out, "config.json").read_text())
    port = build_speaker_net(port_config)
    missing, unexpected = load_speaker_state(port, torch.load(Path(out, "avg_model.pt"),
                                                              weights_only=True))
    assert missing == [] and unexpected == ["projection.weight"]
    port.eval()
    x = np.random.default_rng(2).standard_normal((2, 48, 16)).astype(np.float32)
    want = jax.jit(lambda v, f: net.apply(v, f, method=net.embed))(variables, jnp.asarray(x))
    with torch.inference_mode():
        np.testing.assert_allclose(port.embed(T(x)).numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    # the feats -> embedding program at two (B, T) shapes
    program = load_program(export_program(port_config, str(Path(out, "avg_model.pt")),
                                          str(tmp_path / "model.pt2")))
    for b, t in ((3, 37), (1, 160)):
        feats = torch.from_numpy(np.random.default_rng(t).standard_normal((b, t, 16))
                                 .astype(np.float32))
        with torch.inference_mode():
            np.testing.assert_allclose(program(feats).numpy(), port.embed(feats).numpy(),
                                       rtol=0, atol=1e-5)
    # JAX's bf16 export: bf16 leaves in the .ckpt, read bit for bit
    jax_bf16 = jax_export_model(str(jax_dir), str(tmp_path / "jax_bf16"), dtype="bf16")
    state = load_state(str(Path(jax_bf16, "avg_model.ckpt")), "ResNet18", 16)
    kernel = np.asarray(variables["params"]["backbone"]["conv1"]["kernel"])
    want16 = torch.from_numpy(kernel.transpose(3, 2, 1, 0).copy()).to(torch.bfloat16).float()
    assert torch.equal(state["conv1.weight"], want16)
    out16 = export_model(str(jax_dir), str(tmp_path / "port_bf16"), dtype="bf16")
    sd16 = torch.load(Path(out16, "avg_model.pt"), weights_only=True)
    assert sd16["conv1.weight"].dtype == torch.bfloat16
    assert torch.equal(sd16["conv1.weight"].float(), want16)
    assert json.loads(Path(out16, "config.json").read_text())["compute_dtype"] == "bf16"


def test_export_rebinds_weights_as_a_fresh_trace(tmp_path, monkeypatch):
    """A second export of the same model takes the first trace's graph with
    the second checkpoint's weights and statistics: its program holds what
    a fresh trace holds and gives the same embeddings, bit for bit."""
    from wespeaker_hubert_tpu_torch.bin import export_model as em

    config = {"model": "XVEC", "model_args": {"feat_dim": 16, "embed_dim": 8},
              "projection_args": {"project_type": "arc_margin"}}
    ckpts = []
    for seed in (0, 1):
        torch.manual_seed(seed)
        net = build_speaker_net(config)
        for m in net.modules():  # statistics of their own, not the init's
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
        ckpts.append(str(tmp_path / f"ck{seed}.pt"))
        torch.save(speaker_state_dict(net), ckpts[-1])
    traces, export = [], torch.export.export
    monkeypatch.setattr(torch.export, "export", lambda *a, **k: traces.append(1) or export(*a, **k))
    em._TRACED.clear()
    em.export_program(config, ckpts[0], str(tmp_path / "p0.pt2"))
    rebound = load_program(em.export_program(config, ckpts[1], str(tmp_path / "p1.pt2")))
    assert len(traces) == 1
    em._TRACED.clear()
    fresh = load_program(em.export_program(config, ckpts[1], str(tmp_path / "fresh.pt2")))
    assert len(traces) == 2
    a, b = torch.export.load(str(tmp_path / "p1.pt2")), torch.export.load(str(tmp_path /
                                                                           "fresh.pt2"))
    assert set(a.state_dict) == set(b.state_dict) and set(a.constants) == set(b.constants)
    for k in b.state_dict:
        assert torch.equal(a.state_dict[k], b.state_dict[k]), k
    for k in b.constants:
        assert torch.equal(a.constants[k], b.constants[k]), k
    for bsz, t in ((3, 37), (1, 160)):
        feats = torch.from_numpy(np.random.default_rng(t).standard_normal((bsz, t, 16))
                                 .astype(np.float32))
        with torch.inference_mode():
            assert torch.equal(rebound(feats), fresh(feats))


def test_recipe_stages_1_to_9_resnet_on_cpu(tmp_path, capsys, caplog):
    data = tmp_path / "data"
    _write_recipe_data(data, n_train=16)  # two batches of 8: the runs' 2 steps
    paths = [f"train_data={data / 'vox2_dev' / 'shard.list'}",
             f"train_label={data / 'vox2_dev' / 'utt2spk'}",
             f"dataset_args.reverb_data={data / 'rirs_aug_store'}",
             f"dataset_args.noise_data={data / 'musan_aug_store'}"]
    tiny = ["num_epochs=1", "epoch_iter=2", "num_avg=1", "log_batch_interval=1", "model=ResNet18",
            "dataloader_args.batch_size=8", "model_args.feat_dim=16",
            "dataset_args.fbank_args.num_mel_bins=16", "model_args.embed_dim=8"]
    conf = ROOT / "examples/voxceleb/v2/conf"
    common = ["--config", str(conf / "resnet34.yaml"), "--data_root", str(data),
              "--trials", str(data / "vox1" / "trials.kaldi"), "--device", "cpu",
              "--calibration_trial_num", "20"]
    argv = (["--stage", "1", "--stop_stage", "9", "--lm_config", str(conf / "resnet_lm.yaml")]
            + common + [f"exp_dir={tmp_path / 'exp'}", "dataset_args.num_frms=50"] + paths + tiny
            + [f"lm.exp_dir={tmp_path / 'exp_lm'}", "lm.dataset_args.num_frms=60"]
            + ["lm." + o for o in paths + tiny])
    caplog.set_level("INFO", logger="train")
    done = voxceleb_v2.main(argv)
    out = capsys.readouterr().out
    assert sorted(done) == list(range(1, 10)) and sorted(done[9]["stages"]) == list(range(3, 9))
    assert out.count("stage 8: export model bundle") == 2
    assert out.count("trials.kaldi.score.asnorm.qmf: EER ") == 2
    # the lm run starts from the base run's averaged model, head included
    init = [r.getMessage() for r in caplog.records if r.getMessage().startswith("model_init")]
    assert init == [f"model_init from {tmp_path / 'exp' / 'avg_model.pt'} (epoch 0, 0 missing, "
                    "0 unexpected)"]
    margins = [json.loads(ln)["margin"]
               for ln in (tmp_path / "exp_lm" / "metrics.jsonl").read_text().splitlines()]
    assert margins and all(m == 0.5 for m in margins)
    for exp in ("exp", "exp_lm"):
        exported = tmp_path / exp / "exported"
        assert sorted(os.listdir(exported)) == ["avg_model.pt", "config.json", "mean_vec.npy",
                                                "model.pt2"]
        program = load_program(str(exported / "model.pt2"))
        assert program(torch.zeros(2, 40, 16)).shape == (2, 8)
    # stage 9's checks run before any stage
    with pytest.raises(SystemExit):
        voxceleb_v2.main(["--stage", "9", "--stop_stage", "9"] + common)
    with pytest.raises(ValueError, match="exp_dir must differ"):
        voxceleb_v2.main(["--stage", "8", "--stop_stage", "9", "--lm_config",
                          str(conf / "resnet_lm.yaml")] + common
                         + [f"exp_dir={tmp_path / 'same'}", f"lm.exp_dir={tmp_path / 'same'}"])
    assert "stage 8" not in capsys.readouterr().out
