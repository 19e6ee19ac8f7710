"""The Whisper-PMFA recipe on the port, on the CPU at `tiny_test` width.

- `recipes.voxceleb_v1_whisper_pmfa` stages 2-7 (`--device cpu`) on the
  repo's stage-0 and stage-1 configs, overriding the paths, the variant,
  the attention (`attn_impl: flash`, the plain K2 versions on the CPU) and
  the run's length; its stage-5 embeddings against the JAX package's
  `bin/extract` on the same averaged weights (carried into JAX by its own
  converters): float32 cosine >= 0.99999.  Utterances run past
  `tiny_test`'s n_ctx of 100 tokens (2 s), so the cut is on the path.
- `whisper_encoder_args.checkpoint`: an OpenAI-named state dict as `.npz`
  and as a pickled `.npy` dict goes into the encoder (blocks past n_layer
  skipped, `ln_post2` fresh), as JAX's `convert_whisper_state_dict` reads
  it, and a frozen step leaves every imported tensor bitwise as it was;
  `whisper_pmfa_stage1_pp.yaml` (pipeline_parallel: 4) is refused by the
  recipe, bin/train and build_speaker_net; the entry points default to CUDA.

Two tests on purpose (see tests/test_torch_port_whisper.py).
"""

import json
from pathlib import Path

import flax.linen as fnn
import numpy as np
import pytest
import torch

from tests.test_torch_port_extract import _shape_only_init
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from tests.test_torch_port_train import _store_arrays
from tests.test_torch_port_whisper import cosines, openai_state_dict, speechlike
from wespeaker_hubert_tpu.bin.extract import extract as jax_extract
from wespeaker_hubert_tpu.frontend.whisper import WhisperEncoderConfig as JaxWhisperConfig
from wespeaker_hubert_tpu.frontend.whisper import convert_whisper_state_dict
from wespeaker_hubert_tpu.models.convert_torch import whisper_pmfa_from_torch
from wespeaker_hubert_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from wespeaker_hubert_tpu_torch.bin.train import train
from wespeaker_hubert_tpu_torch.data.wav_io import write_wav
from wespeaker_hubert_tpu_torch.frontend import whisper_encoder_state
from wespeaker_hubert_tpu_torch.models.convert_jax import whisper_frontend_from_jax
from wespeaker_hubert_tpu_torch.models.speaker_net import build_speaker_net
from wespeaker_hubert_tpu_torch.recipes import voxceleb_v1_whisper_pmfa as recipe
from wespeaker_hubert_tpu_torch.utils.config import apply_overrides, load_config
from wespeaker_hubert_tpu_torch.utils.embeddings import embeddings_dict

ROOT = Path(__file__).resolve().parents[1]
CONF = ROOT / "examples/voxceleb/v1/Whisper-PMFA/conf"
SR = 16000


def write_data(data, seed=0):
    """vox1_dev: 4 speakers x 4 utterances of 1.2-3.5 s (training, and the
    AS-Norm cohort); vox1: 3 x 3 of 1.5-4 s and a labeled trial list; a
    RIR store and a noise store."""
    rng = np.random.default_rng(seed)
    for dset, n_spk, per, lo, hi in (("vox1_dev", 4, 4, 1.2, 3.5), ("vox1", 3, 3, 1.5, 4.0)):
        scp, u2s = [], []
        for s in range(n_spk):
            for j in range(per):
                key = f"{dset}-s{s}-{j}"
                x = speechlike(rng, int(SR * rng.uniform(lo, hi)), floor=10 ** rng.uniform(-3, -1))
                path = data / dset / f"{key}.wav"
                path.parent.mkdir(parents=True, exist_ok=True)
                write_wav(str(path), np.clip(x, -1, 1))
                scp.append(f"{key} {path}")
                u2s.append(f"{key} {dset}-s{s}")
        (data / dset / "wav.scp").write_text("\n".join(scp) + "\n")
        (data / dset / "utt2spk").write_text("\n".join(u2s) + "\n")
    keys = [ln.split()[0] for ln in (data / "vox1" / "wav.scp").read_text().splitlines()]
    (data / "vox1" / "trials").write_text("\n".join(
        f"{a} {b} {'target' if a.split('-')[1] == b.split('-')[1] else 'nontarget'}"
        for i, a in enumerate(keys) for b in keys[i + 1:]) + "\n")
    for name, arrays in zip(("rirs_aug_store", "musan_aug_store"), _store_arrays(1)):
        d = data / name
        d.mkdir()
        for key, x in arrays.items():
            np.save(d / f"{key}.npy", x)
        (d / "index.json").write_text(json.dumps({k: k + ".npy" for k in arrays}))


def overrides(tmp_path, data):
    return [f"stage0.exp_dir={tmp_path / 'exp0'}", f"stage1.exp_dir={tmp_path / 'exp1'}",
            f"train_data={data / 'vox1_dev' / 'raw.list'}",
            f"train_label={data / 'vox1_dev' / 'utt2spk'}",
            f"dataset_args.reverb_data={data / 'rirs_aug_store'}",
            f"dataset_args.noise_data={data / 'musan_aug_store'}",
            "dataset_args.whisper_encoder_args.variant=tiny_test",
            "dataset_args.whisper_encoder_args.attn_impl=flash",
            "stage0.dataset_args.whisper_encoder_args.checkpoint=null",
            "dataloader_args.batch_size=4", "dataset_args.num_frms=100", "num_epochs=1",
            "epoch_iter=2", "model_args.embed_dim=16"]


def test_recipe_stages_2_to_7_on_cpu_match_jax_extract(tmp_path, capsys):
    data = tmp_path / "data"
    write_data(data)
    argv = ["--stage", "2", "--stop_stage", "7", "--stage0_config",
            str(CONF / "whisper_pmfa_stage0.yaml"), "--stage1_config",
            str(CONF / "whisper_pmfa_stage1.yaml"), "--data_root", str(data),
            "--trials", str(data / "vox1" / "trials"), "--device", "cpu",
            *overrides(tmp_path, data)]
    done = recipe.main(argv)
    out = capsys.readouterr().out
    assert sorted(done) == [2, 3, 4, 5, 6, 7]
    for stage in range(2, 8):
        assert f"stage {stage}:" in out
    assert [len(done[s]["lines"]) for s in (6, 7)] == [1, 1]
    assert done[6]["lines"][0].startswith("trials.score: EER ")
    assert done[7]["lines"][0].startswith("trials.score.asnorm: EER ")
    exp1 = tmp_path / "exp1"
    assert (tmp_path / "exp0" / "models" / "model_1.pt").exists()
    assert (exp1 / "avg_model.pt").exists() and (exp1 / "embeddings" / "vox1_dev_spk_mean.npz")

    # stage 5's embeddings against JAX's bin/extract on the same weights
    sd = torch.load(exp1 / "avg_model.pt", weights_only=True)
    jcfg = JaxWhisperConfig.tiny_test()
    front = {k[len("frontend."):]: v.numpy() for k, v in sd.items() if k.startswith("frontend.")}
    head = {k: v.numpy() for k, v in sd.items() if not k.startswith(("frontend.", "projection."))}
    params, stats = whisper_pmfa_from_torch(head)
    jax_save_checkpoint(str(tmp_path / "avg_model.ckpt"), {
        "params": {"frontend": convert_whisper_state_dict(front, jcfg), "backbone": params},
        "batch_stats": {"backbone": stats}})
    args = recipe.parse_args(argv)
    _, cfg1 = recipe.load_configs(args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Module, "init", _shape_only_init(fnn.Module.init))
        jkeys, jemb = jax_extract(cfg1, str(data / "vox1" / "raw.list"),
                                  str(tmp_path / "avg_model.ckpt"), "")
    got = embeddings_dict(str(exp1 / "embeddings" / "vox1.npz"))
    assert sorted(got) == sorted(jkeys) and len(jkeys) == 9
    assert cosines(np.stack([got[k] for k in jkeys]), np.asarray(jemb)).min() >= 0.99999


def test_checkpoint_import_and_pipeline_refusal(tmp_path):
    data = tmp_path / "data"
    write_data(data, seed=1)
    recipe.main(["--stage", "2", "--stop_stage", "2", "--data_root", str(data),
                 "--stage0_config", str(CONF / "whisper_pmfa_stage0.yaml"),
                 "--stage1_config", str(CONF / "whisper_pmfa_stage1.yaml")])
    cfg = JaxWhisperConfig.tiny_test()
    sd = openai_state_dict(cfg, 51, extra_blocks=2)
    del sd["ln_post2.weight"], sd["ln_post2.bias"]
    want = whisper_frontend_from_jax(convert_whisper_state_dict(sd, cfg))
    port_want = whisper_encoder_state(sd, cfg)
    assert sorted(want) == sorted(port_want)
    np.save(tmp_path / "enc.npy", sd, allow_pickle=True)
    np.savez(tmp_path / "enc.npz", **sd)
    base = apply_overrides(load_config(str(CONF / "whisper_pmfa_stage0.yaml")), [
        o[len("stage0."):] if o.startswith("stage0.") else o
        for o in overrides(tmp_path, data) if not o.startswith("stage1.")])
    for fmt in ("npz", "npy"):
        config = apply_overrides(base, [f"exp_dir={tmp_path / fmt}", "epoch_iter=1",
                                        f"dataset_args.whisper_encoder_args.checkpoint="
                                        f"{tmp_path / ('enc.' + fmt)}"])
        state = train(config, device="cpu")
        assert state.step == 1
        saved = torch.load(tmp_path / fmt / "models" / "model_1.pt", weights_only=True)
        for k, v in want.items():  # imported, then frozen through the step
            assert torch.equal(saved["frontend." + k], torch.from_numpy(np.asarray(v))), k
            assert torch.equal(port_want[k], saved["frontend." + k]), k
        assert not any(p.requires_grad for p in state.model.frontend.parameters())

    pp = load_config(str(CONF / "whisper_pmfa_stage1_pp.yaml"))
    for call in (
        lambda: recipe.main(["--stage", "3", "--stop_stage", "3", "--stage0_config",
                             str(CONF / "whisper_pmfa_stage0.yaml"), "--stage1_config",
                             str(CONF / "whisper_pmfa_stage1_pp.yaml")]),
        lambda: train(pp, device="cpu"),
        lambda: build_speaker_net(pp),
    ):
        with pytest.raises(NotImplementedError, match=r"pipeline_parallel=4 .*item 11"):
            call()
    assert not (tmp_path / "exp0").exists()
    if not torch.cuda.is_available():  # the entry points default to CUDA
        with pytest.raises(RuntimeError, match="CUDA requested"):
            train(base)
