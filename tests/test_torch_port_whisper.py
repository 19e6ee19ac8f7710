"""Port parity of the Whisper-PMFA slice against the JAX package.

One Whisper encoder of width 128 (2 heads of 64, 3 blocks, layers 1-2
concatenated, n_ctx 64 so that the longest rows are cut) with the PMFA head,
its weights a seeded state dict in OpenAI's and the reference's names
carried into JAX by the JAX package's own converters
(`convert_whisper_state_dict`, `whisper_pmfa_from_torch`) and back into the
port by `from_jax_variables`.  Inputs: speech-like wavs with silent tails.

Tolerances: log-mel atol 1e-4; the encoder's features atol 2e-4 / rtol
1e-3 (the SSL gate), with `attn_impl` 'flash' (the plain K2 versions on the
CPU) and 'einsum'; embeddings cosine >= 0.99999 in float32 (atol 1e-4) and
>= 0.9999 in bf16 against JAX's bf16; the converters' round trip exact; a
frozen (stage 3) and a joint (stage 4) train step of bin/train's
`make_train_step` against JAX's: loss within 1e-5 relative, updates by
STEP_TOL's first row, frozen tensors unchanged on both sides.

Two tests on purpose: xdist's loadfile order runs files with the most tests
first, so this file starts after the long `test_quality_gates_ssl.py`
instead of ahead of it.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from tests.torch_port_refs import FastJit, run_jax
from tests.test_torch_port_train import _store_arrays
from tests.test_torch_port_train_step import STEP_TOL
from wespeaker_hubert_tpu.data import AugStore as JaxAugStore
from wespeaker_hubert_tpu.data import TrainPipeline as JaxTrainPipeline
from wespeaker_hubert_tpu.data import TrainPipelineConfig as JaxPipelineConfig
from wespeaker_hubert_tpu.data import write_wav
from wespeaker_hubert_tpu.frontend.whisper import WhisperEncoder as JaxWhisperEncoder
from wespeaker_hubert_tpu.frontend.whisper import WhisperEncoderConfig as JaxWhisperConfig
from wespeaker_hubert_tpu.frontend.whisper import convert_whisper_state_dict
from wespeaker_hubert_tpu.models.convert_torch import whisper_pmfa_from_torch
from wespeaker_hubert_tpu.models.projections import ArcMarginProduct as JaxArcMargin
from wespeaker_hubert_tpu.models.speaker_net import SpeakerNet as JaxSpeakerNet
from wespeaker_hubert_tpu.models.whisper_pmfa import WhisperPMFA as JaxWhisperPMFA
from wespeaker_hubert_tpu.ops.pipeline import FeaturePipelineConfig as JaxFeatureConfig
from wespeaker_hubert_tpu.ops.whisper_mel import whisper_log_mel as jax_whisper_log_mel
from wespeaker_hubert_tpu.train import cast_variables_bf16 as jax_cast_bf16
from wespeaker_hubert_tpu.train import make_eval_embed as jax_make_eval_embed
from wespeaker_hubert_tpu.train import schedulers as jax_sched
from wespeaker_hubert_tpu.train.executor import make_train_step as jax_make_train_step
from wespeaker_hubert_tpu.train.state import TrainState as JaxTrainState
from wespeaker_hubert_tpu.train.state import make_optimizer as jax_make_optimizer
from wespeaker_hubert_tpu_torch.data.dataset import chunk_samples_for_frames
from wespeaker_hubert_tpu_torch.frontend import (
    WhisperEncoder,
    WhisperEncoderConfig,
    load_whisper_state_dict,
    whisper_encoder_state,
)
from wespeaker_hubert_tpu_torch.models.convert_jax import from_jax_variables
from wespeaker_hubert_tpu_torch.models.projections import ArcMarginProduct
from wespeaker_hubert_tpu_torch.models.speaker_net import (
    SpeakerNet,
    load_speaker_state,
    speaker_state_dict,
)
from wespeaker_hubert_tpu_torch.models.whisper_pmfa import WhisperPMFA
from wespeaker_hubert_tpu_torch.ops.pipeline import FeaturePipelineConfig
from wespeaker_hubert_tpu_torch.ops.whisper_mel import whisper_log_mel
from wespeaker_hubert_tpu_torch.train import schedulers
from wespeaker_hubert_tpu_torch.train.executor import (
    cast_variables_bf16,
    make_eval_embed,
    make_train_step,
)
from wespeaker_hubert_tpu_torch.train.state import TrainState, freeze_paths, make_optimizer

T = torch.from_numpy
SR = 16000
JAX_CFG = JaxWhisperConfig(n_state=128, n_head=2, n_layer=3, n_ctx=64, layer_st=1, layer_ed=2)
EMBED = 16
HS_TOL = dict(atol=2e-4, rtol=1e-3)
MODEL = "whisper_PMFA_large_v2"


def port_config(**kw):
    fields = {f.name: getattr(JAX_CFG, f.name) for f in dataclasses.fields(WhisperEncoderConfig)}
    return WhisperEncoderConfig(**{**fields, **kw})


def openai_state_dict(cfg, seed, extra_blocks=1):
    """A seeded encoder state dict in OpenAI's `encoder.*` names (no bias on
    attn.key), with what the loaders must skip: a block past n_layer,
    `positional_embedding` and `ln_post`; and the fork's `ln_post2`."""
    rng = np.random.default_rng(seed)
    d, m = cfg.n_state, cfg.n_mels

    def w(*shape):
        return rng.normal(0.0, float(np.prod(shape[1:])) ** -0.5, shape).astype(np.float32)

    def b(n):
        return rng.normal(0.0, 0.1, n).astype(np.float32)

    def ln(prefix, n):
        return {prefix + ".weight": rng.uniform(0.5, 1.5, n).astype(np.float32),
                prefix + ".bias": b(n)}

    sd = {"conv1.weight": w(d, m, 3), "conv1.bias": b(d), "conv2.weight": w(d, d, 3),
          "conv2.bias": b(d), "positional_embedding": w(cfg.n_ctx, d), **ln("ln_post", d),
          **ln("ln_post2", cfg.output_size)}
    for i in range(cfg.n_layer + extra_blocks):
        p = f"blocks.{i}"
        for name in ("query", "key", "value", "out"):
            sd[f"{p}.attn.{name}.weight"] = w(d, d)
            if name != "key":
                sd[f"{p}.attn.{name}.bias"] = b(d)
        sd.update({**ln(p + ".attn_ln", d), **ln(p + ".mlp_ln", d),
                   f"{p}.mlp.0.weight": w(4 * d, d), f"{p}.mlp.0.bias": b(4 * d),
                   f"{p}.mlp.2.weight": w(d, 4 * d), f"{p}.mlp.2.bias": b(d)})
    return sd


def head_state_dict(in_dim, seed):
    """The reference Whisper-PMFA head's state dict (1x1 conv attention,
    `bn.norm`, `fc`)."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.normal(0.0, float(np.prod(s[1:])) ** -0.5, s).astype(np.float32)  # noqa
    n = 2 * in_dim
    return {
        "pooling.linear1.weight": r(128, 3 * in_dim, 1), "pooling.linear1.bias": r(128),
        "pooling.linear2.weight": r(in_dim, 128, 1), "pooling.linear2.bias": r(in_dim),
        "bn.norm.weight": rng.uniform(0.8, 1.2, n).astype(np.float32),
        "bn.norm.bias": r(n), "bn.norm.running_mean": r(n),
        "bn.norm.running_var": rng.uniform(0.5, 1.5, n).astype(np.float32),
        "bn.norm.num_batches_tracked": np.zeros((), np.int64),
        "fc.weight": r(EMBED, n), "fc.bias": r(EMBED),
    }


def jax_variables(enc_sd, head_sd, n_class=None, seed=0):
    """The JAX SpeakerNet's variables from the torch-named state dicts, by
    the JAX package's converters (and a seeded margin head)."""
    params, stats = whisper_pmfa_from_torch(head_sd)
    out = {"params": {"frontend": convert_whisper_state_dict(enc_sd, JAX_CFG), "backbone": params},
           "batch_stats": {"backbone": stats}}
    if n_class:
        rng = np.random.default_rng(seed)
        out["params"]["projection"] = {
            "weight": rng.normal(0.0, 0.3, (EMBED, n_class)).astype(np.float32)}
    return jax.tree.map(jnp.asarray, out)


def speechlike(rng, n, floor=0.01):
    """Two harmonics under a syllable-rate envelope over a noise floor."""
    t = np.arange(n) / SR
    f0 = rng.uniform(90, 280)
    env = np.clip(np.sin(2 * np.pi * rng.uniform(2, 6) * t + rng.uniform(0, 6)), 0, None)
    x = env * (0.1 * np.sin(2 * np.pi * f0 * t) + 0.05 * np.sin(4 * np.pi * f0 * t + 1.0))
    return (x + floor * rng.standard_normal(n)).astype(np.float32)


def wav_batch(seed):
    """Rows of 2.0, 1.3 and 0.7 s in a 2 s batch, silent past each length:
    100 tokens before the n_ctx cut at 64."""
    rng = np.random.default_rng(seed)
    lengths = np.array([32000, 20800, 11200], np.int32)
    wav = np.zeros((3, 32000), np.float32)
    for i, n in enumerate(lengths):
        wav[i, :n] = speechlike(rng, n)
    return wav, lengths


def port_net(attn_impl="flash", n_class=None, frozen=False):
    proj = ArcMarginProduct(EMBED, n_class, 32.0) if n_class else None
    return SpeakerNet(WhisperPMFA(JAX_CFG.output_size, EMBED),
                      WhisperEncoder(port_config(attn_impl=attn_impl), frozen=frozen), proj)


def cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, 1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def test_whisper_slice_matches_jax():
    enc_sd, head_sd = openai_state_dict(JAX_CFG, 31), head_state_dict(JAX_CFG.output_size, 32)
    variables = jax_variables(enc_sd, head_sd)

    # the converters: OpenAI / reference names -> JAX -> the port, exact
    sd = from_jax_variables(MODEL, variables)
    want = {f"frontend.{k}": v for k, v in whisper_encoder_state(enc_sd, JAX_CFG).items()}
    want.update({k: T(np.asarray(v)) for k, v in head_sd.items()})
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        assert torch.equal(sd[k], v.to(sd[k].dtype)), k
    no_post2 = {k: v for k, v in enc_sd.items() if not k.startswith("ln_post2")}
    enc = WhisperEncoder(port_config())
    load_whisper_state_dict(enc, {f"encoder.{k}": v for k, v in no_post2.items()})
    np.testing.assert_array_equal(enc.ln_post2.weight.detach().numpy(),
                                  convert_whisper_state_dict(no_post2, JAX_CFG)["ln_post2"]["scale"])
    assert not enc.ln_post2.bias.detach().any()
    assert enc.blocks[0].attn.key.bias is None and enc.blocks[0].attn_ln.eps == 1e-6

    # the training chunk (num_frms 500): 80,240 samples, 501 mel frames after
    # the dropped one, T = 251 tokens
    assert chunk_samples_for_frames(500) == 80240
    assert whisper_log_mel(torch.zeros(1, 80240)).shape == (1, 501, 80)
    assert enc.conv2(enc.conv1(torch.zeros(1, 80, 501))).shape[-1] == 251

    # log-mel
    wav, lengths = wav_batch(33)
    np.testing.assert_allclose(whisper_log_mel(T(wav)).numpy(),
                               np.asarray(jax_whisper_log_mel(jnp.asarray(wav))), atol=1e-4)

    # the encoder's features and lengths, flash and einsum
    jnet = JaxSpeakerNet(backbone=JaxWhisperPMFA(JAX_CFG.output_size, EMBED), projection=None,
                         frontend=JaxWhisperEncoder(JAX_CFG))
    want_hs, want_len = run_jax(lambda v, w, n: jnet.apply(v, w, n, method=jnet.features),
                                variables, wav, lengths)
    assert want_hs.shape == (3, 64, JAX_CFG.output_size)
    for impl in ("flash", "einsum"):
        port = port_net(impl).eval()
        missing, unexpected = load_speaker_state(port, sd)
        assert not missing and not unexpected
        with torch.no_grad():
            got_hs, got_len = port.features(T(wav), T(lengths))
        np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
        np.testing.assert_allclose(got_hs.numpy(), np.asarray(want_hs), **HS_TOL)
    np.testing.assert_array_equal(got_len.numpy(), [64, 64, 35])

    # embeddings: float32, then bf16 against JAX's bf16
    batch = {"wav": wav, "length": lengths}
    want = np.asarray(jax_make_eval_embed(jnet)(variables, batch))
    port = port_net("flash").eval()
    load_speaker_state(port, sd)
    got = make_eval_embed(port)({k: T(v) for k, v in batch.items()}).numpy()
    assert cosines(got, want).min() >= 0.99999
    np.testing.assert_allclose(got, want, atol=1e-4)
    want16 = np.asarray(jax_make_eval_embed(jnet, compute_dtype=jnp.bfloat16)(
        jax_cast_bf16(variables), batch))
    got16 = make_eval_embed(cast_variables_bf16(port), compute_dtype=torch.bfloat16)(
        {k: T(v) for k, v in batch.items()})
    assert got16.dtype == torch.float32
    assert cosines(got16.numpy(), want16).min() >= 0.9999


CHUNK = 8240  # num_frms 50: 51 mel frames, 26 tokens


def speech_list(root, seed, n=8):
    """A raw JSONL list of speech-like wavs of 0.7-1.4 s, a pitch and a
    noise floor each, over 3 speakers.  (White-noise wavs of one level give
    pooled statistics so alike across the batch that the head's BatchNorm,
    E[x^2] - E[x]^2 in float32, leaves a loss that float32 rounding of the
    input moves by more than the bar.)"""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        x = speechlike(rng, int(SR * rng.uniform(0.7, 1.4)), floor=10 ** rng.uniform(-3, -1))
        path = str(root / f"u{i}.wav")
        write_wav(path, np.clip(x, -1, 1))
        lines.append(json.dumps({"key": f"u{i}", "wav": path, "spk": f"s{i % 3}"}))
    return lines


def test_frozen_and_joint_steps_match_jax(tmp_path):
    """A stage-3 step (the encoder frozen: JAX zeroes the frontend's updates,
    the port trains no frontend tensor) and a stage-4 step (joint), each from
    the same seeded weights on the same batch (speed perturbation, packed
    reverb and noise, SpecAug off), float32."""
    lines = speech_list(tmp_path, 41)
    rirs, noises = _store_arrays(42)
    pipe = JaxTrainPipeline(lines, {"s0": 0, "s1": 1, "s2": 2},
                            JaxPipelineConfig(num_frms=50, shuffle_size=4, filter_min_frames=50,
                                              filter_max_frames=200, aug_prob=0.5,
                                              rir_max_samples=400, batch_size=4, seed=3),
                            JaxAugStore(arrays=rirs), JaxAugStore(arrays=noises))
    batch = next(iter(pipe))
    assert batch["noise"].shape == (1, CHUNK)
    n_class = 9
    variables = jax.tree.map(np.asarray, jax_variables(
        openai_state_dict(JAX_CFG, 43, extra_blocks=0), head_state_dict(JAX_CFG.output_size, 44),
        n_class, seed=45))
    kw = dict(num_epochs=2, epoch_iter=2, initial_lr=0.005, final_lr=0.00113, warm_up_epoch=1)
    mkw = dict(epoch_iter=2, increase_start_epoch=0, fix_start_epoch=2, initial_margin=0.2,
               final_margin=0.2)
    def exact_loss():
        """The port's step in float64 on the same batch and weights."""
        net = port_net("einsum", n_class)
        load_speaker_state(net, from_jax_variables(MODEL, variables))
        net.double()
        st = TrainState(net, make_optimizer(net), schedulers.ExponentialDecrease(**kw))
        step = make_train_step(net, st.lr_schedule, schedulers.MarginSchedule(**mkw),
                               feature_cfg=FeaturePipelineConfig(spec_aug=False),
                               chunk_samples=CHUNK)
        return float(step(st, {k: T(v).double() if v.dtype == np.float32 else T(v)
                               for k, v in batch.items()})["loss"])

    exact = exact_loss()

    for frozen in (True, False):
        paths = (("frontend",),) if frozen else ()
        jnet = JaxSpeakerNet(backbone=JaxWhisperPMFA(JAX_CFG.output_size, EMBED),
                             projection=JaxArcMargin(EMBED, n_class, 32.0),
                             frontend=JaxWhisperEncoder(JAX_CFG, frozen=frozen))
        jlr, jmargin = jax_sched.ExponentialDecrease(**kw), jax_sched.MarginSchedule(**mkw)
        tx = jax_make_optimizer(jlr, "SGD", 0.9, True, 1e-4, freeze_paths=paths)
        # fresh arrays: the step donates its state
        params = jax.tree.map(jnp.array, variables["params"])
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=jax.tree.map(jnp.array, variables["batch_stats"]),
                              opt_state=tx.init(params))
        jstep = FastJit(jax_make_train_step(jnet, tx, jlr, jmargin,
                                            feature_cfg=JaxFeatureConfig(spec_aug=False),
                                            chunk_samples=CHUNK))

        port = port_net("flash", n_class, frozen=frozen)
        before = from_jax_variables(MODEL, variables)
        missing, unexpected = load_speaker_state(port, before)
        assert not missing and not unexpected
        frozen_names = freeze_paths(port, paths)
        assert len(frozen_names) == (sum(1 for _ in port.frontend.parameters()) if frozen else 0)
        pstate = TrainState(port, make_optimizer(port, "SGD", 0.9, True, 1e-4),
                            schedulers.ExponentialDecrease(**kw))
        pstep = make_train_step(port, pstate.lr_schedule, schedulers.MarginSchedule(**mkw),
                                feature_cfg=FeaturePipelineConfig(spec_aug=False),
                                chunk_samples=CHUNK)
        state, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.key(1))
        pm = pstep(pstate, {k: T(v) for k, v in batch.items()})
        # float32 leaves this loss about 1e-5 off the exact one: the head's
        # BatchNorm takes flax's E[x^2] - E[x]^2 over pooled statistics that
        # a random encoder makes nearly equal across the batch.  The bar is
        # 1e-5, or twice JAX's own distance from the port's float64 step
        # where that is more.
        jloss, ploss = float(jm["loss"]), float(pm["loss"])
        bar = max(1e-5, 2 * abs(jloss - exact) / abs(exact))
        assert abs(ploss - jloss) <= bar * abs(jloss), (frozen, ploss, jloss, exact)
        assert abs(ploss - exact) <= bar * abs(exact), (frozen, ploss, jloss, exact)
        assert float(pm["acc"]) == float(jm["acc"])
        after = speaker_state_dict(port)
        jafter = from_jax_variables(MODEL, {"params": state.params,
                                            "batch_stats": state.batch_stats})
        ups, jups = [], []
        for name, w in jafter.items():
            if name.endswith("num_batches_tracked"):
                continue
            upd, jupd = (after[name] - before[name]).numpy(), (w - before[name]).numpy()
            if frozen and name.startswith("frontend."):
                assert not upd.any() and not jupd.any(), name
                continue
            ups.append(upd.ravel())
            jups.append(jupd.ravel())
            if np.linalg.norm(jupd) > 1e-5:
                cos = upd.ravel() @ jupd.ravel() / (np.linalg.norm(upd) * np.linalg.norm(jupd))
                assert cos >= STEP_TOL[0][2], (frozen, name, cos)
        ups, jups = np.concatenate(ups), np.concatenate(jups)
        assert np.linalg.norm(ups - jups) / np.linalg.norm(jups) <= STEP_TOL[0][1], frozen
