"""Port parity: two `make_train_step` steps of the SSL joint fine-tuning
slice against the JAX package's, with the frontend unfrozen and frozen.

WavLM-tiny (pre-LN) + a narrow ECAPA + ArcMargin + torch-semantics SGD,
float32, batch 4, speed perturbation and packed augmentation (one reverb
row, one noise row), SpecAug off; weights carried across with
`from_jax_variables` (the projection included).  Two tests on purpose:
xdist's loadfile order runs files with the most tests first, so this file
(JAX's train-step compiles, about 10 s each) starts after the long
`test_quality_gates_ssl.py` instead of ahead of it.  Tolerances: STEP_TOL.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from tests.torch_port_refs import FastJit
from tests.test_torch_port_train import _randomize, _store_arrays, _write_list
from wespeaker_hubert_tpu.data import AugStore as JaxAugStore
from wespeaker_hubert_tpu.data import TrainPipeline as JaxTrainPipeline
from wespeaker_hubert_tpu.data import TrainPipelineConfig as JaxPipelineConfig
from wespeaker_hubert_tpu.frontend import SSLEncoderConfig as JaxSSLConfig
from wespeaker_hubert_tpu.frontend import SSLFrontend as JaxSSLFrontend
from wespeaker_hubert_tpu.models.ecapa_tdnn import EcapaTdnn as JaxEcapa
from wespeaker_hubert_tpu.models.projections import ArcMarginProduct as JaxArcMargin
from wespeaker_hubert_tpu.models.speaker_net import SpeakerNet as JaxSpeakerNet
from wespeaker_hubert_tpu.ops.pipeline import FeaturePipelineConfig as JaxFeatureConfig
from wespeaker_hubert_tpu.train import schedulers as jax_sched
from wespeaker_hubert_tpu.train.executor import make_train_step as jax_make_train_step
from wespeaker_hubert_tpu.train.state import TrainState as JaxTrainState
from wespeaker_hubert_tpu.train.state import make_optimizer as jax_make_optimizer
from wespeaker_hubert_tpu_torch.frontend import SSLEncoderConfig, SSLFrontend
from wespeaker_hubert_tpu_torch.models.convert_jax import from_jax_variables
from wespeaker_hubert_tpu_torch.models.ecapa_tdnn import EcapaTdnn
from wespeaker_hubert_tpu_torch.models.projections import ArcMarginProduct
from wespeaker_hubert_tpu_torch.models.speaker_net import (
    SpeakerNet,
    load_speaker_state,
    speaker_state_dict,
)
from wespeaker_hubert_tpu_torch.ops.pipeline import FeaturePipelineConfig
from wespeaker_hubert_tpu_torch.train import schedulers
from wespeaker_hubert_tpu_torch.train.executor import make_train_step
from wespeaker_hubert_tpu_torch.train.state import TrainState, freeze_paths, make_optimizer

T = torch.from_numpy


CHUNK = 8240  # num_frms 50
# per step: loss rtol, the updates' relative L2 error over all tensors, the
# least per-tensor cosine.  The ECAPA BatchNorm over the pooled statistics at
# batch 4 sees features whose batch variance is 1e-4 of their square, so
# flax's E[x^2] - E[x]^2 loses ~1e-3 of it to float32 rounding on either
# side; step 2 inherits and amplifies step 1's differences.
STEP_TOL = [(1e-4, 1e-3, 0.99), (5e-3, 2e-2, 0.95)]


def _step_batches(tmp_path):
    """Two packed batches of 4 (one reverb row, one noise row each) with
    speed perturbation, from the JAX pipeline."""
    lines, _ = _write_list(str(tmp_path), n=8, seed=21)
    rirs, noises = _store_arrays(22)
    cfg = JaxPipelineConfig(num_frms=50, shuffle_size=4, filter_min_frames=50,
                            filter_max_frames=200, aug_prob=0.5, rir_max_samples=400,
                            batch_size=4, seed=3)
    pipe = JaxTrainPipeline(lines, {"s0": 0, "s1": 1, "s2": 2}, cfg, JaxAugStore(arrays=rirs),
                            JaxAugStore(arrays=noises))
    batches = list(pipe)[:2]
    assert len(batches) == 2 and batches[0]["rir"].shape[0] == 1
    assert batches[0]["noise"].shape == (1, CHUNK)
    return batches


@pytest.mark.parametrize("frozen", [False, True], ids=["joint", "frozen"])
def test_train_step_matches_jax(tmp_path, frozen):
    """Two steps of WavLM-tiny (pre-LN) + a narrow ECAPA + ArcMargin + SGD,
    float32, speed perturbation and packed augmentation, SpecAug off.  JAX's
    CPU path is einsum attention (which the interpret-mode test above ties
    to the Pallas kernels); the port's goes through the FlashAttention
    Function's plain versions."""
    jcfg = JaxSSLConfig.tiny("wavlm", True)
    n_class = 9
    frontend = JaxSSLFrontend(jcfg, frozen=frozen)
    net = JaxSpeakerNet(backbone=JaxEcapa(32, 32, 16, "ASTP", True, False),
                        projection=JaxArcMargin(16, n_class, 32.0), frontend=frontend)
    kw = dict(num_epochs=2, epoch_iter=2, initial_lr=0.001, final_lr=0.00025, warm_up_epoch=1)
    mkw = dict(epoch_iter=2, increase_start_epoch=1, fix_start_epoch=2, initial_margin=0.0,
               final_margin=0.2)
    jlr, jmargin = jax_sched.ExponentialDecrease(**kw), jax_sched.MarginSchedule(**mkw)
    paths = (("frontend", "upstream"),) if frozen else ()
    tx = jax_make_optimizer(jlr, "SGD", 0.9, True, 1e-4, freeze_paths=paths)
    shapes = jax.eval_shape(lambda: net.init(
        jax.random.key(0), jnp.zeros((1, 50, 32)), jnp.zeros((1,), jnp.int32), 0.0, train=True))
    fshapes = jax.eval_shape(lambda: net.init(
        jax.random.key(1), jnp.zeros((1, 3200)), train=True, method=net.features))
    rng = np.random.default_rng(23)
    params = _randomize({**shapes["params"], **fshapes["params"]}, rng)
    stats = _randomize(shapes["batch_stats"], rng)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                       opt_state=tx.init(params))
    jstep = FastJit(jax_make_train_step(net, tx, jlr, jmargin,
                                        feature_cfg=JaxFeatureConfig(spec_aug=False),
                                        chunk_samples=CHUNK))

    port_cfg = SSLEncoderConfig(**{**{f.name: getattr(jcfg, f.name)
                                      for f in dataclasses.fields(SSLEncoderConfig)},
                                   "attn_impl": "flash"})
    port = SpeakerNet(EcapaTdnn(32, 32, 16, "ASTP", True), SSLFrontend(port_cfg, frozen=frozen),
                      ArcMarginProduct(16, n_class, 32.0))
    sd = from_jax_variables("ECAPA_TDNN_GLOB_c512", {"params": params, "batch_stats": stats})
    missing, unexpected = load_speaker_state(port, sd)
    assert not missing and not unexpected
    freeze_paths(port, paths)
    pstate = TrainState(port, make_optimizer(port, "SGD", 0.9, True, 1e-4),
                        schedulers.ExponentialDecrease(**kw))
    pstep = make_train_step(port, pstate.lr_schedule, schedulers.MarginSchedule(**mkw),
                            feature_cfg=FeaturePipelineConfig(spec_aug=False), chunk_samples=CHUNK)

    jrng = jax.random.key(1)
    for step, batch in enumerate(_step_batches(tmp_path)):
        before = {k: v.clone() for k, v in speaker_state_dict(port).items()}
        jbefore = from_jax_variables("ECAPA_TDNN_GLOB_c512",
                                     {"params": state.params, "batch_stats": state.batch_stats})
        state, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()}, jrng)
        pm = pstep(pstate, {k: T(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=STEP_TOL[step][0])
        assert float(pm["acc"]) == float(jm["acc"])
        np.testing.assert_allclose([pm["lr"], pm["margin"]],
                                   [float(jm["lr"]), float(jm["margin"])], rtol=1e-6)
        after = speaker_state_dict(port)
        jafter = from_jax_variables("ECAPA_TDNN_GLOB_c512",
                                    {"params": state.params, "batch_stats": state.batch_stats})
        ups, jups = [], []
        for name, w in jafter.items():  # parameters and BatchNorm statistics
            if name.endswith("num_batches_tracked"):
                continue
            upd, jupd = (after[name] - before[name]).numpy(), (w - jbefore[name]).numpy()
            if frozen and name.startswith("frontend.upstream."):
                assert not upd.any() and not jupd.any(), name
                continue
            ups.append(upd.ravel())
            jups.append(jupd.ravel())
            if np.linalg.norm(jupd) > 1e-5:  # not a gradient-free bias (decay only)
                cos = upd.ravel() @ jupd.ravel() / (np.linalg.norm(upd) * np.linalg.norm(jupd))
                assert cos >= STEP_TOL[step][2], (step, name, cos)
        ups, jups = np.concatenate(ups), np.concatenate(jups)
        rel = np.linalg.norm(ups - jups) / np.linalg.norm(jups)
        assert rel <= STEP_TOL[step][1], (step, rel)
    assert pstate.step == 2
