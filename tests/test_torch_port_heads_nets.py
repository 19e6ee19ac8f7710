"""Port parity: whole networks with the multi-head poolings and the
SphereFace2 head, against the JAX package on the CPU (2 tests, so xdist's
loadfile order starts this file late).

- an ECAPA with MQMHASTP: eval embeddings of a masked batch through the
  converter, atol 1e-5;
- a narrow ResNet with MHASTP (the port flattens its frame map
  frequency-major for the multi-head poolings, as JAX does): eval
  embeddings, atol 1e-5; then one float32 train step with the SphereFace2
  head, whose loss replaces cross-entropy, against JAX's
  `make_train_step`: loss within 1e-5 relative, the update within 1e-4
  relative L2 (the ResNet step test's bars).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_port_ecapa import random_variables
from tests.test_torch_port_resnet import MARGIN, SCHED
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from tests.torch_port_refs import FastJit, run_jax
from wespeaker_hubert_tpu.models import ecapa_tdnn as jax_ecapa
from wespeaker_hubert_tpu.models import projections as jax_projections
from wespeaker_hubert_tpu.models import resnet as jax_resnet
from wespeaker_hubert_tpu.models.speaker_net import SpeakerNet as JaxSpeakerNet
from wespeaker_hubert_tpu.ops.pipeline import FeaturePipelineConfig as JaxFeatureConfig
from wespeaker_hubert_tpu.train import schedulers as jax_sched
from wespeaker_hubert_tpu.train.executor import make_train_step as jax_make_train_step
from wespeaker_hubert_tpu.train.state import TrainState as JaxTrainState
from wespeaker_hubert_tpu.train.state import make_optimizer as jax_make_optimizer
from wespeaker_hubert_tpu_torch.models import ecapa_tdnn, projections, resnet
from wespeaker_hubert_tpu_torch.models.convert_jax import from_jax_variables
from wespeaker_hubert_tpu_torch.models.speaker_net import SpeakerNet, speaker_state_dict
from wespeaker_hubert_tpu_torch.ops.pipeline import FeaturePipelineConfig
from wespeaker_hubert_tpu_torch.train import executor, schedulers
from wespeaker_hubert_tpu_torch.train.executor import make_train_step
from wespeaker_hubert_tpu_torch.train.state import TrainState, make_optimizer

T = torch.from_numpy


def _masked_batch(b, t, fd, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, fd)).astype(np.float32)
    return x, np.arange(t)[None, :] < np.array([t, t - 11, 14])[:, None]


def test_ecapa_with_mqmhastp_matches_jax():
    fd, t = 16, 40
    jm = jax_ecapa.EcapaTdnn(channels=16, feat_dim=fd, embed_dim=8, pooling_func="MQMHASTP")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, t, fd))))
    variables = random_variables(shapes, 4)
    pm = ecapa_tdnn.EcapaTdnn(16, fd, 8, "MQMHASTP").eval()
    pm.load_state_dict(from_jax_variables("ECAPA_TDNN_c512", variables), strict=True)
    x, mask = _masked_batch(3, t, fd, 9)
    want = run_jax(lambda v, x, m: jm.apply(v, x, mask=m, train=False), variables,
                   jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got = pm(T(x), T(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


N_CLASS = 9


def test_resnet_mhastp_eval_and_sphereface2_step_match_jax(monkeypatch):
    """A narrow BasicBlock ResNet with MHASTP: eval embeddings on a masked
    batch, then one float32 train step with the SphereFace2 head on a
    feature batch of 6 x 40 frames, 16 mels, against JAX."""
    fd, b, t = 16, 6, 40
    backbone = jax_resnet.ResNet(jax_resnet.BasicBlock, (1, 1, 1, 1), 8, fd, 8, "MHASTP")
    jhead = jax_projections.SphereFace2(8, N_CLASS, margin_type="C")
    net = JaxSpeakerNet(backbone=backbone, projection=jhead)
    shapes = jax.eval_shape(lambda: net.init(
        jax.random.key(0), jnp.zeros((1, t, fd)), jnp.zeros((1,), jnp.int32), 0.0, train=True))
    variables = random_variables(shapes, 6)
    sd = from_jax_variables("ResNet18", variables, feat_dim=fd)
    port = SpeakerNet(resnet.ResNet(resnet.BasicBlock, (1, 1, 1, 1), 8, fd, 8, "MHASTP"), None,
                      projections.SphereFace2(8, N_CLASS, margin_type="C"))
    assert not port.load_state_dict(
        {("backbone." + k if not k.startswith("projection.") else k): v for k, v in sd.items()},
        strict=True).missing_keys
    assert "projection.bias" in sd

    x, mask = _masked_batch(3, 45, fd, 2)
    want = run_jax(lambda v, x, m: backbone.apply(v, x, mask=m, train=False),
                   {"params": variables["params"]["backbone"],
                    "batch_stats": variables["batch_stats"]["backbone"]},
                   jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got = port.backbone.eval()(T(x), T(mask))
    port.train()
    np.testing.assert_allclose(got[-1].numpy(), np.asarray(want[-1]), rtol=0, atol=1e-5)

    jlr, jmargin = jax_sched.ExponentialDecrease(**SCHED), jax_sched.MarginSchedule(**MARGIN)
    tx = jax_make_optimizer(jlr, "SGD", 0.9, True, 1e-4)
    params, stats = variables["params"], variables["batch_stats"]
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                          opt_state=tx.init(params))
    jstep = FastJit(jax_make_train_step(net, tx, jlr, jmargin,
                                        feature_cfg=JaxFeatureConfig(spec_aug=False)))
    pstate = TrainState(port, make_optimizer(port, "SGD", 0.9, True, 1e-4),
                        schedulers.ExponentialDecrease(**SCHED))
    pstep = make_train_step(port, pstate.lr_schedule, schedulers.MarginSchedule(**MARGIN),
                            feature_cfg=FeaturePipelineConfig(spec_aug=False))
    rng = np.random.default_rng(7)
    batch = {"feat": (rng.standard_normal((b, t, fd)) * 2 + 5).astype(np.float32),
             "label": rng.integers(0, N_CLASS, b).astype(np.int32)}
    before = {k: v.clone() for k, v in speaker_state_dict(port).items()}
    state, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(1))
    ce_calls = []
    monkeypatch.setattr(executor, "cross_entropy", lambda *a: ce_calls.append(a))
    pm = pstep(pstate, {k: T(v) for k, v in batch.items()})
    assert not ce_calls  # the SphereFace2 loss, not cross-entropy of its logits
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
    after = speaker_state_dict(port)
    jafter = from_jax_variables("ResNet18", {"params": state.params,
                                             "batch_stats": state.batch_stats}, feat_dim=fd)
    assert set(jafter) == set(after)
    ups, jups = [], []
    for name, w in jafter.items():
        if not name.endswith("num_batches_tracked"):
            ups.append((after[name] - before[name]).numpy().ravel())
            jups.append((w - sd[name]).numpy().ravel())
    ups, jups = np.concatenate(ups), np.concatenate(jups)
    rel = np.linalg.norm(ups - jups) / np.linalg.norm(jups)
    assert rel <= 1e-4, rel
