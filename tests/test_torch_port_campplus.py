"""Port parity: CAM++ against the JAX package, with the checks and the
tolerances of tests/test_torch_port_zoo.py.

- CAM++ at growth 8, bottleneck 16 and 16 initial channels (its 52 layers
  and its FCM's 32 channels are fixed), feat_dim 40, on a padded batch of 3
  x 230 frames (115 after its TDNN: not a multiple of its 100-frame
  segments): `from_jax_variables` inverts `campplus_from_torch` bit for
  bit; eval with the ragged mask (and the full-length row without one);
  train-mode BatchNorm with the mask (without one it is the train step's).
- One float32 train step on features (CMVN -> CAM++ -> ArcMargin ->
  cross-entropy -> SGD with Nesterov and weight decay) against JAX's
  `make_train_step` and the port's float64 step: the loss by the float64
  rule of the forward, the whole update within 1e-4 relative L2 (the
  ResNet test's rule) or twice JAX's distance from the float64 update where
  that is more, every tensor's update within 5 x JAX's distance, with a
  fault that must miss the bar (see the test).

Two tests in this file on purpose: JAX's CAM++ costs some 60 s of trace and
compile, and pytest-xdist's `loadfile` queue runs a file of 2 after the
suite's critical path, tests/test_quality_gates_ssl.py, has started."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from tests.torch_port_refs import FastJit
from tests.test_torch_port_zoo import (
    FD,
    _jax_variables,
    assert_exact_rule,
    check_eval,
    check_inverse,
    check_train_mode,
    jax_reference,
    wespeaker_state,
)
from wespeaker_hubert_tpu.models import campplus as jax_campplus
from wespeaker_hubert_tpu.models.convert_torch import campplus_from_torch
from wespeaker_hubert_tpu.models.projections import ArcMarginProduct as JaxArcMargin
from wespeaker_hubert_tpu.models.speaker_net import SpeakerNet as JaxSpeakerNet
from wespeaker_hubert_tpu.ops.pipeline import FeaturePipelineConfig as JaxFeatureConfig
from wespeaker_hubert_tpu.train import schedulers as jax_sched
from wespeaker_hubert_tpu.train.executor import make_train_step as jax_make_train_step
from wespeaker_hubert_tpu.train.state import TrainState as JaxTrainState
from wespeaker_hubert_tpu.train.state import make_optimizer as jax_make_optimizer
from wespeaker_hubert_tpu_torch.models import campplus
from wespeaker_hubert_tpu_torch.models.convert_jax import from_jax_variables
from wespeaker_hubert_tpu_torch.models.projections import ArcMarginProduct
from wespeaker_hubert_tpu_torch.models.speaker_net import SpeakerNet, speaker_state_dict
from wespeaker_hubert_tpu_torch.ops.pipeline import FeaturePipelineConfig
from wespeaker_hubert_tpu_torch.train import schedulers
from wespeaker_hubert_tpu_torch.train.executor import make_train_step
from wespeaker_hubert_tpu_torch.train.state import TrainState, make_optimizer

T = torch.from_numpy
KW = dict(feat_dim=FD, embed_dim=16, growth_rate=8, bn_size=2, init_channels=16)
CASE = ("CAMPPlus", lambda: jax_campplus.CAMPPlus(**KW), lambda: campplus.CAMPPlus(**KW),
        lambda sd: campplus_from_torch(sd, feat_dim=FD), (3, 230))
SCHED = dict(num_epochs=2, epoch_iter=2, initial_lr=0.1, final_lr=0.025, warm_up_epoch=1)
MARGIN = dict(epoch_iter=2, increase_start_epoch=0, fix_start_epoch=1, initial_margin=0.2,
              final_margin=0.2)
N_CLASS = 9


def test_campplus_matches_jax():
    case = jax_reference(CASE, "campplus", modes=("mask",))
    check_inverse(case)
    check_eval(case)
    check_train_mode(case)


def _updates(after, before):
    """name -> the step's update of every tensor but the counters, as float64."""
    return {k: (after[k].double() - before[k].double()).numpy().ravel()
            for k in sorted(before) if not k.endswith("num_batches_tracked")}


def _rel(a, ref):
    """The relative L2 distance of update dicts `a` from `ref`, all tensors
    together and per tensor."""
    keys = sorted(ref)
    whole = float(np.linalg.norm(np.concatenate([a[k] - ref[k] for k in keys]))
                  / np.linalg.norm(np.concatenate([ref[k] for k in keys])))
    return whole, {k: float(np.linalg.norm(a[k] - ref[k]) / max(np.linalg.norm(ref[k]), 1e-300))
                   for k in keys}


def _port_step(start, batch, dtype, weight_decay):
    pnet = SpeakerNet(campplus.CAMPPlus(**KW), None, ArcMarginProduct(16, N_CLASS, 32.0))
    assert not pnet.load_state_dict(
        {("backbone." + k if not k.startswith("projection.") else k): v
         for k, v in start.items()}, strict=True).missing_keys
    pnet.to(dtype)
    pstate = TrainState(pnet, make_optimizer(pnet, "SGD", 0.9, True, weight_decay),
                        schedulers.ExponentialDecrease(**SCHED))
    pstep = make_train_step(pnet, pstate.lr_schedule, schedulers.MarginSchedule(**MARGIN),
                            feature_cfg=FeaturePipelineConfig(spec_aug=False))
    metrics = pstep(pstate, {"feat": T(batch["feat"]).to(dtype), "label": T(batch["label"])})
    return float(metrics["loss"]), _updates(speaker_state_dict(pnet), start)


def test_campplus_train_step_matches_jax():
    """One float32 step on a feature batch of 4 x 64 frames with
    per-utterance feature scales and offsets (SpecAug off: the two packages
    draw their masks from different generators), with the port's float64
    step on the same batch and weights as the exact one.  Weight decay is
    1e-2: at WeSpeaker's 1e-4 its share of the update sits below float32's
    noise here, and a wrong decay would pass any bar.

    At random weights a float32 step of CAM++ moves the parameters ~6e-3
    (relative L2) from the exact step, JAX's as the port's, whatever the
    inputs (5.7e-3 to 2.7e-2 for JAX over batches of 3-16 rows, with and
    without per-row offsets): its 52 train-mode BatchNorms' backward
    cancels most of each gradient and scales every rounding up, uniformly
    in the early layers.  So the bars are JAX's own distances:
    - the loss within 1e-5 relative, or twice JAX's distance from the exact
      loss where that is more (JAX's under 1e-4; it reads 1.66e-5);
    - the whole update within 1e-4 relative L2, or twice JAX's distance
      where that is more (JAX's under 1.5e-2; it reads 5.73e-3), against
      JAX and against the exact update;
    - every tensor's update within 5 x the larger of JAX's distance on that
      tensor and JAX's whole-update distance (the port reads at most 3.55
      x).  Faults read: the port's step without weight decay 19.9 x (with
      it doubled the same), without Nesterov 83.7 x, with the dense
      layer's weight frozen 175 x; the test holds the first against the
      bar."""
    b, t, weight_decay = 4, 64, 1e-2
    sd = wespeaker_state(campplus.CAMPPlus(**KW), seed=12)
    head = np.random.default_rng(13).standard_normal((16, N_CLASS)).astype(np.float32)
    params, stats = campplus_from_torch(sd, feat_dim=FD)
    params = {"backbone": params, "projection": {"weight": head}}
    stats = {"backbone": stats}
    start = from_jax_variables("CAMPPlus", {"params": params, "batch_stats": stats}, feat_dim=FD)
    rng = np.random.default_rng(7)
    feat = (rng.standard_normal((b, t, FD)) * rng.uniform(0.5, 2.0, (b, 1, FD))
            + rng.normal(0.0, 3.0, (b, 1, FD)))
    batch = {"feat": (feat * 2 + 5).astype(np.float32),
             "label": rng.integers(0, N_CLASS, b).astype(np.int32)}

    net = JaxSpeakerNet(backbone=jax_campplus.CAMPPlus(**KW),
                        projection=JaxArcMargin(16, N_CLASS, 32.0))
    jlr, jmargin = jax_sched.ExponentialDecrease(**SCHED), jax_sched.MarginSchedule(**MARGIN)
    tx = jax_make_optimizer(jlr, "SGD", 0.9, True, weight_decay)
    variables = _jax_variables(params, stats)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]))
    jstep = FastJit(jax_make_train_step(net, tx, jlr, jmargin,
                                        feature_cfg=JaxFeatureConfig(spec_aug=False)))
    state, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(1))
    jafter = from_jax_variables("CAMPPlus", {"params": jax.device_get(state.params),
                                             "batch_stats": jax.device_get(state.batch_stats)},
                                feat_dim=FD)
    want = _updates(jafter, start)

    loss, got = _port_step(start, batch, torch.float32, weight_decay)
    exact_loss, exact = _port_step(start, batch, torch.float64, weight_decay)
    d_loss = abs(float(jm["loss"]) - exact_loss) / abs(exact_loss)
    assert d_loss <= 1e-4, d_loss
    for other in (float(jm["loss"]), exact_loss):
        assert abs(loss - other) / abs(exact_loss) <= max(1e-5, 2 * d_loss), (loss, other)
    assert set(want) == set(exact)
    jax_whole, jax_each = _rel(want, exact)
    assert jax_whole <= 1.5e-2, jax_whole
    bar = max(1e-4, 2 * jax_whole)
    whole, each = _rel(got, exact)
    assert whole <= bar, (whole, bar)
    assert _rel(got, want)[0] <= bar, bar

    def over(each):
        return {k: e / max(jax_each[k], jax_whole) for k, e in each.items()
                if e > 5 * max(jax_each[k], jax_whole)}

    assert not over(each), over(each)
    # the control: the same step without weight decay misses the bar
    assert over(_rel(_port_step(start, batch, torch.float32, 0.0)[1], exact)[1])
