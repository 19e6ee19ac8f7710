"""Port parity: the ResNet family, BatchNorm2d's train mode and ResNet's
JAX -> torch weight converter, against the JAX package.

- narrow ResNets (BasicBlock and Bottleneck, one block per stage, 8
  channels, 16 / 24 mels) in eval on a padded batch with a mask against the
  JAX module's eval, through its space-to-depth stem (`s2d_stem=True`, as
  JAX runs eval) and its direct path: float32, atol 1e-5;
- `BatchNorm2d` in train mode against flax's `BatchNorm` on the same map:
  output and running statistics within 1e-6;
- one float32 train step on features (CMVN -> ResNet -> ArcMargin ->
  cross-entropy -> SGD with Nesterov and weight decay) against JAX's
  `make_train_step`: loss within 1e-5 relative, every parameter's and
  BatchNorm statistic's update within 1e-4 relative L2 (float32 sums in
  another order through a dozen BatchNorms);
- `from_jax_variables` equal, element for element, to the JAX package's
  `to_torch_state_dict` (WeSpeaker's layout) on ResNet18 and ResNet50.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_ecapa import random_variables
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from wespeaker_hubert_tpu.models import resnet as jax_resnet
from wespeaker_hubert_tpu.models.convert_to_torch import to_torch_state_dict
from wespeaker_hubert_tpu.models.norm import BatchNorm as JaxBatchNorm
from wespeaker_hubert_tpu.models.projections import ArcMarginProduct as JaxArcMargin
from wespeaker_hubert_tpu.models.speaker_net import SpeakerNet as JaxSpeakerNet
from wespeaker_hubert_tpu.ops.pipeline import FeaturePipelineConfig as JaxFeatureConfig
from wespeaker_hubert_tpu.train import schedulers as jax_sched
from wespeaker_hubert_tpu.train.executor import make_train_step as jax_make_train_step
from wespeaker_hubert_tpu.train.state import TrainState as JaxTrainState
from wespeaker_hubert_tpu.train.state import make_optimizer as jax_make_optimizer
from wespeaker_hubert_tpu_torch.models import resnet
from wespeaker_hubert_tpu_torch.models.convert_jax import from_jax_variables
from wespeaker_hubert_tpu_torch.models.norm import BatchNorm2d
from wespeaker_hubert_tpu_torch.models.projections import ArcMarginProduct
from wespeaker_hubert_tpu_torch.models.speaker_net import SpeakerNet, speaker_state_dict
from wespeaker_hubert_tpu_torch.ops.pipeline import FeaturePipelineConfig
from wespeaker_hubert_tpu_torch.train import schedulers
from wespeaker_hubert_tpu_torch.train.executor import make_train_step
from wespeaker_hubert_tpu_torch.train.state import TrainState, make_optimizer

T = torch.from_numpy

# (block, feat_dim, two_emb_layer, (B, T)); "ResNet18" / "ResNet50" name the
# family and block kind for the converter
NARROW = {
    "basic": ("ResNet18", "BasicBlock", 16, False, (3, 45)),
    "bottleneck": ("ResNet50", "Bottleneck", 24, True, (3, 37)),
}


def jax_narrow(kind, s2d_stem=True):
    _, block, fd, two, _ = NARROW[kind]
    return jax_resnet.ResNet(getattr(jax_resnet, block), (1, 1, 1, 1), 8, fd, 8, "TSTP", two,
                             s2d_stem=s2d_stem)


def port_narrow(kind):
    _, block, fd, two, _ = NARROW[kind]
    return resnet.ResNet(getattr(resnet, block), (1, 1, 1, 1), 8, fd, 8, "TSTP", two)


@pytest.fixture(scope="module", params=sorted(NARROW))
def case(request):
    kind = request.param
    name, _, fd, _, (b, t) = NARROW[kind]
    jm = jax_narrow(kind)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, t, fd)),
                                            train=False))
    variables = random_variables(shapes, 3)
    pm = port_narrow(kind).eval()
    pm.load_state_dict(from_jax_variables(name, variables, feat_dim=fd), strict=True)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, t, fd)).astype(np.float32)
    mask = np.arange(t)[None, :] < np.array([t, t - 13, 11])[:, None]
    return dict(kind=kind, variables=variables, pm=pm, x=x, mask=mask)


@pytest.mark.parametrize("s2d_stem", [True, False], ids=["s2d", "direct"])
def test_eval_matches_jax(case, s2d_stem):
    jm = jax_narrow(case["kind"], s2d_stem)
    want = jax.jit(lambda v, x, m: jm.apply(v, x, mask=m, train=False))(
        case["variables"], jnp.asarray(case["x"]), jnp.asarray(case["mask"]))
    with torch.inference_mode():
        got = case["pm"](T(case["x"]), T(case["mask"]))
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    # the padded rows' embeddings depend on the mask
    with torch.inference_mode():
        unmasked = case["pm"](T(case["x"]))[-1]
    assert not torch.allclose(unmasked[1:], got[-1][1:], atol=1e-4)


def test_batchnorm2d_train_matches_flax():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((4, 6, 10, 7)) * 3 + 1.5).astype(np.float32)  # NCHW (B, C, F, T)
    scale, bias = rng.uniform(0.5, 1.5, 6), rng.normal(0, 0.1, 6)
    mean0, var0 = rng.normal(0, 0.1, 6), rng.uniform(0.5, 1.5, 6)
    bn = JaxBatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), variables)
    want, upd = bn.apply(variables, jnp.asarray(x.transpose(0, 3, 2, 1)), mutable=["batch_stats"])
    port = BatchNorm2d(6, eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        for name, v in (("weight", scale), ("bias", bias), ("running_mean", mean0),
                        ("running_var", var0)):
            getattr(port, name).copy_(torch.tensor(v, dtype=torch.float32))
    got = port(T(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want).transpose(0, 3, 2, 1),
                               rtol=0, atol=1e-6)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(upd["batch_stats"][key]), rtol=0, atol=1e-6)
    assert int(port.num_batches_tracked) == 1


SCHED = dict(num_epochs=2, epoch_iter=2, initial_lr=0.1, final_lr=0.025, warm_up_epoch=1)
MARGIN = dict(epoch_iter=2, increase_start_epoch=0, fix_start_epoch=1, initial_margin=0.2,
              final_margin=0.2)
N_CLASS = 9


def test_train_step_matches_jax():
    """One float32 step of a narrow BasicBlock ResNet + ArcMargin on a feature
    batch of 6 x 40 frames, 16 mels (SpecAug off: the two packages draw
    their masks from different generators)."""
    fd, b, t = 16, 6, 40
    net = JaxSpeakerNet(backbone=jax_narrow("basic"), projection=JaxArcMargin(8, N_CLASS, 32.0))
    jlr, jmargin = jax_sched.ExponentialDecrease(**SCHED), jax_sched.MarginSchedule(**MARGIN)
    tx = jax_make_optimizer(jlr, "SGD", 0.9, True, 1e-4)
    shapes = jax.eval_shape(lambda: net.init(
        jax.random.key(0), jnp.zeros((1, t, fd)), jnp.zeros((1,), jnp.int32), 0.0, train=True))
    variables = random_variables(shapes, 6)
    params, stats = variables["params"], variables["batch_stats"]
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                          opt_state=tx.init(params))
    jstep = jax_make_train_step(net, tx, jlr, jmargin,
                                feature_cfg=JaxFeatureConfig(spec_aug=False))
    port = SpeakerNet(port_narrow("basic"), None, ArcMarginProduct(8, N_CLASS, 32.0))
    sd = from_jax_variables("ResNet18", variables, feat_dim=fd)
    assert not port.load_state_dict(
        {("backbone." + k if not k.startswith("projection.") else k): v for k, v in sd.items()},
        strict=True).missing_keys
    pstate = TrainState(port, make_optimizer(port, "SGD", 0.9, True, 1e-4),
                        schedulers.ExponentialDecrease(**SCHED))
    pstep = make_train_step(port, pstate.lr_schedule, schedulers.MarginSchedule(**MARGIN),
                            feature_cfg=FeaturePipelineConfig(spec_aug=False))
    rng = np.random.default_rng(7)
    batch = {"feat": (rng.standard_normal((b, t, fd)) * 2 + 5).astype(np.float32),
             "label": rng.integers(0, N_CLASS, b).astype(np.int32)}
    before = {k: v.clone() for k, v in speaker_state_dict(port).items()}
    state, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(1))
    pm = pstep(pstate, {k: T(v) for k, v in batch.items()})
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


@pytest.mark.parametrize("name", ["ResNet18", "ResNet50"])
def test_converter_matches_jax_package_export(name):
    fd = 16
    jm = getattr(jax_resnet, name)(fd, 8)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 24, fd)),
                                            train=False))
    variables = random_variables(shapes, 8)
    template = getattr(resnet, name)(fd, 8).state_dict()
    got = from_jax_variables(name, variables, feat_dim=fd)
    want = to_torch_state_dict(name, variables, template_sd=template, feat_dim=fd)
    assert set(got) == set(want) == set(template)
    for k in want:
        assert got[k].shape == template[k].shape, k
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
