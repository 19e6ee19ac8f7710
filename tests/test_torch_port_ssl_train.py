"""Port parity: self-supervised training (wespeaker_hubert_tpu_torch/ssl,
bin/train_dino, bin/train_contrastive, the SSL checkpoint layouts) against
the JAX package, at tiny widths, on numpy-seeded inputs with the features
handed in.

Tolerances (float32):
- `cosine_schedule`: 1e-6 relative (JAX evaluates it in float32, the port in
  float64);
- `DINOHead` forward and `_dino_loss`, its gradient and the InfoNCE loss:
  1e-5 x max |JAX|;
- per-tensor clipping: 1e-5 x max |JAX| on every tensor;
- the train steps (DINO with SGD and with JAX's ADAMW, MoCo, SimCLR), held
  as tests/test_torch_port_campplus.py holds CAM++'s step, against JAX and
  against the port's float64 step on the same start (the exact one): the
  loss within 1e-5 relative or twice JAX's distance from the exact loss
  (JAX's under 1e-4; after an ADAMW step, under 1e-3: `ADAM_LOSS_CAP`);
  each state's change since the start (parameters, BatchNorm statistics,
  the teacher, the centre or the queue) within 1e-4
  relative L2, or twice JAX's distance where that is more (JAX's under
  1e-2), and every tensor's change within 5 x the larger of JAX's distance
  on it and JAX's whole distance, or within 1e-4 where that is more (at
  whole distances of ~5e-7 some tensors, biases before a train-mode
  BatchNorm among them, sit 5 x from float64 on rounding alone).  The
  controls (the DINO teacher's EMA
  taken from the student before its update, MoCo's key EMA taken after the
  query update) must miss that per-tensor rule;
- `SSLPipeline`: its batches equal JAX's bit for bit.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_port_ecapa import random_variables
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from tests.torch_port_refs import FastJit, run_jax
from wespeaker_hubert_tpu.bin.train_contrastive import _Encoder as JaxEncoder
from wespeaker_hubert_tpu.bin.train_contrastive import _SimCLRState as JaxSimCLRState
from wespeaker_hubert_tpu.data.aug_store import AugStore as JaxAugStore
from wespeaker_hubert_tpu.models.ecapa_tdnn import EcapaTdnn as JaxEcapa
from wespeaker_hubert_tpu.models.tdnn import XVEC as JaxXvec
from wespeaker_hubert_tpu.ssl import contrastive as jax_contrastive
from wespeaker_hubert_tpu.ssl import dino as jax_dino
from wespeaker_hubert_tpu.ssl.dataset import SSLPipeline as JaxSSLPipeline
from wespeaker_hubert_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from wespeaker_hubert_tpu_torch.bin.tools import build_aug_store, make_raw_list, make_shard_list
from wespeaker_hubert_tpu_torch.bin.train_contrastive import _Encoder
from wespeaker_hubert_tpu_torch.bin.train_dino import train_dino
from wespeaker_hubert_tpu_torch.data.aug_store import AugStore
from wespeaker_hubert_tpu_torch.data.wav_io import write_wav
from wespeaker_hubert_tpu_torch.models.convert_jax import (
    _net_from_jax,
    dino_head_from_jax,
    dino_state_from_jax,
    load_converted_state,
    moco_state_from_jax,
)
from wespeaker_hubert_tpu_torch.models.ecapa_tdnn import EcapaTdnn
from wespeaker_hubert_tpu_torch.models.speaker_net import SpeakerNet
from wespeaker_hubert_tpu_torch.models.tdnn import XVEC
from wespeaker_hubert_tpu_torch.ssl import (
    DINOHead,
    DINONet,
    SSLPipeline,
    cosine_schedule,
    create_dino_state,
    create_moco_state,
    create_simclr_state,
    info_nce_logits,
    make_dino_optimizer,
    make_dino_train_step,
    make_moco_train_step,
    make_simclr_train_step,
)
from wespeaker_hubert_tpu_torch.ssl.dino import _dino_loss, clip_grads_per_param
from wespeaker_hubert_tpu_torch.utils.checkpoint import load_partial, load_state

T = torch.from_numpy
FD, EMB, OUT, B = 16, 8, 64, 4
TG, TL, NG, NL = 40, 20, 2, 2
MODEL = "ECAPA_TDNN_c512"  # the converter's family; the tiny EcapaTdnn below
WD = 1e-2  # large enough that a decay fault shows over float32's noise
SCHEDULES = dict(lr=(0.1, 0.01, 4, 1, 0.05), wd=(WD, WD, 4), m=(0.9, 1.0, 4),
                 t_temp=(0.04, 0.07, 2))
LOSS_REL, LOSS_CAP = 1e-5, 1e-4
# Adam's first update, lr g / (|g| + eps), is about lr sign(g): it flips at
# gradients within rounding of 0 (a bias before a train-mode BatchNorm has an
# exact gradient of 0), so after it JAX's own loss reads 1.96e-4 from float64
ADAM_LOSS_CAP = 1e-3
WHOLE_REL, WHOLE_CAP, EACH_X = 1e-4, 1e-2, 5.0


def _features(seed, shape):
    """Gaussian features with per-utterance scales and offsets."""
    rng = np.random.default_rng(seed)
    lead = shape[:-2] + (1, shape[-1])
    return (rng.standard_normal(shape) * rng.uniform(0.5, 2.0, lead)
            + rng.normal(0.0, 1.0, lead)).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


# ---------------------------------------------------------------- the rules
def _changes(after, before):
    return {k: (after[k].double() - before[k].double()).numpy().ravel()
            for k in sorted(before) if not k.endswith("num_batches_tracked")}


def _rel(a, ref):
    keys = sorted(ref)
    whole = float(np.linalg.norm(np.concatenate([a[k] - ref[k] for k in keys]))
                  / np.linalg.norm(np.concatenate([ref[k] for k in keys])))
    return whole, {k: float(np.linalg.norm(a[k] - ref[k]) / max(np.linalg.norm(ref[k]), 1e-300))
                   for k in keys}


def assert_loss_rule(got, want, exact, what, cap=LOSS_CAP):
    d_jax = abs(want - exact) / abs(exact)
    assert d_jax <= cap, f"{what}: JAX's loss {d_jax:.2e} from float64"
    for other in (want, exact):
        assert abs(got - other) / abs(exact) <= max(LOSS_REL, 2 * d_jax), (what, got, other)


def over_each(got, exact, jax_each, jax_whole):
    """The tensors whose change misses EACH_X x JAX's distance (or
    WHOLE_REL, where that is more), with their ratio to JAX's distance."""
    _, each = _rel(got, exact)
    return {k: e / max(jax_each[k], jax_whole) for k, e in each.items()
            if e > max(EACH_X * max(jax_each[k], jax_whole), WHOLE_REL)}


def assert_change_rule(got, want, exact, what):
    """`got` (the port's float32 changes), `want` (JAX's), `exact` (the
    port's float64): the module doc's rule.  Returns JAX's distances for a
    control."""
    assert set(got) == set(want) == set(exact), what
    jax_whole, jax_each = _rel(want, exact)
    assert jax_whole <= WHOLE_CAP, f"{what}: JAX {jax_whole:.2e} from float64"
    bar = max(WHOLE_REL, 2 * jax_whole)
    assert _rel(got, exact)[0] <= bar, (what, _rel(got, exact)[0], bar)
    assert _rel(got, want)[0] <= bar, (what, _rel(got, want)[0], bar)
    bad = over_each(got, exact, jax_each, jax_whole)
    assert not bad, f"{what}: {bad}"
    return jax_each, jax_whole


# ------------------------------------------------------------ the schedules
@pytest.mark.parametrize("args", [(0.1, 0.01, 20, 5, 0.02), (0.04, 0.07, 8), (0.996, 1.0, 30)])
def test_cosine_schedule_matches_jax(args):
    total = args[2]
    warm = args[3] if len(args) > 3 else 0
    jfn, pfn = jax_dino.cosine_schedule(*args), cosine_schedule(*args)
    for step in sorted({0, 1, max(warm - 1, 0), warm, warm + 1, total - 1, total, total + 3}):
        want = float(jfn(step))
        assert abs(pfn(step) - want) <= 1e-6 * max(abs(want), 1e-12), (step, pfn(step), want)


# ------------------------------------------------------------------ the head
@pytest.mark.parametrize("kw", [dict(), dict(norm_last_layer=False), dict(use_bn=True),
                                dict(nlayers=1, normalize_input=True)],
                         ids=["default", "g_trained", "use_bn", "nlayers1"])
def test_dino_head_matches_jax(kw):
    jhead = jax_dino.DINOHead(in_dim=EMB, out_dim=OUT, hidden_dim=32, bottleneck_dim=8, **kw)
    x = np.random.default_rng(3).normal(0.0, 1.0, (6, EMB)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jhead.init(jax.random.key(0), jnp.zeros((2, EMB)),
                                               train=True))
    variables = random_variables(shapes, 5)
    if "last_layer_g" in variables["params"]:
        variables["params"]["last_layer_g"] = np.random.default_rng(6).uniform(
            0.5, 1.5, OUT).astype(np.float32)
    head = DINOHead(EMB, OUT, 32, 8, **kw)
    head.load_state_dict(dino_head_from_jax(variables["params"], variables.get("batch_stats")),
                         strict=True)
    assert head.last_layer.weight_g.requires_grad == (not kw.get("norm_last_layer", True))
    for train in (False, True) if kw.get("use_bn") else (False,):
        head.train(train)
        want = run_jax(lambda v, x: jhead.apply(v, x, train=train, mutable=["batch_stats"])[0],
                       variables, x)
        got = head(T(x)).detach().numpy()
        scale = float(np.abs(np.asarray(want)).max())
        assert float(np.abs(got - np.asarray(want)).max()) <= 1e-5 * scale, train


# ------------------------------------------------------------------ the loss
def test_dino_loss_and_gradient_match_jax():
    n_s, n_t = 4, 2
    rng = np.random.default_rng(11)
    s = rng.normal(0, 1, (n_s * 3, OUT)).astype(np.float32)
    t = rng.normal(0, 1, (n_t * 3, OUT)).astype(np.float32)
    c = rng.normal(0, 0.1, (1, OUT)).astype(np.float32)
    want, want_g = run_jax(jax.value_and_grad(
        lambda s: jax_dino._dino_loss(s, t, c, n_s, n_t, 0.1, 0.05)), s)
    st = T(s).requires_grad_()
    got = _dino_loss(st, T(t), T(c), n_s, n_t, 0.1, 0.05)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want))
    scale = float(np.abs(np.asarray(want_g)).max())
    assert float(np.abs(st.grad.numpy() - np.asarray(want_g)).max()) <= 1e-5 * scale


# ---------------------------------------------------------------- the DINO step
def _jax_dino_net():
    return jax_dino.DINONet(backbone=JaxEcapa(16, FD, EMB, "ASTP", False),
                            head=jax_dino.DINOHead(EMB, OUT, hidden_dim=32, bottleneck_dim=8))


def _port_dino_net():
    return DINONet(EcapaTdnn(16, FD, EMB, "ASTP", False), DINOHead(EMB, OUT, 32, 8))


def _schedules(fn):
    return {f"{k}_schedule" if k != "t_temp" else "teacher_temp_schedule": fn(*v)
            for k, v in (("lr", SCHEDULES["lr"]), ("wd", SCHEDULES["wd"]),
                         ("momentum", SCHEDULES["m"]), ("t_temp", SCHEDULES["t_temp"]))}


@functools.lru_cache(maxsize=1)
def _dino_start():
    """The start of the DINO steps: JAX variables of the student and of the
    teacher, seeded apart, and a non-zero centre."""
    shapes = jax.eval_shape(lambda: _jax_dino_net().init(
        jax.random.key(0), jnp.zeros((2, TG, FD)), train=True))
    student, teacher = random_variables(shapes, 20), random_variables(shapes, 21)
    center = np.random.default_rng(22).normal(0.0, 0.1, (1, OUT)).astype(np.float32)
    return student, teacher, center


def _port_dino_state(converted, dtype, optimizer):
    net = _port_dino_net().to(dtype)
    state = create_dino_state(net, OUT, optimizer)
    state.teacher.to(dtype)
    state.center = state.center.to(dtype)
    load_converted_state(state, converted)
    for name in ("student", "teacher"):  # load_state_dict keeps each tensor's dtype
        getattr(state, name).to(dtype)
    return state


def _snapshot(state):
    sd = {f"{name}.{k}": v.detach().double().clone()
          for name in ("student", "teacher")
          for k, v in getattr(state, name).state_dict().items()}
    sd["center"] = state.center.detach().double().clone()
    return sd


def _jax_snapshot(state):
    """A JAX DINOState's student, teacher and centre in the port's names."""
    sd = {}
    for name, params, stats in (("student", state.student_params, state.batch_stats),
                                ("teacher", state.teacher_params, state.teacher_batch_stats)):
        sd.update({f"{name}.{k}": v.double()
                   for k, v in _net_from_jax(MODEL, params, stats, FD, head=True).items()})
    sd["center"] = torch.from_numpy(np.asarray(state.center, np.float64))
    return sd


def _sgd_or_adam():
    """JAX's SGD (optax.trace(0.9)) or its ADAMW (optax.scale_by_adam()), by
    a flag in the optimizer state, so that one compiled JAX step serves both
    paths.  The step then takes JAX's unfused update (trace_decay None), the
    same arithmetic as its fused SGD path: (g + wd p) + 0.9 m, times -lr."""
    sgd, adam = optax.trace(decay=0.9), optax.scale_by_adam()

    def init(params):
        return sgd.init(params), adam.init(params), jnp.zeros((), bool)

    def update(updates, state, params=None):
        u_sgd, s_sgd = sgd.update(updates, state[0], params)
        u_adam, s_adam = adam.update(updates, state[1], params)
        pick = jax.tree.map(lambda a, b: jnp.where(state[2], b, a), u_sgd, u_adam)
        return pick, (s_sgd, s_adam, state[2])

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def jax_dino_runs():
    """The start (as a JAX DINOState per optimizer), the two batches, and
    two steps of JAX's compiled DINO step on each optimizer path."""
    student, teacher, center = _dino_start()
    tx = _sgd_or_adam()
    batches = [{"global_feat": _features(30 + i, (B, NG, TG, FD)),
                "local_feat": _features(40 + i, (B, NL, TL, FD))} for i in range(2)]
    jstep = FastJit(jax_dino.make_dino_train_step(
        _jax_dino_net(), tx, n_global=NG, n_local=NL, freeze_last_layer_steps=1,
        **_schedules(jax_dino.cosine_schedule)))
    runs = {}
    for i, optimizer in enumerate(("SGD", "ADAMW")):
        s_sgd, s_adam, _ = tx.init(jnp_tree(student["params"]))
        jstate = jax_dino.DINOState(
            step=jnp.zeros((), jnp.int32), student_params=jnp_tree(student["params"]),
            teacher_params=jnp_tree(teacher["params"]),
            batch_stats=jnp_tree(student["batch_stats"]),
            teacher_batch_stats=jnp_tree(teacher["batch_stats"]), center=jnp.asarray(center),
            opt_state=(s_sgd, s_adam, jnp.asarray(bool(i))))
        start = dino_state_from_jax(
            MODEL, _np_tree(jstate.replace(opt_state=jstate.opt_state[i])), feat_dim=FD)
        losses, snaps = [], []
        for b in batches:
            jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                              jax.random.key(0))
            host = _np_tree(jstate)  # the next call donates jstate's buffers
            jstate = jnp_tree(host)
            losses.append(float(m["loss"]))
            snaps.append(_jax_snapshot(host))
        runs[optimizer] = (start, losses, snaps)
    return batches, runs


@pytest.fixture(scope="module", params=["SGD", "ADAMW"])
def dino_run(request, jax_dino_runs):
    """Two steps (the first inside the last layer's freeze) of JAX's DINO
    step and of the port's, float32 and float64, and the control, from one
    start."""
    optimizer = request.param
    batches, runs = jax_dino_runs
    start, jax_losses, jax_snaps = runs[optimizer]

    def port_run(dtype, control=False):
        state = _port_dino_state(start, dtype, optimizer)
        before = _snapshot(state)
        sched = _schedules(cosine_schedule)
        if control:
            sched["momentum_schedule"] = lambda step: 1.0
        step = make_dino_train_step(n_global=NG, n_local=NL, freeze_last_layer_steps=1, **sched)
        losses, snaps, metrics = [], [], []
        for b in batches:
            if control:  # the teacher's EMA from the student before its update
                m = cosine_schedule(*SCHEDULES["m"])(state.step)
                s_before = {k: p.detach().clone() for k, p in state.student.named_parameters()
                            if p.requires_grad}
            out = step(state, {k: T(v).to(dtype) for k, v in b.items()})
            if control:
                with torch.no_grad():
                    for k, p in state.teacher.named_parameters():
                        if k in s_before:
                            p.copy_(p * m + s_before[k] * (1.0 - m))
            losses.append(float(out["loss"]))
            metrics.append(out)
            snaps.append(_snapshot(state))
        return before, losses, snaps, metrics

    before, p_losses, p_snaps, p_metrics = port_run(torch.float32)
    _, e_losses, e_snaps, _ = port_run(torch.float64)
    _, _, c_snaps, _ = port_run(torch.float32, control=True)
    return dict(optimizer=optimizer, before=before, jax=(jax_losses, jax_snaps),
                port=(p_losses, p_snaps), exact=(e_losses, e_snaps), control=c_snaps,
                metrics=p_metrics, start=start)


def jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("step", [0, 1], ids=["frozen", "after_freeze"])
def test_dino_step_matches_jax(dino_run, step):
    """The loss, the student (parameters and BatchNorm statistics), the
    teacher (the EMA of the updated student, and its own statistics) and
    the centre after each step, by the module doc's rules; the control (the
    EMA from the student before its update) misses the per-tensor rule."""
    r = dino_run
    before = r["before"]
    assert_loss_rule(r["port"][0][step], r["jax"][0][step], r["exact"][0][step],
                     f"{r['optimizer']} loss {step}",
                     LOSS_CAP if r["optimizer"] == "SGD" else ADAM_LOSS_CAP)
    got = _changes(r["port"][1][step], before)
    want = _changes(r["jax"][1][step], before)
    exact = _changes(r["exact"][1][step], before)
    jax_each, jax_whole = assert_change_rule(got, want, exact, f"{r['optimizer']} step {step}")
    teacher = [k for k in exact if k.startswith("teacher.") and "running" not in k]
    control = _changes(r["control"][step], before)
    missed = over_each({k: control[k] for k in teacher}, {k: exact[k] for k in teacher},
                       jax_each, jax_whole)
    assert missed, "the control (teacher EMA before the student update) passed the bar"


def test_dino_freeze_moves_last_layer_by_decay_and_momentum(dino_run):
    """Inside the freeze the last layer's gradient is zero, so the first
    step moves it by the decayed weight alone: SGD by -lr wd p (the first
    momentum buffer is wd p), JAX's ADAMW by Adam's first update of wd p,
    -lr wd p / (|wd p| + eps).  After the freeze the gradient enters, and
    the closed form no longer holds.  The schedules' values are the step's."""
    r = dino_run
    key = "student.head.last_layer.weight_v"
    p0 = r["before"][key]
    lr0, lr1 = (cosine_schedule(*SCHEDULES["lr"])(i) for i in (0, 1))
    assert r["metrics"][0]["lr"] == lr0 and r["metrics"][0]["wd"] == WD
    moved = r["port"][1][0][key] - p0
    # the update is rounded to float32 once: within one spacing of |p|
    # (Adam's square root and division: 1e-5 of the update besides)
    spacing = torch.finfo(torch.float32).eps * p0.abs()
    p1 = r["port"][1][0][key]
    if r["optimizer"] == "SGD":
        want = -lr0 * WD * p0
        closed = p1 - lr1 * (WD * p1 + 0.9 * WD * p0)
    else:
        want = -lr0 * WD * p0 / (WD * p0.abs() + 1e-8)
        closed = None
    assert bool(((moved - want).abs() <= spacing + 1e-5 * want.abs()).all())
    assert torch.equal(r["port"][1][0]["student.head.last_layer.weight_g"],
                       torch.ones_like(p0[:, :1]))
    if closed is not None:
        assert not torch.allclose(r["port"][1][1][key], closed, rtol=1e-4, atol=0)


def test_clip_grads_per_param_matches_jax():
    """JAX's per-tensor clipping against the port's on converted gradients,
    tensor by tensor: the port's trainable tensors partition the
    parameters exactly as flax's leaves (one-to-one names)."""
    student, _, _ = _dino_start()
    rng = np.random.default_rng(50)
    grads = jax.tree.map(lambda x: (rng.standard_normal(x.shape)
                                    * rng.choice([1e-3, 0.3, 10.0])).astype(np.float32),
                         student["params"])
    want = _np_tree(run_jax(lambda g: jax_dino._clip_grads_per_param(g, 3.0), grads))
    got = _net_from_jax(MODEL, grads, {}, FD, head=True)
    want = _net_from_jax(MODEL, want, {}, FD, head=True)
    net = _port_dino_net()
    trainable = {k for k, p in net.named_parameters() if p.requires_grad}
    assert set(got) - {"head.last_layer.weight_g"} == trainable
    assert len(jax.tree.leaves(grads)) == len(trainable)
    names = sorted(trainable)
    tensors = [got[k] for k in names]
    clip_grads_per_param(tensors, 3.0)
    n_clipped = 0
    for k, g in zip(names, tensors):
        scale = float(want[k].abs().max())
        assert float((g - want[k]).abs().max()) <= 1e-5 * scale, k
        n_clipped += float(got[k].norm()) > 3.0
    assert 0 < n_clipped < len(names)


def test_lars_refused_and_jax_lars_climbs(tmp_path):
    """The port refuses LARS (make_dino_optimizer and bin/train_dino before
    any data).  JAX's: optax.lars(1.0) already negates, and the step scales
    by -lr again, so one step moves along +g: it points against SGD's."""
    with pytest.raises(NotImplementedError, match="LARS"):
        make_dino_optimizer([torch.nn.Parameter(torch.zeros(2))], "LARS")
    with pytest.raises(NotImplementedError, match="LARS"):
        train_dino({"model": "ECAPA_TDNN_c512", "model_args": {"feat_dim": FD, "embed_dim": EMB},
                    "dino_args": {"out_dim": OUT, "hidden_dim": 16, "bottleneck_dim": 8},
                    "optimizer": "LARS", "train_data": str(tmp_path / "absent.list"),
                    "exp_dir": str(tmp_path / "exp")}, device="cpu")

    import flax.linen as nn

    class Tiny(nn.Module):
        @nn.compact
        def __call__(self, x, train=False):
            return nn.Dense(EMB)(x.mean(1))

    net = jax_dino.DINONet(backbone=Tiny(), head=jax_dino.DINOHead(EMB, 16, hidden_dim=16,
                                                                    bottleneck_dim=8))
    params = random_variables(jax.eval_shape(lambda: net.init(
        jax.random.key(0), jnp.zeros((2, 10, FD)))), 62)["params"]
    batch = {"global_feat": jnp.asarray(_features(60, (4, 2, 10, FD))),
             "local_feat": jnp.asarray(_features(61, (4, 2, 6, FD)))}
    moves = {}
    # the SGD probe is the trainer's tx (no lr, no sign): its step moves along -g
    for name, tx in (("sgd", optax.trace(decay=0.9)), ("lars", optax.lars(learning_rate=1.0))):
        state = jax_dino.DINOState(
            step=jnp.zeros((), jnp.int32), student_params=jnp_tree(params),
            teacher_params=jnp_tree(params), batch_stats={},
            teacher_batch_stats={}, center=jnp.zeros((1, 16)), opt_state=tx.init(jnp_tree(params)))
        const = lambda v: (lambda step: v)  # noqa: E731
        step = FastJit(jax_dino.make_dino_train_step(
            net, tx, const(0.1), const(0.0), const(0.996), const(0.04), n_global=2, n_local=2,
            clip_grad=1e9))
        new, _ = step(state, batch, jax.random.key(0))
        moves[name] = np.concatenate([np.ravel(a - b) for a, b in zip(
            jax.tree.leaves(new.student_params), jax.tree.leaves(params))])
    # SGD moves along -g; JAX's LARS along +g
    assert float(moves["sgd"] @ moves["lars"]) < 0


# ------------------------------------------------------ MoCo and SimCLR
def _jax_encoder():
    return JaxEncoder(backbone=JaxXvec(feat_dim=FD, hid_dim=16, stats_dim=24, embed_dim=EMB))


def _port_encoder():
    return _Encoder(XVEC(feat_dim=FD, hid_dim=16, stats_dim=24, embed_dim=EMB))


def _encoder_start(seed):
    shapes = jax.eval_shape(lambda: _jax_encoder().init(jax.random.key(0), jnp.zeros((2, TG, FD)),
                                                        train=True))
    return random_variables(shapes, seed)


def _enc_sd(sd, prefix):
    return {f"{prefix}.{k}": v.detach().double().clone() for k, v in sd.items()}


MOCO = dict(K=16, m=0.9, T=0.07, lr=0.05)


@pytest.fixture(scope="module")
def moco_run():
    q, k = _encoder_start(70), _encoder_start(71)
    tx = optax.sgd(MOCO["lr"], momentum=0.9, nesterov=True)
    queue = np.asarray(jax_contrastive._l2(jax.random.normal(jax.random.key(7), (MOCO["K"], EMB))))
    jstate = jax_contrastive.MoCoState(
        step=jnp.zeros((), jnp.int32), params_q=jnp_tree(q["params"]),
        params_k=jnp_tree(k["params"]), batch_stats_q=jnp_tree(q["batch_stats"]),
        batch_stats_k=jnp_tree(k["batch_stats"]), queue=jnp.asarray(queue),
        queue_ptr=jnp.zeros((), jnp.int32), opt_state=tx.init(jnp_tree(q["params"])))
    start = moco_state_from_jax("XVEC", _np_tree(jstate), feat_dim=FD)
    batches = [{"query_feat": _features(80 + i, (B, TG, FD)),
                "key_feat": _features(90 + i, (B, TG, FD))} for i in range(2)]
    jstep = FastJit(jax_contrastive.make_moco_train_step(_jax_encoder(), tx, m=MOCO["m"],
                                                         T=MOCO["T"]))
    jax_out = []
    for b in batches:
        jstate, m = jstep(jstate, {n: jnp.asarray(v) for n, v in b.items()}, jax.random.key(0))
        jstate = jnp_tree(_np_tree(jstate))
        conv = moco_state_from_jax("XVEC", _np_tree(jstate), feat_dim=FD)
        jax_out.append((float(m["loss"]), float(m["acc"]), conv))

    def port_run(dtype, control=False):
        state = create_moco_state(_port_encoder().to(dtype), EMB, K=MOCO["K"], lr=MOCO["lr"],
                                  nesterov=True)
        state.encoder_k.to(dtype)
        state.queue = state.queue.to(dtype)
        load_converted_state(state, start)
        for enc in (state.encoder_q, state.encoder_k):
            enc.to(dtype)
        step = make_moco_train_step(m=1.0 if control else MOCO["m"], T=MOCO["T"])
        out = []
        for b in batches:
            metrics = step(state, {n: T(v).to(dtype) for n, v in b.items()})
            if control:  # the key EMA after the query update
                with torch.no_grad():
                    for pk, pq in zip(state.encoder_k.parameters(), state.encoder_q.parameters()):
                        pk.copy_(pk * MOCO["m"] + pq * (1.0 - MOCO["m"]))
            out.append((float(metrics["loss"]), float(metrics["acc"]), {
                "encoder_q": {n: v.clone() for n, v in state.encoder_q.state_dict().items()},
                "encoder_k": {n: v.clone() for n, v in state.encoder_k.state_dict().items()},
                "queue": state.queue.clone(), "queue_ptr": state.queue_ptr}))
        return out

    return dict(start=start, jax=jax_out, port=port_run(torch.float32),
                exact=port_run(torch.float64), control=port_run(torch.float32, control=True))


def _moco_flat(s):
    sd = _enc_sd(s["encoder_q"], "q")
    sd.update(_enc_sd(s["encoder_k"], "k"))
    sd["queue"] = s["queue"].double()
    return sd


@pytest.mark.parametrize("step", [0, 1])
def test_moco_step_matches_jax(moco_run, step):
    """Loss, accuracy, the pointer, the queue and both encoders (parameters
    and statistics) after each step; the control (the key EMA after the
    query update) misses the per-tensor rule."""
    r = moco_run
    before = _moco_flat(r["start"])
    (pl, pa, ps), (jl, ja, js), (el, _, es) = r["port"][step], r["jax"][step], r["exact"][step]
    assert_loss_rule(pl, jl, el, f"moco loss {step}")
    assert pa == ja
    assert ps["queue_ptr"] == js["queue_ptr"] == (step + 1) * B % MOCO["K"]
    got, want, exact = (_changes(_moco_flat(s), before) for s in (ps, js, es))
    jax_each, jax_whole = assert_change_rule(got, want, exact, f"moco step {step}")
    keys = [k for k in exact if k.startswith("k.") and "running" not in k]
    control = _changes(_moco_flat(r["control"][step][2]), before)
    assert over_each({k: control[k] for k in keys}, {k: exact[k] for k in keys},
                     jax_each, jax_whole), "the control (EMA after the update) passed"


def test_simclr_step_matches_jax():
    start = _encoder_start(100)
    tx = optax.sgd(0.05, momentum=0.9)
    jstate = JaxSimCLRState(step=jnp.zeros((), jnp.int32), params=jnp_tree(start["params"]),
                            batch_stats=jnp_tree(start["batch_stats"]),
                            opt_state=tx.init(jnp_tree(start["params"])))
    b = {"query_feat": _features(101, (B, TG, FD)), "key_feat": _features(102, (B, TG, FD))}
    jstep = FastJit(jax_contrastive.make_simclr_train_step(_jax_encoder(), tx, T=0.07))
    jnew, m = jstep(jstate, {n: jnp.asarray(v) for n, v in b.items()}, jax.random.key(0))
    conv = _net_from_jax("XVEC", _np_tree(start["params"]), _np_tree(start["batch_stats"]), FD,
                         head=False)
    want_sd = _net_from_jax("XVEC", _np_tree(jnew.params), _np_tree(jnew.batch_stats), FD,
                            head=False)

    def port(dtype):
        state = create_simclr_state(_port_encoder(), lr=0.05)
        state.encoder.load_state_dict(conv, strict=True)
        state.encoder.to(dtype)
        metrics = make_simclr_train_step(T=0.07)(state, {n: T(v).to(dtype) for n, v in b.items()})
        return float(metrics["loss"]), float(metrics["acc"]), state.encoder.state_dict()

    (pl, pa, psd), (el, _, esd) = port(torch.float32), port(torch.float64)
    assert_loss_rule(pl, float(m["loss"]), el, "simclr loss")
    assert pa == float(m["acc"])
    before = {k: v.double() for k, v in conv.items()}
    assert_change_rule(_changes(psd, before), _changes(want_sd, before),
                       _changes(esd, before), "simclr step")


def test_info_nce_matches_jax():
    """The loss, accuracy and feature gradient of InfoNCE on random
    features (the order of the negatives does not enter them)."""
    feats = np.random.default_rng(110).normal(0, 1, (2 * 6, EMB)).astype(np.float32)

    def jloss(f):
        logits, labels = jax_contrastive.info_nce_logits(f, 2, 0.07)
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
        return loss, jnp.mean(jnp.argmax(logits, axis=1) == 0)

    (want, want_acc), want_g = run_jax(jax.value_and_grad(jloss, has_aux=True), feats)
    f = T(feats).requires_grad_()
    logits, labels = info_nce_logits(f, 2, 0.07)
    loss = torch.nn.functional.cross_entropy(logits, labels)
    loss.backward()
    assert abs(float(loss.detach()) - float(want)) <= 1e-5 * abs(float(want))
    assert float((logits.argmax(1) == 0).float().mean()) == float(want_acc)
    scale = float(np.abs(np.asarray(want_g)).max())
    assert float(np.abs(f.grad.numpy() - np.asarray(want_g)).max()) <= 1e-5 * scale


# ------------------------------------------------------------ SSLPipeline
@pytest.fixture(scope="module")
def ssl_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("ssl_data")
    rng = np.random.default_rng(120)
    lines, scp, u2s = [], [], []
    for i in range(10):
        n = int(rng.integers(12000, 40000))
        path = str(root / f"u{i}.wav")
        write_wav(path, (0.1 * rng.standard_normal(n)).astype(np.float32))
        lines.append(json.dumps({"key": f"u{i}", "wav": path, "spk": f"s{i % 3}"}))
        scp.append(f"u{i} {path}")
        u2s.append(f"u{i} s{i % 3}")
    (root / "wav.scp").write_text("\n".join(scp) + "\n")
    (root / "utt2spk").write_text("\n".join(u2s) + "\n")
    make_shard_list(str(root / "wav.scp"), str(root / "utt2spk"), str(root / "shards"),
                    str(root / "shard.list"), num_utts_per_shard=4)
    for sub, kind, n, length in (("musan", "noise", 3, 8000), ("rirs", "rir", 2, 600)):
        scp = []
        for i in range(n):
            x = rng.standard_normal(length) * (0.1 if sub == "musan" else
                                               np.exp(-np.arange(length) / 100))
            path = str(root / f"{sub}-{i}.wav")
            write_wav(path, x.astype(np.float32))
            scp.append(f"{kind}-{i} {path}")
        (root / f"{sub}.scp").write_text("\n".join(scp) + "\n")
        build_aug_store(str(root / f"{sub}.scp"), str(root / f"{sub}_store"))
    return root, lines


@pytest.mark.parametrize("data_type,local_num", [("raw", 3), ("raw", 0), ("shard", 3)])
def test_ssl_pipeline_batches_equal_jax(ssl_data, data_type, local_num):
    root, lines = ssl_data
    if data_type == "shard":
        lines = (root / "shard.list").read_text().split()
    kw = dict(data_type=data_type, global_frames=30, global_num=2, local_frames=15,
              local_num=local_num, batch_size=3, aug_prob=0.7, shuffle_size=4, min_frames=90,
              seed=5)
    for epoch in (0, 1):
        pipes = []
        for cls, store in ((JaxSSLPipeline, JaxAugStore), (SSLPipeline, AugStore)):
            p = cls(lines, reverb_store=store(root=str(root / "rirs_store")),
                    noise_store=store(root=str(root / "musan_store")), **kw)
            p.set_epoch(epoch)
            pipes.append(list(p))
        want, got = pipes
        assert len(got) == len(want) >= 2
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
        assert got[0]["local_wav"].shape == (3, local_num, 160 * 14 + 400)
        assert any((b["global_aug_type"] > 0).any() for b in got)


# ------------------------------------------------ JAX SSL checkpoints
def test_load_state_takes_both_jax_dino_layouts(tmp_path):
    """bin/train_dino.py nests the teacher's statistics under `backbone`;
    examples/voxceleb/v3/dino/run.py writes them flat: load_state gives
    the same state_dict for both, statistics included.  Flat statistics of
    other modules are refused, and load_partial refuses parameters without
    their statistics."""
    student, _, _ = _dino_start()
    bb, stats = student["params"]["backbone"], student["batch_stats"]["backbone"]
    layouts = {"nested": {"params": {"backbone": bb}, "batch_stats": {"backbone": stats}},
               "flat": {"params": {"backbone": bb}, "batch_stats": stats},
               "foreign": {"params": {"backbone": bb}, "batch_stats": {"elsewhere": stats["bn"]}},
               "no_stats": {"params": {"backbone": bb}, "batch_stats": {}}}
    for name, tree in layouts.items():
        jax_save_checkpoint(str(tmp_path / f"{name}.ckpt"), tree)
    nested = load_state(str(tmp_path / "nested.ckpt"), MODEL, FD)
    flat = load_state(str(tmp_path / "flat.ckpt"), MODEL, FD)
    assert sorted(nested) == sorted(flat)
    assert all(torch.equal(nested[k], flat[k]) for k in nested)
    assert np.array_equal(nested["bn.running_var"].numpy(), stats["bn"]["var"])
    with pytest.raises(ValueError, match="batch_stats"):
        load_state(str(tmp_path / "foreign.ckpt"), MODEL, FD)
    net = SpeakerNet(EcapaTdnn(16, FD, EMB, "ASTP", False))
    assert load_partial(str(tmp_path / "flat.ckpt"), net, MODEL) == ([], [])
    with pytest.raises(ValueError, match="statistics"):
        load_partial(str(tmp_path / "no_stats.ckpt"), net, MODEL)


# ------------------------------------------------ the recipes at tiny width
TINY = ["model_args.feat_dim=16", "model_args.embed_dim=8",
        "dataset_args.fbank_args.num_mel_bins=16", "dataloader_args.batch_size=4",
        "num_epochs=1", "epoch_iter=2", "save_epoch_interval=1", "num_avg=1",
        "log_batch_interval=1"]


@pytest.fixture(scope="module")
def ssl_recipe_data(tmp_path_factory):
    """write_recipe_data's wavs (12 training utterances over 4 speakers, 8
    eval) with aug stores, also laid out as CN-Celeb's `cnceleb_train` and
    `eval` with the recipe's two trial files."""
    from tests.test_torch_port_recipe import _write_recipe_data

    data = tmp_path_factory.mktemp("ssl_recipe") / "data"
    _write_recipe_data(data, n_train=12)
    for src, dst in (("musan", "musan_aug_store"), ("rirs", "rirs_aug_store")):
        build_aug_store(str(data / src / "wav.scp"), str(data / dst))
    d = data / "vox2_dev"
    make_raw_list(str(d / "wav.scp"), str(d / "utt2spk"), str(d / "raw.list"))
    for src, dst in (("vox2_dev", "cnceleb_train"), ("vox1", "eval")):
        (data / dst).mkdir()
        for name in ("wav.scp", "utt2spk"):
            (data / dst / name).write_text((data / src / name).read_text())
    (data / "eval" / "trials").mkdir()
    trials = (data / "vox1" / "trials.kaldi").read_text().splitlines()
    for name, part in (("CNC-Eval-Concat.lst", trials[::2]), ("CNC-Eval-Avg.lst", trials[1::2])):
        (data / "eval" / "trials" / name).write_text("\n".join(part) + "\n")
    return data


def _stores(data):
    return [f"dataset_args.reverb_data={data / 'rirs_aug_store'}",
            f"dataset_args.noise_data={data / 'musan_aug_store'}"]


@pytest.mark.parametrize("recipe", ["dino_cnceleb", "moco", "simclr"])
def test_ssl_recipe_on_cpu(recipe, ssl_recipe_data, tmp_path, capsys):
    """DINO (bin/train_dino, 1 epoch of 2 steps) then the CN-Celeb fine-tune
    stages 2-6 from its averaged teacher (load_partial: the head alone
    missing); MoCo's and SimCLR's stages 2-6 on the v3 configs.  Every
    stage runs, stages 5-6 print each trial file's EER, the embeddings are
    finite.  ECAPA_TDNN_GLOB_c512 at 16 mels, batch 4, 50-frame chunks."""
    from wespeaker_hubert_tpu_torch.bin.average_model import average_model
    from wespeaker_hubert_tpu_torch.models.speaker_net import build_speaker_net
    from wespeaker_hubert_tpu_torch.recipes import cnceleb_v3_finetune, voxceleb_v3_contrastive
    from wespeaker_hubert_tpu_torch.utils.config import apply_overrides, load_config
    from wespeaker_hubert_tpu_torch.utils.embeddings import load_embeddings

    data = ssl_recipe_data
    if recipe == "dino_cnceleb":
        dino_exp = tmp_path / "dino"
        state = train_dino(apply_overrides({
            "exp_dir": str(dino_exp), "train_data": str(data / "vox2_dev" / "raw.list"),
            "model": "ECAPA_TDNN_GLOB_c512", "model_args": {}, "dataset_args": {
                "global_chunk_len": 50, "local_chunk_len": 30, "local_chunk_num": 2},
            "dino_args": {"out_dim": 64, "hidden_dim": 16, "bottleneck_dim": 8}},
            TINY + _stores(data)), device="cpu")
        assert state.step == 2
        avg = average_model(str(dino_exp / "models"), str(dino_exp / "avg_model.pt"), num=1)
        config = load_config(cnceleb_v3_finetune.parse_args([]).config)
        overrides = ["model=ECAPA_TDNN_GLOB_c512", "dataset_args.num_frms=50"] + TINY
        net = build_speaker_net(apply_overrides(config, overrides), num_class=12)
        assert load_partial(avg, net, "ECAPA_TDNN_GLOB_c512") == (["projection.weight"], [])
        done = cnceleb_v3_finetune.main(
            ["--stage", "2", "--stop_stage", "6", "--model_init", avg, "--data_root", str(data),
             "--device", "cpu", f"exp_dir={tmp_path / 'ft'}",
             f"train_data={data / 'cnceleb_train' / 'raw.list'}",
             f"train_label={data / 'cnceleb_train' / 'utt2spk'}"] + _stores(data) + overrides)
        exp, files, eval_set = tmp_path / "ft", ("CNC-Eval-Concat.lst", "CNC-Eval-Avg.lst"), "eval"
    else:
        done = voxceleb_v3_contrastive.main(
            ["--method", recipe, "--stage", "2", "--stop_stage", "6", "--data_root", str(data),
             "--trials", str(data / "vox1" / "trials.kaldi"), "--device", "cpu",
             f"exp_dir={tmp_path / recipe}", f"train_data={data / 'vox2_dev' / 'raw.list'}",
             "dataset_args.chunk_len=50", "moco_args.K=16"] + _stores(data) + TINY)
        exp, files, eval_set = tmp_path / recipe, ("trials.kaldi",), "vox1"
    out = capsys.readouterr().out
    assert sorted(done) == [2, 3, 4, 5, 6]
    for f in files:
        assert out.count(f"{f}.score: EER ") == 1 and out.count(f"{f}.score.asnorm: EER ") == 1
    _, emb = load_embeddings(str(exp / "embeddings" / f"{eval_set}.npz"))
    assert emb.shape == (8, 8) and np.isfinite(emb).all()
