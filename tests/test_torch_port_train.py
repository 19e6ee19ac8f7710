"""Port parity: the SSL joint fine-tuning slice (bin/train) against the JAX
package.

K2's plain backward against the JAX package's `_flash_mha` differentiated
through the Pallas backward kernels (interpret mode) and against autograd;
the augmentation ops; `TrainPipeline` batches; SpecAugment; schedulers and
the SGD update; the train-mode BatchNorm; and `bin/train.train` end to end
with a resume (tests/test_torch_port_train_step.py holds two
`make_train_step` steps against JAX's).  Inputs come from numpy seeds.

Tolerances: K2's backward atol 1e-5 / rtol 1e-4 against the Pallas kernels
(float32, sums in another order); augmentation atol 1e-5; batches and masks
bit-identical; schedules rtol 1e-6 (both in float32); SGD updates and
BatchNorm statistics atol 1e-6 / rtol 1e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from wespeaker_hubert_tpu.data import AugStore as JaxAugStore
from wespeaker_hubert_tpu.data import TrainPipeline as JaxTrainPipeline
from wespeaker_hubert_tpu.data import TrainPipelineConfig as JaxPipelineConfig
from wespeaker_hubert_tpu.data import write_wav
from wespeaker_hubert_tpu.frontend.ssl_encoder import _flash_mha
from wespeaker_hubert_tpu.models.norm import BatchNorm as JaxBatchNorm
from wespeaker_hubert_tpu.ops import augment as jax_augment
from wespeaker_hubert_tpu.ops.feature_utils import spec_aug as jax_spec_aug
from wespeaker_hubert_tpu.train import schedulers as jax_sched
from wespeaker_hubert_tpu.train.state import make_optimizer as jax_make_optimizer
from wespeaker_hubert_tpu_torch.bin.extract import extract
from wespeaker_hubert_tpu_torch.bin.train import train
from wespeaker_hubert_tpu_torch.data.aug_store import AugStore
from wespeaker_hubert_tpu_torch.data.dataset import TrainPipeline, TrainPipelineConfig
from wespeaker_hubert_tpu_torch.models.norm import BatchNorm1d
from wespeaker_hubert_tpu_torch.ops import augment
from wespeaker_hubert_tpu_torch.ops import flash_attention as k2
from wespeaker_hubert_tpu_torch.ops.feature_utils import apply_spec_aug, spec_aug_masks
from wespeaker_hubert_tpu_torch.train import schedulers
from wespeaker_hubert_tpu_torch.train.state import TrainState, freeze_paths, make_optimizer

T = torch.from_numpy


def _randomize(tree, rng):
    """Numpy draws for a flax variable tree (as tests/test_torch_port_ssl.py)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
            continue
        shape = np.shape(v)
        if k in ("kernel", "weight"):
            x = rng.normal(0.0, float(np.prod(shape[:-1])) ** -0.5, shape)
        elif k in ("scale", "var", "gru_rel_pos_const"):
            x = rng.uniform(0.5, 1.5, shape)
        elif k in ("rel_attn_embed", "featurizer_weights"):
            x = rng.normal(0.0, 0.5, shape)
        else:  # bias, mean
            x = rng.normal(0.0, 0.1, shape)
        out[k] = x.astype(np.float32)
    return out


# ------------------------------------------------------------ K2 backward
@pytest.mark.parametrize("case", ["full_bias_T75", "bias_and_padding_T150", "no_bias_T75"])
def test_flash_bwd_plain_matches_jax_pallas_bwd(case):
    """flash_attention_bwd_reference against jax.vjp of `_flash_mha`, which
    runs the Pallas backward kernels (_flash_attention_bwd_dkv / _dq) in
    interpret mode.  With padding JAX gets a -1e9 bias, the port key_len;
    with no bias JAX pads T to 128 through SegmentIds."""
    t = 150 if "T150" in case else 75
    rng = np.random.default_rng(40 + t)
    q, k, v, dout = (rng.standard_normal((2, t, 2, 64)).astype(np.float32) for _ in range(4))
    bias = rng.standard_normal((2, 2, t, t)).astype(np.float32)
    key_len = None
    ab = bias
    if case == "bias_and_padding_T150":
        key_len = np.array([t, 97], np.int32)
        pad = np.where(np.arange(t)[None, :] < key_len[:, None], 0.0, -1e9).astype(np.float32)
        ab = bias + pad[:, None, None, :]
    elif case == "no_bias_T75":
        bias = ab = None
    with pltpu.force_tpu_interpret_mode():
        if ab is None:
            _, vjp = jax.vjp(lambda a, b, c: _flash_mha(a, b, c, None, 0.125), q, k, v)
            want = (*vjp(jnp.asarray(dout)), None)
        else:
            _, vjp = jax.vjp(lambda a, b, c, d: _flash_mha(a, b, c, d, 0.125), q, k, v, ab)
            want = vjp(jnp.asarray(dout))
    tb = None if bias is None else T(bias)
    tl = None if key_len is None else T(key_len)
    out, lse = k2.flash_attention_reference(T(q), T(k), T(v), tb, tl, 0.125, return_lse=True)
    got = k2.flash_attention_bwd_reference(T(q), T(k), T(v), tb, tl, 0.125, out, lse, T(dout))
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("case", ["f32", "bf16", "broadcast_bias_f32"])
def test_flash_function_matches_autograd(case):
    """The Function's plain backward (CPU tensors) against torch.autograd
    through flash_attention_reference.  bf16: cosine >= 0.999 per gradient
    (the plain forward rounds P to bf16 before P V, the backward keeps
    float32 algebra until its outputs)."""
    rng = np.random.default_rng(9)
    b, t, h = 2, 33, 3
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    q, k, v, g = (T(rng.standard_normal((b, t, h, 64)).astype(np.float32)).to(dtype)
                  for _ in range(4))
    shape = (b, 1, 1, t) if case.startswith("broadcast") else (b, h, t, t)
    bias = T(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    key_len = torch.tensor([t, 20])
    leaves = [x.clone().requires_grad_() for x in (q, k, v, bias)]
    got = torch.autograd.grad(k2.flash_attention(*leaves, key_len=key_len), leaves, g)
    ref = [x.clone().requires_grad_() for x in (q, k, v, bias)]
    want = torch.autograd.grad(k2.flash_attention_reference(*ref, key_len=key_len), ref, g)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        if dtype == torch.float32:
            torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-4, msg=name)
        else:
            cos = torch.nn.functional.cosine_similarity(a.float().flatten(), w.float().flatten(), 0)
            assert float(cos) >= 0.999, (name, float(cos))


@pytest.mark.parametrize("with_len", [False, True], ids=["full", "key_len"])
def test_flash_function_factored_bias_grads(with_len):
    """WavLM's gated bias in factored form: the Function's plain backward
    returns the (h, T, T) table's and the (B, h, T, 1) gate's gradients
    (the table's summed from dS, the gate's as the backward's `dgate`, as
    the dQ kernel forms it); against autograd through the plain forward with
    the bias materialized as gate * table (float32, atol 1e-5).  The plain
    backward's D is rowsum(out * dout) and its dgate autograd's."""
    rng = np.random.default_rng(21)
    b, t, h = 2, 37, 3
    q, k, v, g = (T(rng.standard_normal((b, t, h, 64)).astype(np.float32)) for _ in range(4))
    table = T(rng.standard_normal((h, t, t)).astype(np.float32))
    gate = T(rng.uniform(1.0, 3.0, (b, h, t, 1)).astype(np.float32))
    key_len = torch.tensor([t, 20]) if with_len else None
    leaves = [x.clone().requires_grad_() for x in (q, k, v, table, gate)]
    out = k2.flash_attention(*leaves[:4], key_len=key_len, bias_gate=leaves[4])
    got = torch.autograd.grad(out, leaves, g)
    ref = [x.clone().requires_grad_() for x in (q, k, v, table, gate)]
    want_out = k2.flash_attention_reference(*ref[:3], ref[4] * ref[3][None], key_len)
    want = torch.autograd.grad(want_out, ref, g)
    torch.testing.assert_close(out, want_out, atol=1e-5, rtol=1e-5)
    for name, a, w in zip(("dq", "dk", "dv", "dtable", "dgate"), got, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-5, msg=name)
    o, lse = k2.flash_attention_reference(q, k, v, table, key_len, return_lse=True,
                                          bias_gate=gate)
    grads = k2.flash_attention_bwd_reference(q, k, v, table, key_len, None, o, lse, g,
                                             bias_gate=gate)
    assert grads.dgate.shape == (b, h, t) and grads.delta.dtype == torch.float32
    torch.testing.assert_close(grads.dgate, want[4][..., 0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(grads.delta, (o * g).sum(-1).transpose(1, 2), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------------------------ augmentation
def test_augment_matches_jax():
    rng = np.random.default_rng(1)
    out_len = 3210
    n_in = augment.speed_input_len(out_len)
    assert n_in == jax_augment.speed_input_len(out_len)
    wav = (rng.standard_normal((6, n_in)) * 0.3).astype(np.float32)
    idx = np.array([0, 1, 2, 2, 1, 0], np.int32)
    np.testing.assert_allclose(
        augment.speed_perturb(T(wav), T(idx), out_len).numpy(),
        np.asarray(jax_augment.speed_perturb(wav, idx, out_len)), atol=1e-5)
    x = wav[:, :out_len]
    rir = (rng.standard_normal((6, 500)) * 0.1).astype(np.float32)
    noise = (rng.standard_normal((6, out_len)) * 0.2).astype(np.float32)
    snr = rng.uniform(0, 15, 6).astype(np.float32)
    aug_type = np.array([0, 1, 2, 1, 2, 0], np.int32)
    np.testing.assert_allclose(
        augment.add_reverb_noise(T(x), T(rir), T(noise), T(aug_type), T(snr)).numpy(),
        np.asarray(jax_augment.add_reverb_noise(x, rir, noise, aug_type, snr)), atol=1e-5)
    for n_rev, n_noise in ((2, 2), (0, 3), (2, 0)):
        got = augment.add_reverb_noise_packed(
            T(x), T(rir[:n_rev]), T(noise[:n_noise]), T(snr[:n_noise]), n_rev)
        want = jax_augment.add_reverb_noise_packed(
            x, rir[:n_rev], noise[:n_noise], snr[:n_noise], n_rev)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# --------------------------------------------------------------- the data
def _write_list(root, n=10, seed=0):
    rng = np.random.default_rng(seed)
    lines, labels = [], []
    for i in range(n):
        x = (rng.standard_normal(int(16000 * rng.uniform(0.7, 1.4))) * 0.1).astype(np.float32)
        path = os.path.join(root, f"u{i}.wav")
        write_wav(path, x)
        lines.append(json.dumps({"key": f"u{i}", "wav": path, "spk": f"s{i % 3}"}))
        labels.append(f"u{i} s{i % 3}")
    return lines, labels


def _store_arrays(seed=5):
    rng = np.random.default_rng(seed)
    rirs = {f"rir{i}": (rng.standard_normal(300 + 50 * i) * 0.1).astype(np.float32)
            for i in range(3)}
    noises = {k: (rng.standard_normal(9000) * 0.05).astype(np.float32)
              for k in ("noise0", "music0", "speech0")}
    return rirs, noises


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_train_pipeline_matches_jax(tmp_path, packed):
    lines, _ = _write_list(str(tmp_path))
    spk2id = {"s0": 0, "s1": 1, "s2": 2}
    rirs, noises = _store_arrays()
    kw = dict(num_frms=30, shuffle_size=4, filter_min_frames=50, filter_max_frames=200,
              aug_prob=0.6, rir_max_samples=400, batch_size=4, seed=7, packed_aug=packed,
              drop_last=False)
    got = TrainPipeline(lines, spk2id, TrainPipelineConfig(**kw), AugStore(arrays=rirs),
                        AugStore(arrays=noises))
    want = JaxTrainPipeline(lines, spk2id, JaxPipelineConfig(**kw), JaxAugStore(arrays=rirs),
                            JaxAugStore(arrays=noises))
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        a, b = list(got), list(want)
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            assert sorted(x) == sorted(y)
            for key in x:
                assert x[key].dtype == y[key].dtype, key
                np.testing.assert_array_equal(x[key], y[key], err_msg=key)


def test_spec_aug_masks():
    """JAX's masks handed in give JAX's output; drawn masks follow JAX's
    statistics."""
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((64, 40, 24)).astype(np.float32)
    key = jax.random.key(11)
    kw = dict(num_t_mask=2, num_f_mask=1, max_t=6, max_f=5, prob=0.6)
    want = np.asarray(jax_spec_aug(jnp.asarray(feats), key, **kw))
    m = np.asarray(jax_spec_aug(jnp.ones_like(feats), key, **kw))
    gate = (m != 1).any(axis=(1, 2))  # a drawn band is never empty
    got = apply_spec_aug(T(feats), T(m.copy()), T(gate))
    np.testing.assert_array_equal(got.numpy(), want)

    gen = torch.Generator().manual_seed(0)
    n = 4000
    mask, gate = spec_aug_masks(n, 40, 24, gen, num_t_mask=1, num_f_mask=1, max_t=6, max_f=5,
                                prob=0.6)
    assert abs(float(gate.float().mean()) - 0.6) < 0.03
    t_width = (mask == 0).all(dim=2).sum(1)  # a time band zeroes whole rows
    f_width = (mask == 0).all(dim=1).sum(1)  # a frequency band whole columns
    for widths, top in ((t_width, 6), (f_width, 5)):
        assert int(widths.min()) >= 1 and int(widths.max()) <= top
        # bands at the edge are cut; the rest are uniform on [1, top]
        counts = torch.bincount(widths, minlength=top + 1)[1:].float()
        assert float(counts.min()) > 0.5 * float(counts.max())


# ---------------------------------------------- schedules, SGD, BatchNorm
def test_schedules_match_jax():
    kw = dict(num_epochs=20, epoch_iter=50, initial_lr=0.1, final_lr=5e-5, warm_up_epoch=2)
    steps = [0, 1, 49, 50, 99, 100, 101, 500, 999]
    for name, extra in (("ExponentialDecrease", {}), ("ExponentialDecrease", {"scale_ratio": 2.0}),
                        ("TriAngular2", {}), ("ExponentialDecrease", {"warm_from_zero": True})):
        got = schedulers.get_lr_schedule(name, **kw, **extra)
        want = jax_sched.get_lr_schedule(name, **kw, **extra)
        np.testing.assert_allclose([got(s) for s in steps],
                                   [float(want(s)) for s in steps], rtol=1e-6)
    for inc in ("exp", "linear"):
        m = dict(epoch_iter=50, increase_start_epoch=2, fix_start_epoch=6, initial_margin=0.0,
                 final_margin=0.2, increase_type=inc)
        np.testing.assert_allclose(
            [schedulers.MarginSchedule(**m)(s) for s in steps + [250, 300]],
            [float(jax_sched.MarginSchedule(**m)(s)) for s in steps + [250, 300]],
            rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("frozen", [False, True], ids=["all", "freeze_paths"])
def test_sgd_update_matches_jax(frozen):
    rng = np.random.default_rng(8)
    shapes = {"frontend": {"upstream": {"w": (3, 4)}, "mix": (5,)}, "head": {"w": (4, 2)}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
             for _ in range(3)]
    lr = schedulers.ExponentialDecrease(num_epochs=2, epoch_iter=2, initial_lr=0.1,
                                        final_lr=0.01, warm_up_epoch=1)
    jlr = jax_sched.ExponentialDecrease(num_epochs=2, epoch_iter=2, initial_lr=0.1,
                                        final_lr=0.01, warm_up_epoch=1)
    paths = (("frontend", "upstream"),) if frozen else ()
    tx = jax_make_optimizer(jlr, "SGD", 0.9, True, 1e-2, freeze_paths=paths)
    jp, opt_state = params, tx.init(params)
    for g in grads:
        updates, opt_state = tx.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, updates)

    module = torch.nn.Module()
    names = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = ".".join(p.key for p in path)
        names[name] = path
        sub = module
        for part in name.split(".")[:-1]:
            if not hasattr(sub, part):
                sub.add_module(part, torch.nn.Module())
            sub = getattr(sub, part)
        sub.register_parameter(name.split(".")[-1], torch.nn.Parameter(T(leaf.copy())))
    frozen_names = freeze_paths(module, paths)
    assert frozen_names == (["frontend.upstream.w"] if frozen else [])
    state = TrainState(module, make_optimizer(module, "SGD", 0.9, True, 1e-2), lr)
    for g in grads:
        for name, p in module.named_parameters():
            if p.requires_grad:
                p.grad = T(np.array(_at(g, names[name])))
        state.apply_gradients()
    assert state.step == 3
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(_at(jp, names[name])),
                                   atol=1e-6, rtol=1e-5, err_msg=name)


def _at(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def test_batchnorm_train_matches_flax():
    """Train-mode BatchNorm: output and running statistics of flax's
    momentum 0.9 with the biased batch variance (torch's own stores the
    unbiased one), over (B, C, T) and (B, C), float32 and bf16 inputs."""
    rng = np.random.default_rng(4)
    for shape in ((4, 6, 9), (5, 6)):
        x = (rng.standard_normal(shape) * 2 + 1).astype(np.float32)
        scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
        bias = rng.normal(0, 0.1, 6).astype(np.float32)
        mean0 = rng.normal(0, 0.1, 6).astype(np.float32)
        var0 = rng.uniform(0.5, 1.5, 6).astype(np.float32)
        xj = np.moveaxis(x, 1, -1)  # flax normalizes the last axis
        bn = JaxBatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
        variables = {"params": {"scale": scale, "bias": bias},
                     "batch_stats": {"mean": mean0, "var": var0}}
        port = BatchNorm1d(6, eps=1e-5, momentum=0.1).train()
        port.load_state_dict({"weight": T(scale), "bias": T(bias), "running_mean": T(mean0),
                              "running_var": T(var0), "num_batches_tracked": torch.tensor(0)})
        for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            y, upd = bn.apply(variables, jnp.asarray(xj, jdt), mutable=["batch_stats"])
            port.running_mean.copy_(T(mean0))
            port.running_var.copy_(T(var0))
            out = port(T(x).to(dtype))
            assert out.dtype == dtype and port.running_var.dtype == torch.float32
            tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=0.04, rtol=0)
            np.testing.assert_allclose(np.moveaxis(out.float().detach().numpy(), 1, -1),
                                       np.asarray(y, np.float32), **tol)
            np.testing.assert_allclose(port.running_mean.numpy(),
                                       np.asarray(upd["batch_stats"]["mean"]), atol=1e-6, rtol=1e-5)
            np.testing.assert_allclose(port.running_var.numpy(),
                                       np.asarray(upd["batch_stats"]["var"]), atol=1e-6, rtol=1e-5)
    assert int(port.num_batches_tracked) == 2
    # eval mode is torch's BatchNorm1d: the running statistics
    port.eval()
    want = torch.nn.functional.batch_norm(T(x), port.running_mean, port.running_var,
                                          port.weight, port.bias, False, 0.0, 1e-5)
    torch.testing.assert_close(port(T(x)), want)


# ------------------------------------------------------ the entry point
def test_train_entry_point_cpu(tmp_path):
    """bin/train.train on a tiny config, 2 steps on the CPU: model_1.pt loads
    into bin/extract; a run stopped at step 1 and resumed from its
    train_state.pt ends where the uninterrupted run ends."""
    lines, labels = _write_list(str(tmp_path), n=8, seed=31)
    (tmp_path / "train.list").write_text("\n".join(lines) + "\n")
    (tmp_path / "train.label").write_text("\n".join(labels) + "\n")
    rirs, noises = _store_arrays(32)
    for name, arrays in (("rirs", rirs), ("musan", noises)):
        d = tmp_path / name
        d.mkdir()
        for key, x in arrays.items():
            np.save(d / f"{key}.npy", x)
        (d / "index.json").write_text(json.dumps({k: f"{k}.npy" for k in arrays}))
    config = {
        "seed": 42, "num_epochs": 1, "epoch_iter": 2, "save_epoch_interval": 1,
        "log_batch_interval": 1, "save_optimizer": True,
        "train_data": str(tmp_path / "train.list"), "train_label": str(tmp_path / "train.label"),
        "dataloader_args": {"batch_size": 4, "num_workers": 2},
        "dataset_args": {
            "shuffle_args": {"shuffle_size": 4},
            "filter_args": {"min_num_frames": 50, "max_num_frames": 200},
            "num_frms": 20, "aug_prob": 0.5, "reverb_data": str(tmp_path / "rirs"),
            "noise_data": str(tmp_path / "musan"), "frontend": "s3prl",
            "s3prl_args": {"upstream": "tiny", "frozen": False, "attn_impl": "flash"},
            "spec_aug": True, "spec_aug_args": {"max_t": 5, "max_f": 4}},
        "model": "ECAPA_TDNN_GLOB_c512",
        "model_args": {"feat_dim": 32, "embed_dim": 16, "pooling_func": "ASTP"},
        "projection_args": {"project_type": "arc_margin", "scale": 32.0},
        "margin_update": {"initial_margin": 0.2, "final_margin": 0.2,
                          "increase_start_epoch": 1, "fix_start_epoch": 1},
        "optimizer_args": {"momentum": 0.9, "nesterov": True, "weight_decay": 1e-4},
        "scheduler_args": {"initial_lr": 0.01, "final_lr": 0.001, "warm_up_epoch": 1},
    }
    if not torch.cuda.is_available():  # the entry point defaults to the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train(config, exp_dir=str(tmp_path / "never"))
    full = train(config, device="cpu", exp_dir=str(tmp_path / "a"))
    assert full.step == 2
    metrics = [json.loads(ln) for ln in (tmp_path / "a" / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in metrics] == [1, 2] and all(np.isfinite(m["loss"]) for m in metrics)
    assert metrics[0]["lr"] == pytest.approx(0.01) and metrics[0]["margin"] == pytest.approx(0.2)

    stopped = train(config, device="cpu", exp_dir=str(tmp_path / "b"), stop_at_step=1)
    assert stopped.step == 1 and not (tmp_path / "b" / "models" / "model_1.pt").exists()
    resumed = train(config, device="cpu", exp_dir=str(tmp_path / "b"))
    assert resumed.step == 2
    a = torch.load(tmp_path / "a" / "models" / "model_1.pt", weights_only=True)
    b = torch.load(tmp_path / "b" / "models" / "model_1.pt", weights_only=True)
    assert sorted(a) == sorted(b) and "projection.weight" in a
    for key in a:
        torch.testing.assert_close(a[key], b[key], atol=1e-6, rtol=1e-5, msg=key)

    eval_list = tmp_path / "eval.jsonl"
    eval_list.write_text("\n".join(lines[:3]) + "\n")
    keys, emb = extract(str(tmp_path / "a" / "config.json"), str(eval_list),
                        str(tmp_path / "a" / "models" / "model_1.pt"), "", batch_size=2,
                        device="cpu")
    assert len(keys) == 3 and emb.shape == (3, 16) and np.isfinite(emb).all()
