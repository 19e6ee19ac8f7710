"""Port parity: the rest of the model zoo (x-vector, xi-vector, Gemini
DF-ResNet, SimAM-ResNet, RepVGG / RepSPK, ReDimNet), Adam / AdamW and the
`groups=` convolutions against the JAX package.

Each family runs at a tiny width through test_torch_port_zoo.py's helpers:
seeded numpy weights in WeSpeaker's layout go into the JAX module by its
own converter and back into the port by `from_jax_variables`, bit for bit;
`from_jax_variables` equals the JAX package's `to_torch_state_dict` on
those variables (its converter probed at the tiny widths); eval on a padded
batch with a ragged mask within REL = 1e-5 x max |JAX| (and the full-length
row unmasked); train-mode BatchNorm with the mask, outputs and running
statistics by the float64 rule (1e-5, or twice JAX's distance from the
port's float64 forward, JAX's distance capped at JAX_CAP = 2e-4), on inputs
with per-utterance scales and offsets.

At full width the six config models (ReDimNetB2, REPVGG_TINY_A0,
Gemini_DF_ResNet114, XVEC, XI_VEC_ECAPA_TDNN_c512, SimAM_ResNet34_ASP) hold
the port's state_dict names and shapes equal to `from_jax_variables` of the
JAX module's variables, from `jax.eval_shape` (nothing compiled or run).
The two registries hold the same names.

RepVGG: the port's `convert_repvgg_params` within 1e-6 x max of the JAX
package's (both float32), and the deploy form's eval within REL of the
training form's.  Adam and AdamW: three optimizer steps of a small model on
seeded gradients against the JAX package's `make_optimizer` chain within
1e-5 x max |JAX's parameter change|; AdamW with its decay coupled (torch's
Adam) must miss that bar.  The `groups=` convolutions' outputs and
gradients against `ops/conv_safe.py:grouped_conv1d` / `grouped_conv2d`
within 1e-5 x max |JAX|.

Last, recipes.voxceleb_v2 on each new config at a tiny size on the CPU
(stages 1-9 with the lm config, else 1-7), ERes2Net's and Res2Net's too.
"""

import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_port_recipe import _write_recipe_data
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from tests.test_torch_port_zoo import (
    REL,
    _jax_variables,
    assert_rel,
    check_eval,
    check_inverse,
    check_train_mode,
    jax_reference,
    wespeaker_state,
)
from wespeaker_hubert_tpu.models import convert_to_torch
from wespeaker_hubert_tpu.models import ecapa_tdnn as jax_ecapa
from wespeaker_hubert_tpu.models import gemini_dfresnet as jax_gemini
from wespeaker_hubert_tpu.models import redimnet as jax_redimnet
from wespeaker_hubert_tpu.models import repvgg as jax_repvgg
from wespeaker_hubert_tpu.models import samresnet as jax_samresnet
from wespeaker_hubert_tpu.models import tdnn as jax_tdnn
from wespeaker_hubert_tpu.models import convert_torch as ct
from wespeaker_hubert_tpu.models.registry import MODEL_REGISTRY as JAX_REGISTRY
from wespeaker_hubert_tpu.ops.conv_safe import grouped_conv1d, grouped_conv2d
from wespeaker_hubert_tpu.train.state import make_optimizer as jax_make_optimizer
from wespeaker_hubert_tpu_torch.bin.export_model import load_program
from wespeaker_hubert_tpu_torch.models import (
    ecapa_tdnn,
    gemini_dfresnet,
    redimnet,
    repvgg,
    samresnet,
    tdnn,
)
from wespeaker_hubert_tpu_torch.models.convert_jax import from_jax_variables
from wespeaker_hubert_tpu_torch.models.registry import MODEL_REGISTRY, get_speaker_model
from wespeaker_hubert_tpu_torch.recipes import voxceleb_v2
from wespeaker_hubert_tpu_torch.train.state import TrainState, make_optimizer

T = torch.from_numpy
WM = (0.125,) * 4  # RepVGG widths 8, 16, 32, 64
GEM = ((1, 1, 2, 1), (4, 4, 8, 8, 16))
# ReDimNet stages: (stride, blocks, conv_exp, kernels, att_red); C 4 x 40
# mels: 1-D width 160, time-context widths 40 and 20 (4 heads)
RSETUP = ((1, 1, 1, ((3, 3),), 4), (2, 1, 2, ((3, 3),), 8), (2, 1, 1, ((3, 3),), None))


def _redim(b2, gd, gelu="erf", b1="conv+att"):
    return (lambda m: m.ReDimNet(40, 4, b1, b2, RSETUP, gd, embed_dim=8,
                                 two_emb_layer=b2 == "basic_resnet", gelu_impl=gelu))


# name -> (registry name, JAX module, port module, JAX converter, (B, T), feat_dim)
CASES = {
    "xvec": ("XVEC", lambda: jax_tdnn.XVEC(40, 16, 24, 8), lambda: tdnn.XVEC(40, 16, 24, 8),
             ct.xvec_from_torch, (3, 64), 40),
    "xi_xvec": ("XI_VEC_XVEC", lambda: jax_tdnn.XVEC(40, 16, 24, 8, "XI"),
                lambda: tdnn.XVEC(40, 16, 24, 8, "XI"),
                lambda sd: ct.xvec_from_torch(sd, "XI"), (3, 64), 40),
    "xi_ecapa": ("XI_VEC_ECAPA_TDNN_c512", lambda: jax_ecapa.EcapaTdnn(16, 40, 8, "XI"),
                 lambda: ecapa_tdnn.EcapaTdnn(16, 40, 8, "XI"),
                 lambda sd: ct.ecapa_from_torch(sd, 16, "XI"), (3, 64), 40),
    "gemini": ("Gemini_DF_ResNet60", lambda: jax_gemini.Gemini_DF_ResNet(*GEM, 32, 8, "TSTP", True),
               lambda: gemini_dfresnet.Gemini_DF_ResNet(*GEM, 32, 8, "TSTP", True),
               lambda sd: ct.gemini_from_torch(sd, *GEM, 32, True), (3, 64), 32),
    "simam": ("SimAM_ResNet34_ASP", lambda: jax_samresnet.SimAMResNet(4, (1, 1, 1, 1), 8, 40),
              lambda: samresnet.SimAMResNet(4, (1, 1, 1, 1), 8, 40),
              lambda sd: ct.samresnet_from_torch(sd, (1, 1, 1, 1), 4, 40), (3, 64), 40),
    "repvgg_g2": ("REPVGG_B1g2",
                  lambda: jax_repvgg.RepVGG((1, 2, 1, 1), (1, 1, 2, 2, 2), WM, "RepVGG",
                                            jax_repvgg.G2_MAP, feat_dim=40, embed_dim=8),
                  lambda: repvgg.RepVGG((1, 2, 1, 1), (1, 1, 2, 2, 2), WM, "RepVGG",
                                        repvgg.G2_MAP, feat_dim=40, embed_dim=8),
                  lambda sd: ct.repvgg_from_torch(sd, (1, 2, 1, 1), WM, "RepVGG", feat_dim=40),
                  (3, 64), 40),
    "repspk_g4": ("REPVGG_TINY_RSBB_A0",
                  lambda: jax_repvgg.RepVGG((1, 2, 1, 1), (1, 1, 2, 2, 2), WM, "RepSPK",
                                            jax_repvgg.G4_MAP, feat_dim=40, embed_dim=8),
                  lambda: repvgg.RepVGG((1, 2, 1, 1), (1, 1, 2, 2, 2), WM, "RepSPK",
                                        repvgg.G4_MAP, feat_dim=40, embed_dim=8),
                  lambda sd: ct.repvgg_from_torch(sd, (1, 2, 1, 1), WM, "RepSPK", feat_dim=40),
                  (3, 64), 40),
    "redimnet_convnext": ("ReDimNetB2", lambda: _redim("convnext_like", 2, "tanh")(jax_redimnet),
                          lambda: _redim("convnext_like", 2, "tanh")(redimnet),
                          lambda sd: ct.redimnet_from_torch(sd, RSETUP, 4, 40, "convnext_like"),
                          (3, 64), 40),
    # the "att" time-context block (positional conv + transformer) here
    "redimnet_resnet": ("ReDimNetB0", lambda: _redim("basic_resnet", None, b1="att")(jax_redimnet),
                        lambda: _redim("basic_resnet", None, b1="att")(redimnet),
                        lambda sd: ct.redimnet_from_torch(sd, RSETUP, 4, 40, "basic_resnet", "att",
                                                          two_emb_layer=True), (3, 64), 40),
    "redimnet_fwse": ("ReDimNetB3", lambda: _redim("basic_resnet_fwse", 1)(jax_redimnet),
                      lambda: _redim("basic_resnet_fwse", 1)(redimnet),
                      lambda sd: ct.redimnet_from_torch(sd, RSETUP, 4, 40, "basic_resnet_fwse"),
                      (3, 64), 40),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return jax_reference(CASES[request.param], request.param, modes=("mask",))


def test_from_jax_variables_inverts_jax_from_torch(case):
    check_inverse(case)


def test_from_jax_variables_equals_to_torch_state_dict(case, monkeypatch):
    """The JAX package's index-map exporter, with the family's converter at
    the case's widths, gives the port's state_dict exactly."""
    to_jax = CASES[case["kind"]][3]
    monkeypatch.setattr(convert_to_torch, "convert_checkpoint", lambda model, sd, **kw: to_jax(sd))
    variables = {"params": case["params"], "batch_stats": case["stats"]}
    want = convert_to_torch.to_torch_state_dict(case["name"], variables, template_sd=case["sd"])
    got = from_jax_variables(case["name"], variables, feat_dim=case["fd"])
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_eval_matches_jax(case):
    check_eval(case)


def test_train_mode_matches_jax(case):
    check_train_mode(case)


# the six config models: (name, model_args of their config)
CONFIG_MODELS = {
    "ReDimNetB2": dict(feat_dim=72, embed_dim=192, pooling_func="ASTP", two_emb_layer=False),
    "REPVGG_TINY_A0": dict(feat_dim=80, embed_dim=256, pooling_func="TSTP", deploy=False,
                           use_se=False),
    "Gemini_DF_ResNet114": dict(feat_dim=80, embed_dim=256, pooling_func="TSTP",
                                two_emb_layer=False),
    "XVEC": dict(feat_dim=80, embed_dim=512, pooling_func="TSTP"),
    "XI_VEC_ECAPA_TDNN_c512": dict(feat_dim=80, embed_dim=192, pooling_func="XI"),
    "SimAM_ResNet34_ASP": dict(feat_dim=80, embed_dim=256, pooling_func="TSTP",
                               two_emb_layer=False),
}


@pytest.mark.parametrize("name", sorted(CONFIG_MODELS))
def test_full_width_names_and_shapes(name):
    """The JAX module's variables at the config's width, by jax.eval_shape
    (no compile), through from_jax_variables: the port module's state_dict
    names and shapes."""
    kw = CONFIG_MODELS[name]
    jm = JAX_REGISTRY[name](**kw)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 200, kw["feat_dim"])))
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), dict(shapes))
    got = from_jax_variables(name, zeros, feat_dim=kw["feat_dim"])
    own = get_speaker_model(name)(**kw).state_dict()
    assert sorted(got) == sorted(own)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape)
                                                           for k, v in own.items()}


def test_registries_hold_the_same_names():
    assert sorted(MODEL_REGISTRY) == sorted(JAX_REGISTRY)
    with pytest.raises(ValueError, match="no model of the JAX registry"):
        from_jax_variables("NoSuchNet", {"params": {}})


@pytest.mark.parametrize("kind", ["repvgg_g2", "repspk_g4"])
def test_repvgg_fusion_matches_jax(kind):
    """convert_repvgg_params on the port's state_dict against the JAX
    package's on its trees (grouped identity kernels: G2 / G4 maps), and the
    deploy form's eval against the training form's."""
    name, _, port_module, to_jax, (b, t), fd = CASES[kind]
    block = "RepSPK" if "spk" in kind else "RepVGG"
    sd = wespeaker_state(port_module(), seed=3)
    params, stats = to_jax(sd)
    want = from_jax_variables(name, {"params": jax_repvgg.convert_repvgg_params(
        params, stats, block), "batch_stats": {}}, feat_dim=fd)
    got = repvgg.convert_repvgg_params(sd)
    assert set(got) == set(want)
    for k, v in want.items():
        assert_rel(got[k].numpy(), v.numpy(), rel=1e-6, what=k)
    train = port_module().eval()
    train.load_state_dict(sd)
    gmap = repvgg.G4_MAP if block == "RepSPK" else repvgg.G2_MAP
    deploy = repvgg.RepVGG((1, 2, 1, 1), (1, 1, 2, 2, 2), WM, block, gmap, feat_dim=fd,
                           embed_dim=8, deploy=True).eval()
    deploy.load_state_dict(got)
    x = T(np.random.default_rng(5).standard_normal((b, t, fd)).astype(np.float32))
    mask = torch.arange(t)[None, :] < torch.tensor([t, 40, 23])[:, None]
    with torch.inference_mode():
        assert_rel(deploy(x, mask).numpy(), train(x, mask).numpy(), what="deploy vs train")


class _Small(torch.nn.Module):
    """A conv, a BatchNorm and a head: every kind of tensor weight decay
    reaches."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv1d(3, 4, 3)
        self.bn = torch.nn.BatchNorm1d(4)
        self.head = torch.nn.Linear(4, 2)


def _optimizer_run(kind, weight_decay, coupled_control=False):
    """Three steps on seeded gradients: the port's parameter change, the JAX
    chain's from the same start, and the port's model after three steps,
    the state after two (model, TrainState) and the third gradients."""
    torch.manual_seed(0)
    model = _Small()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn_like(p))
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    lr = lambda step: 0.01 * (step + 1)  # noqa: E731
    port_kind = "ADAM" if coupled_control else kind
    state = TrainState(model, make_optimizer(model, port_kind, weight_decay=weight_decay), lr)
    rng = np.random.default_rng(1)
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in start.items()}
             for _ in range(3)]
    tx = jax_make_optimizer(lr, kind, weight_decay=weight_decay)
    params = {k: jnp.asarray(v.numpy()) for k, v in start.items()}
    opt_state = tx.init(params)
    saved = None
    for i, g in enumerate(grads):
        if i == 2:  # what a `save_optimizer` checkpoint carries
            buf = io.BytesIO()
            torch.save({"model": model.state_dict(), "state": state.state_dict()}, buf)
            saved = buf.getvalue()
        for k, p in model.named_parameters():
            p.grad = T(g[k]).clone()
        state.apply_gradients()
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state,
                                       params)
        params = optax.apply_updates(params, updates)
    got = {k: (v.detach() - start[k]).numpy() for k, v in model.named_parameters()}
    want = {k: np.asarray(params[k]) - start[k].numpy() for k in start}
    return got, want, model, saved, grads[2]


def _max_rel(got, want):
    scale = max(float(np.abs(v).max()) for v in want.values())
    return max(float(np.abs(got[k] - want[k]).max()) for k in want) / scale


@pytest.mark.parametrize("kind,weight_decay", [("ADAM", 1e-2), ("ADAMW", 5e-2), ("ADAMW", 0.0)])
def test_adam_matches_jax_chain(kind, weight_decay):
    got, want, model, saved, last = _optimizer_run(kind, weight_decay)
    assert _max_rel(got, want) <= 1e-5
    if kind == "ADAMW" and weight_decay:
        # the control: the decay coupled (torch's Adam) misses the bar
        bad = _optimizer_run(kind, weight_decay, coupled_control=True)[0]
        assert _max_rel(bad, want) > 1e-5
    # resumed from the state after two steps (the moments and the step count
    # carried), step 3 lands where the uninterrupted run did, bit for bit
    ckpt = torch.load(io.BytesIO(saved), weights_only=True)
    fresh = _Small()
    fresh.load_state_dict(ckpt["model"])
    resumed = TrainState(fresh, make_optimizer(fresh, kind, weight_decay=weight_decay),
                         lambda step: 0.01 * (step + 1))
    resumed.load_state_dict(ckpt["state"])
    assert resumed.step == 2
    for k, p in fresh.named_parameters():
        p.grad = T(last[k]).clone()
    resumed.apply_gradients()
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k


@pytest.mark.parametrize("dims", [1, 2])
def test_groups_conv_grads_match_conv_safe(dims):
    """nn.Conv{1,2}d(groups=g) against the JAX package's partitioner-safe
    grouped convs: output, input and weight gradients."""
    rng = np.random.default_rng(dims)
    g, cin, cout = 4, 8, 12
    if dims == 1:
        x = rng.standard_normal((2, 17, cin)).astype(np.float32)  # NWC
        w = rng.standard_normal((3, cin // g, cout)).astype(np.float32)  # WIO
        jfn = lambda x, w: grouped_conv1d(x, w, 2, ((1, 1),), g)  # noqa: E731
        tfn = lambda x, w: torch.nn.functional.conv1d(  # noqa: E731
            x.transpose(1, 2), w.permute(2, 1, 0), stride=2, padding=1,
            groups=g).transpose(1, 2)
    else:
        x = rng.standard_normal((2, 9, 11, cin)).astype(np.float32)  # NHWC
        w = rng.standard_normal((3, 3, cin // g, cout)).astype(np.float32)  # HWIO
        jfn = lambda x, w: grouped_conv2d(x, w, (1, 2), ((2, 2), (2, 2)), g, (2, 2))  # noqa: E731
        tfn = lambda x, w: torch.nn.functional.conv2d(  # noqa: E731
            x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=(1, 2), padding=2,
            dilation=2, groups=g).permute(0, 2, 3, 1)
    ct_ = rng.standard_normal(np.asarray(jax.eval_shape(jfn, x, w).shape)).astype(np.float32)
    out, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(ct_))
    xt, wt = T(x).requires_grad_(), T(w).requires_grad_()
    y = tfn(xt, wt)
    y.backward(T(ct_))
    assert_rel(y.detach().numpy(), np.asarray(out), what="output")
    assert_rel(xt.grad.numpy(), np.asarray(dx), what="dx")
    assert_rel(wt.grad.numpy(), np.asarray(dw), what="dw")


# ------------------------------------------------- the recipe at tiny width
CONF = Path(__file__).resolve().parents[1] / "examples/voxceleb/v2/conf"
# config -> (its lm config or None, mels, more overrides): 16 mels (ReDimNet
# 24: a multiple of its frequency strides, 8, whose 1-D widths stay whole
# numbers of heads), Gemini at its 60-layer depth
RECIPES = {
    "redimnet": (None, 24, []),
    "repvgg": (None, 16, []),
    "xi_vector": (None, 16, []),
    "res2net": (None, 16, []),
    "xvec": ("xvec_lm", 16, []),
    "eres2net": ("eres2net_lm", 16, []),
    "gemini_dfresnet_adam": ("gemini_dfresnet_sgd_lm", 16, ["model=Gemini_DF_ResNet60"]),
}


@pytest.fixture(scope="module")
def recipe_data(tmp_path_factory):
    data = tmp_path_factory.mktemp("zoo_recipe") / "data"
    _write_recipe_data(data, n_train=12)
    return data


@pytest.mark.parametrize("config", sorted(RECIPES))
def test_recipe_on_cpu(config, recipe_data, tmp_path, capsys, caplog):
    """recipes.voxceleb_v2 on the config (and its lm config: stages 1-9,
    else 1-7) at a tiny size on the CPU: batch 8, 50 / 60 frames, one step
    per run.  Every stage runs; stages 5-7 print their EER; with an lm
    config stage 9 starts from the base run's averaged model (the AdamW
    run's for Gemini, into SGD: the model alone) at margin 0.5, and both
    stage-8 programs run."""
    lm, mels, extra = RECIPES[config]
    data = recipe_data
    paths = [f"train_data={data / 'vox2_dev' / 'shard.list'}",
             f"train_label={data / 'vox2_dev' / 'utt2spk'}",
             f"dataset_args.reverb_data={data / 'rirs_aug_store'}",
             f"dataset_args.noise_data={data / 'musan_aug_store'}"]
    tiny = ["num_epochs=1", "epoch_iter=1", "num_avg=1", "loop_steps=1", "log_batch_interval=1",
            "dataloader_args.batch_size=8", f"model_args.feat_dim={mels}",
            f"dataset_args.fbank_args.num_mel_bins={mels}", "model_args.embed_dim=8"] + extra
    argv = (["--stage", "1", "--stop_stage", "9" if lm else "7"]
            + (["--lm_config", str(CONF / f"{lm}.yaml")] if lm else [])
            + ["--config", str(CONF / f"{config}.yaml"), "--data_root", str(data),
               "--trials", str(data / "vox1" / "trials.kaldi"), "--device", "cpu",
               "--calibration_trial_num", "20", f"exp_dir={tmp_path / 'exp'}",
               "dataset_args.num_frms=50", "save_optimizer=true"] + paths + tiny)
    if lm:
        argv += ([f"lm.exp_dir={tmp_path / 'exp_lm'}", "lm.dataset_args.num_frms=60"]
                 + ["lm." + o for o in paths + tiny])
    caplog.set_level("INFO", logger="train")
    done = voxceleb_v2.main(argv)
    out = capsys.readouterr().out
    assert sorted(done) == list(range(1, 10 if lm else 8))
    assert out.count("trials.kaldi.score.asnorm.qmf: EER ") == (2 if lm else 1)
    # the base run's optimizer is the config's (Adam's moments for AdamW)
    state = torch.load(tmp_path / "exp" / "models" / "train_state.pt", weights_only=False)
    moments = {k for s in state["optimizer"]["state"].values() for k in s}
    assert moments == ({"exp_avg", "exp_avg_sq", "step"} if "adam" in config
                       else {"momentum_buffer"})
    if not lm:
        return
    assert sorted(done[9]["stages"]) == list(range(3, 9))
    init = [r.getMessage() for r in caplog.records if r.getMessage().startswith("model_init")]
    assert init == [f"model_init from {tmp_path / 'exp' / 'avg_model.pt'} (epoch 0, 0 missing, "
                    "0 unexpected)"]
    margins = [json.loads(ln)["margin"]
               for ln in (tmp_path / "exp_lm" / "metrics.jsonl").read_text().splitlines()]
    assert margins and all(m == 0.5 for m in margins)
    for exp in ("exp", "exp_lm"):
        program = load_program(str(tmp_path / exp / "exported" / "model.pt2"))
        assert program(torch.zeros(2, 40, mels)).shape == (2, 8)
