"""Port parity: every training head and the multi-head poolings, against
the JAX package on the CPU.

- each head (`add_margin`, `arc_margin_intertopk_subcenter` with and
  without `easy_margin` / `do_lm`, `sphere` at m 1-4, `sphereface2` with
  margin types A and C, `linear`) at B 8, D 32, C 37 (K 3) and margins 0
  and 0.2: logits, the SphereFace2 loss and the gradients of a fixed
  projection of the outputs with respect to the embedding and every head
  parameter, JAX's `jax.grad` against autograd, rtol / atol 1e-5 in
  float32, the weights through `from_jax_variables`; `sphere` at the JAX
  SpeakerNet's `it = 1` (lambda 892.857), `linear` in train mode on its
  running statistics, which JAX's step leaves as they are;
- MHASTP and MQMHASTP against JAX at in_dim 64 with a padding mask, atol
  1e-5, and `pooling_output_dim` against JAX's;
- every backbone that takes `pooling_func`, and the Whisper-PMFA head,
  builds with both poolings.

Whole networks with them (a ResNet with MHASTP, an ECAPA with MQMHASTP, a
SphereFace2 train step) are in tests/test_torch_port_heads_nets.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_ecapa import random_variables
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from tests.torch_port_refs import FastJit, run_jax
from wespeaker_hubert_tpu.models import pooling as jax_pooling
from wespeaker_hubert_tpu.models import projections as jax_projections
from wespeaker_hubert_tpu_torch.models import pooling, projections, whisper_pmfa
from wespeaker_hubert_tpu_torch.models.convert_jax import from_jax_variables
from wespeaker_hubert_tpu_torch.models.registry import get_speaker_model
from wespeaker_hubert_tpu_torch.models.speaker_net import build_speaker_net

T = torch.from_numpy
B, D, C, K = 8, 32, 37, 3
SUB = "arc_margin_intertopk_subcenter"
HEADS = {
    "add_margin": {"project_type": "add_margin"},
    "subcenter": {"project_type": SUB},
    "subcenter_easy": {"project_type": SUB, "easy_margin": True},
    "subcenter_lm": {"project_type": SUB, "do_lm": True},
    "subcenter_easy_lm": {"project_type": SUB, "easy_margin": True, "do_lm": True},
    **{f"sphere_m{m}": {"project_type": "sphere", "margin": m} for m in (1, 2, 3, 4)},
    "sphereface2_A": {"project_type": "sphereface2", "margin_type": "A"},
    "sphereface2_C": {"project_type": "sphereface2", "margin_type": "C"},
    "linear": {"project_type": "linear"},
}


def _head_tree(variables):
    """A head's variables as a SpeakerNet's, for `from_jax_variables`."""
    return {"params": {"backbone": {}, "projection": variables["params"]},
            "batch_stats": {"projection": variables.get("batch_stats", {})}}


@pytest.mark.parametrize("name", sorted(HEADS))
def test_head_matches_jax(name):
    conf = dict(HEADS[name], embed_dim=D, num_class=C)
    if name.startswith("subcenter"):
        conf["K"] = K
    jm = jax_projections.get_projection(conf)
    rng = np.random.default_rng(sorted(HEADS).index(name))
    emb = rng.standard_normal((B, D)).astype(np.float32)
    label = rng.integers(0, C, B).astype(np.int32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((B, D)),
                                            jnp.zeros((B,), jnp.int32), 0.0))
    variables = random_variables(shapes, 3)
    if "weight" in variables["params"]:
        variables["params"]["weight"] = rng.standard_normal(
            variables["params"]["weight"].shape).astype(np.float32)
    proj = rng.standard_normal((B, C)).astype(np.float32)

    def objective(e, params, margin):
        (logits, aux), upd = jm.apply({**variables, "params": params}, e, label, margin,
                                      mutable=["batch_stats"])
        out = jnp.sum(logits * proj) + (0.0 if aux is None else aux)
        return out, (logits, aux, upd)

    jfn = FastJit(jax.jit(jax.value_and_grad(objective, argnums=(0, 1), has_aux=True)))
    head = projections.get_projection(conf).train()
    assert type(head).__name__ == type(jm).__name__
    sd = from_jax_variables("XVEC", _head_tree(variables))
    head.load_state_dict({k[len("projection."):]: v for k, v in sd.items()}, strict=True)
    if name.startswith("sphere_m"):  # the anneal at the JAX SpeakerNet's it = 1
        assert head.lamb() == pytest.approx(1000 / 1.12, rel=1e-12) == 892.857142857142
    stats = {k: v.clone() for k, v in head.state_dict().items() if "running" in k}
    for margin in (0.0, 0.2):
        (_, (want, want_aux, upd)), (g_emb, g_params) = jfn(
            jnp.asarray(emb), variables["params"], jnp.float32(margin))
        e = T(emb).requires_grad_()
        for p in head.parameters():
            p.grad = None
        logits, aux = head(e, T(label), margin)
        out = (logits * T(proj)).sum() + (0.0 if aux is None else aux)
        out.backward()
        np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        assert (aux is None) == (want_aux is None) == (not name.startswith("sphereface2"))
        if aux is not None:
            np.testing.assert_allclose(float(aux.detach()), float(want_aux), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(e.grad.numpy(), np.asarray(g_emb), rtol=1e-5, atol=1e-5)
        grads = from_jax_variables("XVEC", _head_tree({**variables, "params": g_params}))
        for k, p in head.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), grads["projection." + k].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        # linear: the JAX step leaves the head's statistics as they are, and
        # the port's train mode reads and keeps them
        for k, v in jax.tree.leaves_with_path(upd.get("batch_stats", {})):
            assert np.array_equal(np.asarray(v), variables["batch_stats"][k[0].key][k[1].key])
        assert all(torch.equal(v, head.state_dict()[k]) for k, v in stats.items())


def test_unknown_projection_type_is_linear():
    for conf in ({"project_type": "softmax"}, {}):
        conf = dict(conf, embed_dim=D, num_class=C)
        assert type(projections.get_projection(conf)).__name__ == type(
            jax_projections.get_projection(conf)).__name__ == "LinearProduct"


POOLS = {
    "MHASTP": {},
    "MHASTP_4heads_ds": {"layer_num": 1, "head_num": 4, "d_s": 2},
    "MQMHASTP": {},
    "MQMHASTP_3queries": {"query_num": 3, "layer_num": 3, "head_num": 2, "d_s": 1},
}


@pytest.mark.parametrize("name", sorted(POOLS))
def test_pooling_matches_jax(name):
    pool_type, kwargs = name.split("_")[0], POOLS[name]
    in_dim, b, t = 64, 3, 23
    jm = getattr(jax_pooling, pool_type)(in_dim, **kwargs)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, t, in_dim)).astype(np.float32)
    mask = np.arange(t)[None, :] < np.array([t, 17, 9])[:, None]
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, t, in_dim))))
    variables = random_variables(shapes, 5)
    want = run_jax(lambda v, x, m: jm.apply(v, x, m), variables, jnp.asarray(x),
                   jnp.asarray(mask))
    sd = from_jax_variables("XVEC", {"params": {"pool": variables["params"]}})
    pm = getattr(pooling, pool_type)(in_dim, **kwargs)
    pm.load_state_dict({k[len("pool."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = pm(T(x).transpose(1, 2), T(mask))
    assert got.shape[-1] == pooling.pooling_output_dim(pool_type, in_dim, **kwargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    for kind, kw in (("TAP", {}), ("TSTP", {}), ("ASP", {}), ("XI", {}), ("XI", {"stddev": True}),
                     ("MQMHASTP", {"query_num": 3}), (pool_type, kwargs)):
        assert (pooling.pooling_output_dim(kind, in_dim, **kw)
                == jax_pooling.pooling_output_dim(kind, in_dim, **kw))


# every backbone that takes `pooling_func`, at small widths where it has them
BACKBONES = {
    "ECAPA_TDNN_c512": {"feat_dim": 16},
    "ResNet18": {"feat_dim": 16},
    "Res2Net34_Base": {"feat_dim": 16},
    "ERes2Net34_Base": {"feat_dim": 16},
    "Gemini_DF_ResNet60": {"feat_dim": 16},
    "CAMPPlus": {"feat_dim": 16},
    "XVEC": {"feat_dim": 16},
    "REPVGG_TINY_A0": {"feat_dim": 16},
    "ReDimNetB0": {"feat_dim": 72},
}


@pytest.mark.parametrize("pool", ["MHASTP", "MQMHASTP"])
def test_backbones_build_with_multi_head_poolings(pool):
    for name, kw in BACKBONES.items():
        if name == "XVEC" and pool == "MQMHASTP":
            continue  # 1,500 channels are no whole number of 8 heads, in JAX too
        model = get_speaker_model(name)(embed_dim=8, pooling_func=pool, **kw)
        pools = [m for m in model.modules() if type(m).__name__ == pool]
        assert len(pools) == 1, name
    # the Whisper-PMFA head (its registry factories keep ASTP, as JAX's do)
    head = whisper_pmfa.WhisperPMFA(output_size=1280, embed_dim=8, pooling_func=pool)
    assert type(head.pooling).__name__ == pool
    config = {"model": "ResNet18", "model_args": {"feat_dim": 16, "embed_dim": 8,
                                                  "pooling_func": pool},
              "projection_args": {"project_type": "sphereface2"}}
    net = build_speaker_net(config, num_class=5)
    assert isinstance(net.projection, projections.SphereFace2)
