"""Port parity: Res2Net and ERes2Net against the JAX package (CAM++ is
tests/test_torch_port_campplus.py's, with these helpers).

The weights are seeded numpy draws in WeSpeaker's layout, carried into the
JAX package's variable tree by its own converters
(`models/convert_torch.py:res2net_from_torch`, `eres2net_from_torch`,
`campplus_from_torch`) and back into the port by `from_jax_variables`, which
must give back every tensor bit for bit.  Narrow, short models (feat_dim 40,
T 64-70, B 3; Res2Net at 8 and 16 channels, the Base and Large layouts
halved twice, `two_emb_layer` on the Large one; ERes2Net's Base and aug
layouts at 8 channels) run on a padded batch in eval with a ragged mask
(and the full-length row without one), and in train-mode BatchNorm with and
without the mask: the outputs against the JAX module's, in train mode the
running statistics too.

The inputs carry per-utterance feature scales and offsets, so the rows'
pooled statistics differ as utterances' do.

Tolerance, float32: max |port - JAX| <= 1e-5 x max |JAX| in eval.  In train
mode flax's batch statistics (E[x^2] - E[x]^2 in float32, and a BatchNorm
over the 3 rows of pooled embeddings in CAM++'s `dense` and
`two_emb_layer`'s `seg_bn_1`) leave JAX's own float32 further than that
from the exact result, whatever the inputs (CAM++ 1.2e-5 to 1.4e-4 over
three input sets; Res2Net and ERes2Net up to 1.1e-5): there the bar is
1e-5, or twice JAX's distance from the port's float64 forward (norm.py
keeps float64) where that is more, for the port against JAX and against
the float64 forward; JAX's distance itself must stay under 2e-4
(`JAX_CAP`), so no error of the port's can widen the bar far.

Last, CAM++'s segment pooling against avg_pool1d's ceil mode, eagerly and
as a torch.export program with a symbolic T (bin/export_model's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from tests.torch_port_refs import run_jax
from wespeaker_hubert_tpu.models import eres2net as jax_eres2net
from wespeaker_hubert_tpu.models import res2net as jax_res2net
from wespeaker_hubert_tpu.models.convert_torch import eres2net_from_torch, res2net_from_torch
from wespeaker_hubert_tpu_torch.models import eres2net, res2net
from wespeaker_hubert_tpu_torch.models.convert_jax import from_jax_variables

T = torch.from_numpy
REL = 1e-5  # float32: max |port - JAX| <= REL x max |JAX|
JAX_CAP = 2e-4  # JAX's own train-mode float32 distance from the exact forward
FD = 40

# name -> (registry name, JAX module, port module, JAX converter, (B, T))
CASES = {
    "res2net_base": (
        "Res2Net34_Base", lambda: jax_res2net.Res2Net(8, (1, 2, 1, 1), FD, 16),
        lambda: res2net.Res2Net(8, (1, 2, 1, 1), FD, 16),
        lambda sd: res2net_from_torch(sd, (1, 2, 1, 1), 8, FD), (3, 64)),
    "res2net_large": (
        "Res2Net34_Large", lambda: jax_res2net.Res2Net(16, (1, 1, 1, 1), FD, 16, "TSTP", True),
        lambda: res2net.Res2Net(16, (1, 1, 1, 1), FD, 16, "TSTP", True),
        lambda sd: res2net_from_torch(sd, (1, 1, 1, 1), 16, FD, two_emb_layer=True), (3, 70)),
    "eres2net_base": (
        "ERes2Net34_Base", lambda: jax_eres2net.ERes2Net(8, (1, 2, 2, 1), feat_dim=FD,
                                                         embed_dim=16),
        lambda: eres2net.ERes2Net(8, (1, 2, 2, 1), feat_dim=FD, embed_dim=16),
        lambda sd: eres2net_from_torch(sd, 8, (1, 2, 2, 1), feat_dim=FD), (3, 64)),
    "eres2net_aug": (
        "ERes2Net34_aug", lambda: jax_eres2net.ERes2Net(
            8, (1, 1, 1, 1), base_width=24, scale=3, expansion=4, feat_dim=FD, embed_dim=16),
        lambda: eres2net.ERes2Net(8, (1, 1, 1, 1), base_width=24, scale=3, expansion=4,
                                  feat_dim=FD, embed_dim=16),
        lambda sd: eres2net_from_torch(sd, 8, (1, 1, 1, 1), scale=3, expansion=4, feat_dim=FD),
        (3, 70)),
}


def wespeaker_state(module, seed):
    """Seeded numpy draws for a port module's state_dict (WeSpeaker's
    layout): fan-in-scaled weights, BN scale / var in [0.5, 1.5) and biases
    / means near 0, so a swap of any two would show."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in module.state_dict().items():
        if not v.is_floating_point():
            sd[k] = torch.zeros_like(v)
            continue
        if k.endswith(("running_var",)) or (k.endswith("weight") and v.dim() == 1):
            x = rng.uniform(0.5, 1.5, v.shape)
        elif k.endswith("weight"):
            x = rng.normal(0.0, float(np.prod(v.shape[1:])) ** -0.5, v.shape)
        else:  # bias, running_mean
            x = rng.normal(0.0, 0.1, v.shape)
        sd[k] = torch.from_numpy(x.astype(np.float32))
    return sd


def _jax_variables(params, stats):
    return jax.tree.map(jnp.asarray, {"params": params, "batch_stats": stats})


def assert_rel(got, want, rel=REL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, f"{what}: max|d| {err:.3e} vs {rel} x {scale:.3e}"


def _last(out):
    return out[-1] if isinstance(out, tuple) else out


def assert_exact_rule(got, want, exact, what=""):
    """float32 `got` (the port) and `want` (JAX) against `exact` (the port
    in float64): bar = max(REL, 2 x JAX's relative distance from exact)."""
    got, want, exact = (np.asarray(a, np.float64) for a in (got, want, exact))
    scale = float(np.abs(exact).max())
    d_jax = float(np.abs(want - exact).max()) / scale
    assert d_jax <= JAX_CAP, f"{what}: JAX {d_jax:.2e} from the float64 forward"
    bar = max(REL, 2 * d_jax)
    for other, ref in (("JAX", want), ("float64", exact)):
        err = float(np.abs(got - ref).max()) / scale
        assert err <= bar, f"{what}: {err:.2e} from {other}, bar {bar:.2e}"


TRAIN_MODES = ("mask", "full")


def jax_reference(case_spec, kind, modes=TRAIN_MODES):
    """The JAX module's outputs on one padded batch: eval with the ragged
    mask, and train-mode BatchNorm in `modes` (with the mask, without), in
    one jit; the case's weights and inputs beside them."""
    name, jax_module, port_module, to_jax, (b, t) = case_spec
    sd = wespeaker_state(port_module(), seed=len(kind))
    params, stats = to_jax(sd)
    rng = np.random.default_rng(4)
    # per-utterance feature scales and offsets: the rows' pooled statistics
    # differ, as utterances' do, for the BatchNorms over pooled rows
    x = (rng.standard_normal((b, t, FD)) * rng.uniform(0.5, 2.0, (b, 1, FD))
         + rng.normal(0.0, 3.0, (b, 1, FD))).astype(np.float32)
    mask = np.arange(t)[None, :] < np.array([t, t - 37, 41])[:b, None]
    jm = jax_module()

    def reference(variables, x, m):
        out = {"eval": jm.apply(variables, x, mask=m, train=False)}
        for mode in modes:
            y, upd = jm.apply(variables, x, mask=m if mode == "mask" else None, train=True,
                              mutable=["batch_stats"])
            out[mode] = (y, upd["batch_stats"])
        return out

    want = run_jax(reference, _jax_variables(params, stats), jnp.asarray(x), jnp.asarray(mask))
    return dict(kind=kind, name=name, port_module=port_module, sd=sd, params=params,
                stats=stats, x=x, mask=mask, modes=modes, want=jax.device_get(want))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return jax_reference(CASES[request.param], request.param)


def _port(case, train):
    pm = case["port_module"]()
    pm.load_state_dict(from_jax_variables(case["name"], {"params": case["params"],
                                                         "batch_stats": case["stats"]},
                                          feat_dim=FD), strict=True)
    return pm.train(train)


def check_inverse(case):
    back = from_jax_variables(case["name"], {"params": case["params"],
                                             "batch_stats": case["stats"]}, feat_dim=FD)
    assert set(back) == set(case["sd"])
    for k, v in case["sd"].items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def check_eval(case):
    """Eval on the padded batch with its mask; row 0 (full length) also
    without a mask, the port's unmasked path."""
    pm = _port(case, train=False)
    with torch.inference_mode():
        got = _last(pm(T(case["x"]), T(case["mask"])))
        full = _last(pm(T(case["x"][:1])))
    want = _last(case["want"]["eval"])
    assert_rel(got.numpy(), want, what="eval, masked")
    assert_rel(full.numpy(), want[:1], what="eval, row 0 unmasked")
    # the padded rows' embeddings depend on the mask
    with torch.inference_mode():
        unmasked = _last(pm(T(case["x"])))
    assert not torch.allclose(unmasked[1:], got[1:], atol=1e-4)


def check_train_mode(case):
    """Train-mode BatchNorm (flax's batch statistics), with the mask and
    without: the outputs and every running statistic after the forward, by
    the float64 rule."""
    for mode in case["modes"]:
        mask = T(case["mask"]) if mode == "mask" else None
        out = {}
        for dtype in (torch.float32, torch.float64):
            pm = _port(case, train=True).to(dtype)
            with torch.no_grad():
                y = _last(pm(T(case["x"]).to(dtype), mask))
            out[dtype] = (y.numpy(), {k: v.numpy() for k, v in pm.state_dict().items()
                                      if "running_" in k})
        want, stats = case["want"][mode]
        assert_exact_rule(out[torch.float32][0], want, out[torch.float64][0], mode)
        new_stats = from_jax_variables(case["name"], {"params": case["params"],
                                                      "batch_stats": stats}, feat_dim=FD)
        for k, v in out[torch.float32][1].items():
            assert_exact_rule(v, new_stats[k].numpy(), out[torch.float64][1][k], f"{mode} {k}")


def test_from_jax_variables_inverts_jax_from_torch(case):
    check_inverse(case)


def test_eval_matches_jax(case):
    check_eval(case)


def test_train_mode_matches_jax(case):
    check_train_mode(case)


def test_seg_pooling_exports_with_symbolic_time():
    """CAM++'s segment means against avg_pool1d's ceil mode (WeSpeaker's
    form) at lengths around the segment, eagerly and as a torch.export
    program with a symbolic T traced at one length, as bin/export_model
    traces CAM++: the program holds down to a single, partial segment."""
    from wespeaker_hubert_tpu_torch.models.campplus import seg_pooling

    class Strided(torch.nn.Module):  # the time axis after CAM++'s stride-2 TDNN
        def forward(self, x):
            return seg_pooling(x[:, :, ::2])

    def want(x):
        x = x[:, :, ::2]
        seg = torch.nn.functional.avg_pool1d(x, 100, 100, ceil_mode=True)
        return seg.repeat_interleave(100, dim=-1)[..., :x.shape[-1]]

    program = torch.export.export(
        Strided(), (torch.zeros(2, 3, 200),),
        dynamic_shapes={"x": {2: torch.export.Dim("t", min=16, max=1 << 20)}},
        prefer_deferred_runtime_asserts_over_guards=True).module()
    rng = np.random.default_rng(9)
    for t in (16, 199, 200, 201, 202, 401, 517):
        x = T(rng.standard_normal((2, 3, t)).astype(np.float32))
        torch.testing.assert_close(Strided()(x), want(x), rtol=0, atol=1e-6)
        torch.testing.assert_close(program(x), want(x), rtol=0, atol=1e-6)
