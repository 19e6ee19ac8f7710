"""Port parity: ECAPA-TDNN, its pooling and the JAX -> torch weight
converter against the JAX package.

The weights are drawn from numpy for the JAX model's variable tree and
reach the port through `from_jax_variables`.  Tolerances: float32
rtol 1e-4 / atol 1e-4 * max|ref| (sums in another order through ~30
layers); bf16 cosine >= 0.9999, the JAX package's own bar for bf16
embeddings (bench.py)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from wespeaker_hubert_tpu.models import pooling as jax_pooling
from wespeaker_hubert_tpu.models.convert_to_torch import to_torch_state_dict
from wespeaker_hubert_tpu.models.ecapa_tdnn import EcapaTdnn as JaxEcapa
from wespeaker_hubert_tpu.train import cast_variables_bf16 as jax_cast_bf16
from wespeaker_hubert_tpu_torch.models import pooling
from wespeaker_hubert_tpu_torch.models.convert_jax import from_jax_variables
from wespeaker_hubert_tpu_torch.models.ecapa_tdnn import EcapaTdnn
from wespeaker_hubert_tpu_torch.models.registry import get_speaker_model
from wespeaker_hubert_tpu_torch.models.speaker_net import build_speaker_net
from wespeaker_hubert_tpu_torch.train.executor import cast_variables_bf16


def random_variables(shapes, seed):
    """Numpy draws for a flax variable tree of `shapes`: lecun-normal
    kernels, and BN scale/bias/mean/var and biases away from flax's 0 / 1
    init, which would hide a mean/var or scale/bias swap."""
    rng = np.random.default_rng(seed)

    def visit(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = visit(v)
                continue
            if k == "kernel":
                fan_in = int(np.prod(v.shape[:-1]))
                x = rng.normal(0.0, fan_in**-0.5, v.shape)
            elif k in ("scale", "var"):
                x = rng.uniform(0.5, 1.5, v.shape)
            else:  # bias, mean
                x = rng.normal(0.0, 0.1, v.shape)
            out[k] = x.astype(np.float32)
        return out

    return visit(dict(shapes))


def jax_ecapa(channels, feat_dim, embed_dim, glob, emb_bn=False, t=50, seed=0):
    """(jitted apply(variables, x, mask), random variables)."""
    model = JaxEcapa(channels, feat_dim, embed_dim, "ASTP", glob, emb_bn)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.key(0), jnp.zeros((1, t, feat_dim)), train=False)
    )
    apply = jax.jit(lambda v, x, mask: model.apply(v, x, mask=mask, train=False))
    return apply, random_variables(shapes, seed)


def port_ecapa(name, variables, channels, feat_dim, embed_dim, glob, emb_bn=False):
    model = EcapaTdnn(channels, feat_dim, embed_dim, "ASTP", glob, emb_bn).eval()
    model.load_state_dict(from_jax_variables(name, variables), strict=True)
    return model


def _cos_rows(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.sum(a * b, 1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def _assert_f32_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=1e-4, atol=1e-4 * np.abs(want).max()
    )


CASES = [
    # (name, channels, feat_dim, embed_dim, glob, emb_bn, (B, T))
    ("ECAPA_TDNN_c512", 32, 40, 16, False, False, (3, 60)),
    ("ECAPA_TDNN_GLOB_c512", 32, 40, 16, True, True, (3, 60)),
]
FULL_WIDTH = ("ECAPA_TDNN_GLOB_c512", 512, 80, 192, True, False, (2, 198))


def _make_case(param):
    name, ch, fd, ed, glob, emb_bn, (b, t) = param
    japply, variables = jax_ecapa(ch, fd, ed, glob, emb_bn, t=t)
    pmodel = port_ecapa(name, variables, ch, fd, ed, glob, emb_bn)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, t, fd)).astype(np.float32)
    lengths = np.linspace(t, t // 3, b).astype(np.int32)
    mask = np.arange(t)[None, :] < lengths[:, None]
    return dict(name=name, japply=japply, variables=variables, pmodel=pmodel,
                x=x, mask=mask)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-ch{c[1]}")
def case(request):
    return _make_case(request.param)


@pytest.mark.parametrize("masked", [False, True])
def test_f32_matches_jax(case, masked):
    x, mask = case["x"], case["mask"] if masked else None
    want = case["japply"](
        case["variables"], jnp.asarray(x),
        None if mask is None else jnp.asarray(mask),
    )
    with torch.inference_mode():
        got = case["pmodel"](
            torch.from_numpy(x), None if mask is None else torch.from_numpy(mask)
        )
    assert got.dtype == torch.float32
    _assert_f32_close(got.numpy(), want)


def test_bf16_cosine(case):
    x, mask = case["x"], case["mask"]
    want = case["japply"](
        jax_cast_bf16(case["variables"]), jnp.asarray(x, jnp.bfloat16),
        jnp.asarray(mask),
    )
    model = cast_variables_bf16(copy.deepcopy(case["pmodel"]))
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert all(
        b.dtype == torch.bfloat16 for k, b in model.named_buffers()
        if not k.endswith("num_batches_tracked")
    )
    with torch.inference_mode():
        got = model(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    cos = _cos_rows(got.float().numpy(), np.asarray(want, np.float32))
    assert cos.min() >= 0.9999, cos


def test_converter_matches_jax_package_export(case):
    got = from_jax_variables(case["name"], case["variables"])
    want = to_torch_state_dict(
        case["name"], case["variables"], template_sd=case["pmodel"].state_dict()
    )
    assert set(got) == set(want) == set(case["pmodel"].state_dict())
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


def test_full_width_glob_c512():
    """The served model at its published widths, once: masked float32 and
    the converter against the JAX package's export."""
    c = _make_case(FULL_WIDTH)
    test_f32_matches_jax(c, masked=True)
    test_converter_matches_jax_package_export(c)


def test_converter_takes_speaker_net_tree(case):
    """A SpeakerNet tree gives the backbone's keys as the bare tree does,
    plus the margin head's (D, C) weight as WeSpeaker's (C, D)
    `projection.weight`."""
    variables = case["variables"]
    head = np.arange(16, dtype=np.float32).reshape(8, 2)
    net_vars = {
        "params": {"backbone": variables["params"], "projection": {"weight": head}},
        "batch_stats": {"backbone": variables["batch_stats"]},
    }
    bare = from_jax_variables(case["name"], variables)
    wrapped = from_jax_variables(case["name"], net_vars)
    assert set(wrapped) == set(bare) | {"projection.weight"}
    for k in bare:
        assert torch.equal(bare[k], wrapped[k])
    assert torch.equal(wrapped["projection.weight"], torch.from_numpy(head.T.copy()))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pool", ["TAP", "TSDP", "TSTP"])
def test_statistics_pooling_matches_jax(pool, masked):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 20, 6)).astype(np.float32)
    mask = (np.arange(20)[None, :] < np.array([[20], [9], [1]])) if masked else None
    want = jax_pooling.POOLING_LAYERS[pool](in_dim=6).apply(
        {}, jnp.asarray(x), mask=None if mask is None else jnp.asarray(mask)
    )
    got = pooling.POOLING_LAYERS[pool](in_dim=6)(
        torch.from_numpy(x).transpose(1, 2),
        None if mask is None else torch.from_numpy(mask),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_registry_and_build():
    assert get_speaker_model("ecapa_tdnn_glob_c512") is get_speaker_model(
        "ECAPA_TDNN_GLOB_c512"
    )
    with pytest.raises(ValueError, match="unknown model"):
        get_speaker_model("ReDimNetB2")  # not ported yet (ROADMAP.md queue 1, item 2)
    net = build_speaker_net({
        "model": "ECAPA_TDNN_c1024",
        "model_args": {"feat_dim": 24, "embed_dim": 8},
    })
    assert net.backbone.layer1.conv.weight.shape == (1024, 24, 5)
    assert net.backbone.conv.weight.shape == (1536, 3072, 1)
    with pytest.raises(NotImplementedError, match="not ported"):
        build_speaker_net({"model": "ECAPA_TDNN_c512",
                           "dataset_args": {"frontend": "whisper_encoder",
                                            "whisper_encoder_args": {"pipeline_parallel": 4}}})
