"""Port parity of the SSL extraction slice end to end: the port's
`bin/extract.extract` on the CPU against the JAX package's
`bin/extract.extract`, one config (HuBERT-tiny frontend with
`attn_impl: flash`, ECAPA_TDNN_GLOB_c512, 16-d), one raw JSONL list of six
wavs over two buckets, the JAX checkpoint carried into the port's `.pt` by
`from_jax_variables`.

Tolerances: float32 cosine >= 0.99999 and atol 1e-4; bf16 cosine >= 0.9999
(the JAX package's bf16 bar, bench.py) against the JAX float32 embeddings.
JAX's own bf16 arithmetic is held against the port's at the make_eval_embed
level in tests/test_torch_port_ssl.py.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_ssl import SECONDS, cosines, randomize, slice_config, write_slice_list
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from wespeaker_hubert_tpu.bin.extract import extract as jax_extract
from wespeaker_hubert_tpu.bin.train import build_speaker_net as jax_build_speaker_net
from wespeaker_hubert_tpu.utils.checkpoint import save_checkpoint
from wespeaker_hubert_tpu.utils.embeddings import load_embeddings as jax_load_embeddings
from wespeaker_hubert_tpu_torch.bin.extract import extract
from wespeaker_hubert_tpu_torch.models.convert_jax import from_jax_variables


@pytest.fixture(scope="module")
def slice_files(tmp_path_factory):
    """The wav list, a JAX checkpoint of seeded random variables and the
    port's .pt made from them."""
    root = tmp_path_factory.mktemp("extract_slice")
    write_slice_list(root)
    config = slice_config()
    net = jax_build_speaker_net(config, num_class=2)
    feat_dim = net.backbone.feat_dim
    shapes = jax.eval_shape(lambda: net.init(
        jax.random.key(0), jnp.zeros((1, 100, feat_dim)), jnp.zeros((1,), jnp.int32), 0.0,
        train=False))
    fshapes = jax.eval_shape(lambda: net.init(
        jax.random.key(1), jnp.zeros((1, 16000)), train=False, method=net.features))
    rng = np.random.default_rng(22)
    variables = {
        "params": {**randomize(shapes["params"], rng), **randomize(fshapes["params"], rng)},
        "batch_stats": randomize(shapes["batch_stats"], rng),
    }
    save_checkpoint(str(root / "model.ckpt"), variables)
    torch.save(from_jax_variables(config["model"], variables), root / "model.pt")
    return root


def _shape_only_init(init):
    """flax `Module.init` giving zeros of the variables' shapes: the JAX
    entry point's eager init (26 of its 37 s on the CPU) only supplies the
    tree that the checkpoint then overwrites, every leaf of it here."""

    def shaped(self, *args, **kwargs):
        shapes = jax.eval_shape(lambda: init(self, *args, **kwargs))
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    return shaped


@pytest.fixture(scope="module")
def jax_slice_embeddings(slice_files):
    """The JAX entry point's float32 embeddings of the list."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Module, "init", _shape_only_init(fnn.Module.init))
        return jax_extract(slice_config(), str(slice_files / "wav.jsonl"),
                           str(slice_files / "model.ckpt"), "", batch_size=4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_extract_matches_jax(slice_files, jax_slice_embeddings, dtype):
    root = slice_files
    config = slice_config("bf16" if dtype == "bf16" else None)
    jkeys, jemb = jax_slice_embeddings
    keys, emb = extract(config, str(root / "wav.jsonl"), str(root / "model.pt"),
                        str(root / f"port_{dtype}.npz"), batch_size=4, device="cpu")
    assert keys == jkeys and sorted(keys) == [f"utt{i}" for i in range(len(SECONDS))]
    assert emb.shape == (len(SECONDS), 16) and np.isfinite(emb).all()
    cos = cosines(emb, jemb)
    if dtype == "f32":
        assert cos.min() >= 0.99999, cos
        np.testing.assert_allclose(emb, jemb, atol=1e-4)
    else:
        assert cos.min() >= 0.9999, cos
    # the same .npz layout: the JAX package's reader takes the port's file
    k, e = jax_load_embeddings(str(root / f"port_{dtype}.npz"))
    assert k == keys and np.array_equal(e, emb)
