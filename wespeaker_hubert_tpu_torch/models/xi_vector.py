"""Xi-vector factories: the port's ECAPA-TDNN and XVEC backbones with XI
(Gaussian-posterior) pooling.

Counterpart of `wespeaker_hubert_tpu/models/xi_vector.py`; the names are
the backbones' own, with the pooling under `pool.` (models/pooling.py:XI).
"""

from __future__ import annotations

from .ecapa_tdnn import EcapaTdnn
from .tdnn import XVEC

__all__ = ["XI_VEC_ECAPA_TDNN_c512", "XI_VEC_ECAPA_TDNN_c1024", "XI_VEC_XVEC"]


def XI_VEC_ECAPA_TDNN_c1024(feat_dim, embed_dim, pooling_func="XI", emb_bn=False, **kw):
    return EcapaTdnn(1024, feat_dim, embed_dim, pooling_func, False, emb_bn)


def XI_VEC_ECAPA_TDNN_c512(feat_dim, embed_dim, pooling_func="XI", emb_bn=False, **kw):
    return EcapaTdnn(512, feat_dim, embed_dim, pooling_func, False, emb_bn)


def XI_VEC_XVEC(feat_dim, embed_dim, pooling_func="XI", **kw):
    return XVEC(feat_dim=feat_dim, embed_dim=embed_dim, pooling_func=pooling_func)
