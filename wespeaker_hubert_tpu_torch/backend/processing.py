"""Composable embedding processing chain: mean-subtract | length-norm |
lda | whitening, in float64 on the device.

Counterpart of `wespeaker_hubert_tpu/backend/processing.py`: the same chain
strings ("mean-subtract | length-norm | lda --dim 100 | length-norm"), links
and `.npz` layout, so a chain saved by either package loads in the other.
Each link is a float64 torch function of (N, D) rows on the chain's device.
LDA's per-speaker statistics are segment sums over a speaker index
(`index_add_`) and one GEMM per chunk of rows, where the JAX package forms a
covariance per speaker; the eigendecompositions are `torch.linalg.eigh`.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .plda import ROW_CHUNK, Array, _f64, _index

__all__ = ["EmbeddingProcessingChain", "parse_chain_string"]


def parse_chain_string(chain_string: Optional[str]):
    """'method --k v --k2 v2 | method2 ...' -> [[method, {k: v}], ...]."""
    if not chain_string:
        return []
    out = []
    for link in chain_string.split("|"):
        parts = link.split("--")
        method = parts.pop(0).strip()
        args = {}
        for p in parts:
            p = re.sub("=", " ", p)
            p = re.sub(" +", " ", p).strip()
            k, v = p.split(" ")
            args[k] = v
        out.append([method, args])
    return out


class _MeanSubtraction:
    def __init__(self, mean: torch.Tensor):
        self.mean = mean

    def __call__(self, embd):
        return embd - self.mean

    def state(self):
        return {"mean": self.mean}


class _LengthNorm:
    def __call__(self, embd):
        return embd / torch.sqrt((embd ** 2).sum(dim=1, keepdim=True))

    def state(self):
        return {}


def _eigh_floored(cov: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ascending eigenpairs of cov, eigenvalues floored at max(e) * eps."""
    e, m = torch.linalg.eigh(cov)
    return torch.clamp_min(e, float(e.max()) * eps), m


class _Lda:
    """Within-class-whitened LDA with Kaldi's eigenvalue floor."""

    def __init__(self, mean: torch.Tensor, lda: torch.Tensor):
        self.m = mean
        self.lda = lda

    @staticmethod
    def fit(spk_to_embeddings: Dict[str, Array], dim: int, eps: float = 1e-6,
            equal_speaker_weight: bool = False, device="cuda") -> "_Lda":
        mats = [np.atleast_2d(np.asarray(v)) for v in spk_to_embeddings.values()]
        labels = np.repeat(np.arange(len(mats)), [len(m) for m in mats])
        return _Lda.fit_rows(_f64(np.concatenate(mats), resolve_device(device)), labels, dim,
                             eps, equal_speaker_weight)

    @staticmethod
    def fit_rows(x: torch.Tensor, labels: Array, dim: int, eps: float = 1e-6,
                 equal_speaker_weight: bool = False) -> "_Lda":
        """Fit on float64 rows x (N, D) of speakers labels[i] in 0..S-1;
        speakers with one row are left out, as the JAX package does."""
        idx = _index(labels, x.device)
        n_spk = int(idx.max()) + 1
        counts = torch.bincount(idx, minlength=n_spk).to(torch.float64)
        sums = torch.zeros(n_spk, x.shape[1], dtype=torch.float64, device=x.device)
        sums.index_add_(0, idx, x)
        means = sums / counts.clamp_min(1.0)[:, None]
        keep = counts > 1
        # within scatter sum_s sum_i (x - m_s)(x - m_s)^T, each row weighted
        # 1 (count-weighted) or 1 / n_s (equal speaker weight); singletons out
        row_w = torch.where(keep, 1.0 / counts if equal_speaker_weight else
                            torch.ones_like(counts), torch.zeros_like(counts))
        scatter = torch.zeros(x.shape[1], x.shape[1], dtype=torch.float64, device=x.device)
        for s in range(0, len(x), ROW_CHUNK):
            i = idx[s:s + ROW_CHUNK]
            diff = (x[s:s + ROW_CHUNK] - means[i]) * torch.sqrt(row_w[i])[:, None]
            scatter += diff.T @ diff
        counts, means = counts[keep], means[keep]
        if equal_speaker_weight:
            mean = means.mean(0)
            c = means - mean
            bc = c.T @ c / len(means)
            wc = scatter / len(counts)
        else:
            mean = (counts[:, None] * means).sum(0) / counts.sum()
            c = means - mean
            bc = (c * counts[:, None]).T @ c / counts.sum()
            wc = scatter / counts.sum()
        e, m = _eigh_floored(wc, eps)
        t1 = (1.0 / torch.sqrt(e))[:, None] * m.T
        bc_w = t1 @ bc @ t1.T
        _, lda_vecs = torch.linalg.eigh(0.5 * (bc_w + bc_w.T))
        return _Lda(mean, t1.T @ lda_vecs[:, -dim:])

    def __call__(self, embd):
        return (embd - self.m) @ self.lda

    def state(self):
        return {"mean": self.m, "lda": self.lda}


class _Whitening:
    """ZCA whitening on the training distribution."""

    def __init__(self, mean: torch.Tensor, transform: torch.Tensor):
        self.mean = mean
        self.transform = transform

    @staticmethod
    def fit(x: torch.Tensor, eps: float = 1e-6) -> "_Whitening":
        mean = x.mean(0)
        c = x - mean
        c = c - c.mean(0)
        e, v = _eigh_floored(c.T @ c / len(c), eps)
        return _Whitening(mean, v @ torch.diag(1.0 / torch.sqrt(e)) @ v.T)

    def __call__(self, embd):
        return (embd - self.mean) @ self.transform

    def state(self):
        return {"mean": self.mean, "transform": self.transform}


class EmbeddingProcessingChain:
    """Fitted from a chain string and training rows, applied to embeddings,
    saved as `.npz`.  Calling it returns float64 rows on its device."""

    def __init__(self, links=None, device="cuda"):
        self.device = resolve_device(device)
        self.links: List[Tuple[str, object]] = links or []

    def __call__(self, embd: Array) -> torch.Tensor:
        embd = torch.atleast_2d(_f64(embd, self.device))
        for _, fn in self.links:
            embd = fn(embd)
        return embd

    # ---- fitting
    def fit(
        self,
        chain_string: str,
        embeddings: Array,
        utt2spk: Optional[Dict[str, str]] = None,
        keys: Optional[Sequence[str]] = None,
    ) -> "EmbeddingProcessingChain":
        """Fit each link on the training rows as the links before it
        transformed them.  LDA's speakers are `utt2spk` of `keys`, in the
        order they first appear; rows without a speaker are left out."""
        spec = parse_chain_string(chain_string)
        self.links = []
        current = torch.atleast_2d(_f64(embeddings, self.device))
        for method, args in spec:
            if method == "mean-subtract":
                link = _MeanSubtraction(current.mean(0))
            elif method == "length-norm":
                link = _LengthNorm()
            elif method == "lda":
                if utt2spk is None or keys is None:
                    raise ValueError("lda needs utt2spk and keys")
                spk = [utt2spk.get(k) for k in keys]
                have = torch.as_tensor(np.asarray([s is not None for s in spk]))
                order: Dict[str, int] = {}
                labels = np.asarray([order.setdefault(s, len(order))
                                     for s in spk if s is not None], np.int64)
                link = _Lda.fit_rows(current[have.to(self.device)], labels,
                                     dim=int(args.get("dim", current.shape[1])),
                                     eps=float(args.get("eps", 1e-6)))
            elif method == "whitening":
                link = _Whitening.fit(current)
            else:
                raise ValueError(f"unknown chain link {method!r}")
            self.links.append((method, link))
            current = link(current)
        return self

    # ---- persistence
    def save(self, path: str) -> None:
        arrays, spec = {}, []
        for i, (method, fn) in enumerate(self.links):
            spec.append(method)
            for k, v in fn.state().items():
                arrays[f"{i}_{k}"] = v.cpu().numpy()
        np.savez(path, spec=np.asarray(spec), **arrays)

    @staticmethod
    def load(path: str, device="cuda") -> "EmbeddingProcessingChain":
        dev = resolve_device(device)
        data = np.load(path, allow_pickle=False)
        links = []

        def arr(name):
            return _f64(data[name], dev)

        for i, method in enumerate(str(m) for m in data["spec"]):
            if method == "mean-subtract":
                links.append((method, _MeanSubtraction(arr(f"{i}_mean"))))
            elif method == "length-norm":
                links.append((method, _LengthNorm()))
            elif method == "lda":
                links.append((method, _Lda(arr(f"{i}_mean"), arr(f"{i}_lda"))))
            elif method == "whitening":
                links.append((method, _Whitening(arr(f"{i}_mean"), arr(f"{i}_transform"))))
        return EmbeddingProcessingChain(links, device=dev)
