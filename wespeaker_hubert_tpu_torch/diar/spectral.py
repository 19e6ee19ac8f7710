"""Spectral clustering of subsegment embeddings.

Counterpart of `wespeaker_hubert_tpu/diar/spectral.py` (WeSpeaker's
diar/spectral_clusterer.py): cosine similarity scaled to [0, 1] -> per-row
p-prune binarization -> unnormalized Laplacian -> eigengap speaker count ->
k-means on the first k eigenvectors.

Two paths, as in the JAX package.  The host path is numpy / scipy (the
similarity, `scipy.linalg.eigh`), then `kmeans`, the port's own k-means
(k-means++ seeding from an explicit `np.random.Generator`, Lloyd
iterations, the best of `n_init` runs by inertia), in place of
`sklearn.cluster.KMeans(n_init=10, random_state=seed)`.  The device path
runs similarity, prune, Laplacian and `torch.linalg.eigh` (cuSOLVER on the
card) on a tensor of `device`; only the (N, k) spectral embedding returns
to the host for the k-means.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import scipy.linalg
import torch

__all__ = ["cluster", "kmeans"]

AUTO_DEVICE_MIN = 2000  # windows from which 'auto' takes the device path


def _cosine_similarity(m: np.ndarray) -> np.ndarray:
    m = m / np.linalg.norm(m, axis=1, keepdims=True)
    return 0.5 * (1.0 + m @ m.T)


def _n_zero(n_rows: int, p: float) -> int:
    """Entries per row the prune sets to 0 (the smallest), the rest to 1."""
    return max(n_rows - 10, 2) if n_rows < 1000 else int((1.0 - p) * n_rows)


def _prune(m: np.ndarray, p: float) -> np.ndarray:
    n_rows = m.shape[0]
    n = _n_zero(n_rows, p)
    out = m.copy()
    order = np.argsort(out, axis=1)
    for i in range(n_rows):
        out[i, order[i, :n]] = 0.0
        out[i, order[i, n:]] = 1.0
    return 0.5 * (out + out.T)


def _laplacian(m: np.ndarray) -> np.ndarray:
    m = m.copy()
    np.fill_diagonal(m, 0.0)
    d = np.diag(np.sum(np.abs(m), axis=1))
    return d - m


def _eigengap_k(eig_values: np.ndarray, num_spks: Optional[int], min_num_spks: int,
                max_num_spks: int) -> int:
    k = (
        num_spks
        if num_spks is not None
        else int(np.argmax(np.diff(eig_values[: max_num_spks + 1])) + 1)
    )
    return max(k, min_num_spks)


def _kmeans_plusplus(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """k-means++ seeding with 2 + log(k) local trials per centre."""
    n = len(x)
    trials = 2 + int(np.log(k))
    centers = np.empty((k, x.shape[1]), x.dtype)
    centers[0] = x[rng.integers(n)]
    closest = ((x - centers[0]) ** 2).sum(1)
    pot = closest.sum()
    for c in range(1, k):
        cand = np.searchsorted(np.cumsum(closest), rng.uniform(size=trials) * pot)
        cand = np.clip(cand, None, n - 1)
        d = ((x[None, :, :] - x[cand][:, None, :]) ** 2).sum(-1)  # (trials, n)
        d = np.minimum(closest[None, :], d)
        pots = d.sum(1)
        best = int(np.argmin(pots))
        centers[c], closest, pot = x[cand[best]], d[best], pots[best]
    return centers


def kmeans(x: np.ndarray, k: int, n_init: int = 10, seed=None) -> np.ndarray:
    """Labels of the best of `n_init` k-means++ / Lloyd runs by inertia
    (at most 300 iterations each, stopping when the labels repeat or the
    centres move less than 1e-4 of the data's mean variance, KMeans'
    defaults).  `seed` is a `np.random.Generator`, an int or None (fresh
    entropy, as KMeans' random_state=None is)."""
    x = np.asarray(x, np.float64)
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    tol_abs = 1e-4 * float(np.mean(np.var(x, axis=0)))
    best_labels, best_inertia = None, np.inf
    for _ in range(n_init):
        centers = _kmeans_plusplus(x, k, rng)
        labels = None
        for _it in range(300):
            d = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
            new_labels = np.argmin(d, axis=1)
            new_centers = centers.copy()
            counts = np.bincount(new_labels, minlength=k)
            for c in range(k):
                if counts[c]:
                    new_centers[c] = x[new_labels == c].mean(0)
                else:  # an empty cluster takes the point farthest from its centre
                    far = int(np.argmax(d[np.arange(len(x)), new_labels]))
                    new_centers[c] = x[far]
            shift = ((new_centers - centers) ** 2).sum()
            centers = new_centers
            if labels is not None and np.array_equal(labels, new_labels):
                break
            labels = new_labels
            if shift <= tol_abs:
                break
        d = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        labels = np.argmin(d, axis=1)
        inertia = float(d[np.arange(len(x)), labels].sum())
        if inertia < best_inertia:
            best_labels, best_inertia = labels, inertia
    return best_labels


def cluster(
    embeddings: np.ndarray,
    p: float = 0.01,
    num_spks: Optional[int] = None,
    min_num_spks: int = 1,
    max_num_spks: int = 20,
    seed=None,
    impl: str = "auto",
    device="cuda",
) -> List[int]:
    """Cluster (N, D) subsegment embeddings into speaker labels.

    impl: 'host' (numpy / scipy, then `kmeans`), 'device' (similarity,
    prune, Laplacian, eigh and the eigengap on `device`: hour-scale
    recordings put thousands of windows through an O(N^3) eigh), or 'auto'
    (the device from AUTO_DEVICE_MIN windows when `device` is a CUDA device
    AND num_spks is fixed).  'auto' never sends the eigengap speaker-count
    ESTIMATE to the device: it compares adjacent float32 eigenvalues of
    another eigensolver and can flip on a near-degenerate gap, which would
    change the speaker count against the host path; pass impl='device' to
    take the device for the estimate too."""
    embeddings = np.asarray(embeddings)
    if len(embeddings) <= 2:
        return [0] * len(embeddings)

    use_device = impl == "device"
    if impl == "auto" and num_spks is not None and len(embeddings) >= AUTO_DEVICE_MIN:
        use_device = torch.device(device).type == "cuda"
    if use_device:
        eig_values, eig_vectors = _spectral_eigh_device(embeddings, p, device)
    else:
        sim = _cosine_similarity(embeddings)
        pruned = _prune(sim, p)
        lap = _laplacian(pruned)
        eig_values, eig_vectors = scipy.linalg.eigh(lap)
    k = _eigengap_k(eig_values, num_spks, min_num_spks, max_num_spks)
    return kmeans(eig_vectors[:, :k], k, n_init=10, seed=seed).tolist()


def _spectral_eigh_device(embeddings: np.ndarray, p: float, device):
    """Similarity -> prune -> Laplacian -> eigh on `device` in float32, as
    the host path computes them (the same prune rule, the unnormalized
    Laplacian, ascending eigenvalues).  Eigenvector signs and rotations
    within a degenerate eigenspace may differ from LAPACK's, which the
    k-means does not see.  Returns the eigenvalues and eigenvectors as
    numpy arrays."""
    n = len(embeddings)
    n_zero = _n_zero(n, p)
    with torch.inference_mode():
        m = torch.as_tensor(np.asarray(embeddings, np.float32), device=device)
        m = m / torch.linalg.norm(m, dim=1, keepdim=True)
        sim = 0.5 * (1.0 + m @ m.T)
        order = torch.argsort(sim, dim=1)
        out = torch.zeros_like(sim).scatter_(1, order[:, n_zero:], 1.0)
        out = 0.5 * (out + out.T)
        out.fill_diagonal_(0.0)
        lap = torch.diag(out.abs().sum(1)) - out
        eig_values, eig_vectors = torch.linalg.eigh(lap)
        return eig_values.cpu().numpy(), eig_vectors.cpu().numpy()
