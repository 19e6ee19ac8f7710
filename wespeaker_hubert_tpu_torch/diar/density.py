"""Density-based clustering of subsegment embeddings: a 2-D spectral
embedding, HDBSCAN, then PAHC.

Counterpart of `wespeaker_hubert_tpu/diar/density.py` (WeSpeaker's
umap_clusterer.py: UMAP -> HDBSCAN -> PAHC), on the path the JAX package
takes without the `umap` package: a spectral embedding of the cosine
affinity graph in place of UMAP.  Both pieces the JAX package takes from
sklearn are the port's own here, with sklearn's semantics:

- `spectral_embedding`: sklearn.manifold.SpectralEmbedding(
  affinity="precomputed"): the normalized Laplacian (diagonal ignored), its
  smallest eigenvectors (a dense eigh where sklearn runs ARPACK in
  shift-invert mode), each divided by the square root of the degree,
  sklearn's deterministic sign flip, the first dropped;
- `hdbscan`: sklearn.cluster.HDBSCAN(allow_single_cluster=True,
  min_cluster_size=mcs) with its defaults: euclidean core distances with
  min_samples = min_cluster_size (the point itself counted), the mutual
  reachability graph's minimum spanning tree by sklearn's Prim loop and
  its tie-breaking, the single-linkage tree, the condensed tree, and
  excess-of-mass selection.

The `umap` branch of the JAX package is not ported.
"""

from __future__ import annotations

from typing import List

import numpy as np
import scipy.linalg

from .pahc import PAHC

__all__ = ["cluster", "spectral_embedding", "hdbscan"]


def spectral_embedding(affinity: np.ndarray, n_components: int) -> np.ndarray:
    """(N, n_components) Laplacian eigenmap of a dense symmetric affinity."""
    a = np.array(affinity, np.float64)
    np.fill_diagonal(a, 0.0)
    deg = a.sum(axis=0)
    dd = np.sqrt(deg)
    dd[dd == 0] = 1.0
    lap = -(a / dd) / dd[:, None]
    np.fill_diagonal(lap, 1.0)  # sklearn's _set_diag for the normed Laplacian
    _, vecs = scipy.linalg.eigh(lap)
    emb = vecs.T[: n_components + 1] / dd
    signs = np.sign(emb[np.arange(len(emb)), np.argmax(np.abs(emb), axis=1)])
    emb *= signs[:, None]
    return emb[1 : n_components + 1].T


def _reduce(embeddings: np.ndarray) -> np.ndarray:
    """The 2-component spectral embedding of the cosine-affinity graph,
    rows normalized (Ng-Jordan-Weiss style: angular density, like umap's
    cosine metric); PAHC assembles speakers from the over-segmented
    pieces, as in the JAX package."""
    aff = embeddings / np.linalg.norm(embeddings, axis=1, keepdims=True)
    sim = np.clip(0.5 * (1.0 + aff @ aff.T), 0.0, 1.0)
    n_components = int(np.clip(2, 2, len(embeddings) - 2))
    red = spectral_embedding(sim, n_components)
    return red / (np.linalg.norm(red, axis=1, keepdims=True) + 1e-12)


# ---------------------------------------------------------------- HDBSCAN
def _prim_mst(x: np.ndarray, core: np.ndarray) -> np.ndarray:
    """sklearn's mst_from_data_matrix: Prim from node 0 over the mutual
    reachability max(core_i, core_j, |x_i - x_j|); each step takes the
    first node (by index) of least reachability.  Rows (source, next,
    distance)."""
    n = len(x)
    in_tree = np.zeros(n, bool)
    min_reach = np.full(n, np.inf)
    sources = np.ones(n, np.int64)
    edges = np.empty((n - 1, 3))
    cur = 0
    for i in range(n - 1):
        in_tree[cur] = True
        out = np.flatnonzero(~in_tree)
        dist = np.sqrt(((x[cur] - x[out]) ** 2).sum(axis=1))
        mr = np.maximum(np.maximum(core[cur], core[out]), dist)
        better = mr < min_reach[out]
        min_reach[out[better]] = mr[better]
        sources[out[better]] = cur
        j = int(np.argmin(min_reach[out]))
        new = out[j]
        edges[i] = (sources[new], new, min_reach[new])
        cur = new
    return edges


def _single_linkage(edges: np.ndarray, n: int) -> np.ndarray:
    """The MST sorted by distance (numpy's default argsort, as sklearn's)
    -> (n - 1, 4) rows (left, right, distance, size) with union-find
    cluster ids n, n + 1, ..."""
    edges = edges[np.argsort(edges[:, 2])]
    parent = np.arange(2 * n - 1)
    size = np.concatenate([np.ones(n, np.int64), np.zeros(n - 1, np.int64)])

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    out = np.zeros((n - 1, 4))
    for i, (a, b, dist) in enumerate(edges):
        ra, rb = find(int(a)), find(int(b))
        out[i] = (ra, rb, dist, size[ra] + size[rb])
        parent[ra] = parent[rb] = n + i
        size[n + i] = size[ra] + size[rb]
    return out


def _bfs(hierarchy: np.ndarray, root: int, n: int) -> List[int]:
    queue, result = [root], []
    while queue:
        result.extend(queue)
        queue = [x - n for x in queue if x >= n]
        if queue:
            queue = [int(c) for node in queue for c in hierarchy[node, :2]]
    return result


def _condense(hierarchy: np.ndarray, min_cluster_size: int) -> np.ndarray:
    """sklearn's _condense_tree: rows (parent, child, lambda, size)."""
    n = len(hierarchy) + 1
    root = 2 * (n - 1)
    next_label = n + 1
    node_list = _bfs(hierarchy, root, n)
    relabel = np.empty(root + 1, np.int64)
    relabel[root] = n
    rows = []
    ignore = np.zeros(len(node_list), bool)
    for node in node_list:
        if ignore[node] or node < n:
            continue
        left, right, dist, _ = hierarchy[node - n]
        left, right = int(left), int(right)
        lam = 1.0 / dist if dist > 0.0 else np.inf
        left_count = int(hierarchy[left - n, 3]) if left >= n else 1
        right_count = int(hierarchy[right - n, 3]) if right >= n else 1
        if left_count >= min_cluster_size and right_count >= min_cluster_size:
            relabel[left] = next_label
            next_label += 1
            rows.append((relabel[node], relabel[left], lam, left_count))
            relabel[right] = next_label
            next_label += 1
            rows.append((relabel[node], relabel[right], lam, right_count))
            continue
        if left_count < min_cluster_size and right_count >= min_cluster_size:
            relabel[right] = relabel[node]
            dropped = (left,)
        elif right_count < min_cluster_size and left_count >= min_cluster_size:
            relabel[left] = relabel[node]
            dropped = (right,)
        else:
            dropped = (left, right)
        for side in dropped:
            for sub in _bfs(hierarchy, side, n):
                if sub < n:
                    rows.append((relabel[node], sub, lam, 1))
                ignore[sub] = True
    return np.array(rows, dtype=[("parent", np.int64), ("child", np.int64),
                                 ("value", np.float64), ("cluster_size", np.int64)])


def _stability(tree: np.ndarray) -> dict:
    parents = tree["parent"]
    smallest = int(parents.min())
    largest_child = max(int(tree["child"].max()), smallest)
    births = np.full(largest_child + 1, np.nan)
    for row in tree:
        births[row["child"]] = row["value"]
    births[smallest] = 0.0
    result = np.zeros(int(parents.max()) - smallest + 1)
    for row in tree:
        result[row["parent"] - smallest] += (row["value"] - births[row["parent"]]) \
            * row["cluster_size"]
    return {i + smallest: result[i] for i in range(len(result))}


def _bfs_clusters(tree: np.ndarray, root: int) -> List[int]:
    result, queue = [], np.array([root])
    while len(queue):
        result.extend(queue.tolist())
        queue = tree["child"][np.isin(tree["parent"], queue)]
    return result


class _TreeUnionFind:
    """sklearn's TreeUnionFind (union by rank, path compression)."""

    def __init__(self, size):
        self.parent = np.arange(size)
        self.rank = np.zeros(size, np.int64)

    def find(self, x):
        if self.parent[x] != x:
            self.parent[x] = self.find(self.parent[x])
        return self.parent[x]

    def union(self, x, y):
        xr, yr = self.find(x), self.find(y)
        if self.rank[xr] < self.rank[yr]:
            self.parent[xr] = yr
        elif self.rank[xr] > self.rank[yr]:
            self.parent[yr] = xr
        else:
            self.parent[yr] = xr
            self.rank[xr] += 1


def _eom_labels(tree: np.ndarray, stability: dict) -> np.ndarray:
    """sklearn's _get_clusters for 'eom', allow_single_cluster=True,
    cluster_selection_epsilon 0 and no max_cluster_size."""
    node_list = sorted(stability, reverse=True)
    cluster_tree = tree[tree["cluster_size"] > 1]
    is_cluster = {c: True for c in node_list}
    for node in node_list:
        children = cluster_tree["child"][cluster_tree["parent"] == node]
        subtree = np.sum([stability[c] for c in children])
        if subtree > stability[node]:
            is_cluster[node] = False
            stability[node] = subtree
        else:
            for sub in _bfs_clusters(cluster_tree, node):
                if sub != node:
                    is_cluster[sub] = False
    clusters = {c for c in is_cluster if is_cluster[c]}
    label_of = {c: i for i, c in enumerate(sorted(clusters))}

    child, parent, lam = tree["child"], tree["parent"], tree["value"]
    root = int(parent.min())
    uf = _TreeUnionFind(int(parent.max()) + 1)
    for p, c in zip(parent, child):
        if c not in clusters:
            uf.union(p, c)
    labels = np.full(root, -1, np.int64)
    for i in range(root):
        c = uf.find(i)
        if c != root:
            labels[i] = label_of[c]
        elif len(clusters) == 1:
            if lam[child == i] >= lam[parent == c].max():
                labels[i] = label_of[c]
    return labels


def hdbscan(x: np.ndarray, min_cluster_size: int) -> np.ndarray:
    """HDBSCAN labels (-1 for noise) of the rows of `x`."""
    x = np.asarray(x, np.float64)
    n = len(x)
    if n < min_cluster_size:
        raise ValueError(f"min_samples ({min_cluster_size}) must be at most the number "
                         f"of samples ({n})")
    dist = np.sqrt(((x[:, None, :] - x[None, :, :]) ** 2).sum(-1))
    core = np.sort(dist, axis=1)[:, min_cluster_size - 1]
    hierarchy = _single_linkage(_prim_mst(x, core), n)
    tree = _condense(hierarchy, min_cluster_size)
    return _eom_labels(tree, _stability(tree))


def cluster(embeddings: np.ndarray) -> List[int]:
    """Speaker labels of (N, D) subsegment embeddings."""
    embeddings = np.asarray(embeddings)
    # below HDBSCAN's min_cluster_size / min_samples floor (4) there is
    # nothing to cluster: short recordings yield a single speaker
    if len(embeddings) <= 4:
        return [0] * len(embeddings)
    reduced = _reduce(embeddings)
    # the spectral embedding spreads clusters (umap concentrates them), so
    # the floor scales with the recording, bounded so long recordings keep
    # small-speaker sensitivity (the JAX package's calibration)
    mcs = max(4, min(len(embeddings) // 4, 20))
    labels = hdbscan(reduced, min_cluster_size=mcs)
    return PAHC(merge_cutoff=0.3, min_cluster_size=3, absorb_cutoff=0.0).fit_predict(
        labels, embeddings
    )
