"""PAHC: post-clustering agglomerative repair.

Counterpart of `wespeaker_hubert_tpu/diar/pahc.py` (numpy only, copied;
WeSpeaker's umap_clusterer.py PAHC).  After a density clustering (HDBSCAN)
that may leave unlabeled (-1) points: (1) every unlabeled point becomes a
singleton cluster, (2) cluster pairs whose normalized dot-cost clears
merge_cutoff are merged greedily from a max-heap (two originally-labeled
clusters are never merged: their cost is -inf), (3) clusters smaller than
min_cluster_size are absorbed into the closest major cluster when the
normalized cost clears absorb_cutoff, (4) labels are compacted in
first-appearance order.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from typing import List, Sequence

import numpy as np

__all__ = ["PAHC"]


class PAHC:
    def __init__(
        self,
        merge_cutoff: float = 0.3,
        min_cluster_size: int = 3,
        absorb_cutoff: float = 0.0,
    ):
        self.merge_cutoff = merge_cutoff
        self.min_cluster_size = min_cluster_size
        self.absorb_cutoff = absorb_cutoff

    # ---- public API
    def fit_predict(
        self, labels: Sequence[int], embeddings: np.ndarray
    ) -> List[int]:
        # remap labels to a contiguous 0..K-1 range (noise stays -1):
        # _initialize renumbers noise points starting at num_labeled,
        # which collides with gaps in non-contiguous input labelings
        uniq = sorted({l for l in labels if l != -1})
        remap = {l: i for i, l in enumerate(uniq)}
        labels = [remap.get(l, -1) for l in labels]
        self._initialize(list(labels), np.asarray(embeddings))
        self._merge_all()
        self._absorb()
        return self._relabel()

    # ---- internals
    def _initialize(self, labels, embeddings):
        self.labels = labels
        # pre-normalize embeddings once; cluster cost = dot of summed units
        norms = np.linalg.norm(embeddings, axis=1, keepdims=True)
        self.unit = embeddings / np.maximum(norms, 1e-12)

        self.label_map = defaultdict(list)
        for i, lab in enumerate(labels):
            self.label_map[lab].append(i)
        self.num_labeled = len(self.label_map)
        if -1 in self.label_map:
            self.num_labeled -= 1
            for new_k, idx in zip(
                range(self.num_labeled, self.num_labeled + len(self.label_map[-1])),
                self.label_map[-1],
            ):
                self.label_map[new_k].append(idx)
            del self.label_map[-1]

        n = len(self.label_map)
        self.active = set(range(n))
        self.next_index = n
        self.cost_map = {}
        self.heap = []
        for i in range(n):
            for j in range(i + 1, n):
                if i < self.num_labeled and j < self.num_labeled:
                    self.cost_map[(i, j)] = -np.inf
                    continue
                cost = self._cost(self.label_map[i], self.label_map[j])
                self.cost_map[(i, j)] = cost
                norm_cost = cost / (
                    len(self.label_map[i]) * len(self.label_map[j])
                )
                if norm_cost >= self.merge_cutoff:
                    heapq.heappush(self.heap, (-norm_cost, (i, j)))

    def _cost(self, i_idx, j_idx):
        return float(
            np.dot(self.unit[i_idx].sum(0), self.unit[j_idx].sum(0))
        )

    def _merge_all(self):
        while self.heap:
            _, (i, j) = heapq.heappop(self.heap)
            if i in self.active and j in self.active:
                self._merge(i, j)

    def _merge(self, i, j):
        i_idx, j_idx = self.label_map[i], self.label_map[j]
        for k in list(self.label_map):
            if k in (i, j):
                continue
            pair1 = (k, i) if k < i else (i, k)
            pair2 = (k, j) if k < j else (j, k)
            cost = self.cost_map[pair1] + self.cost_map[pair2]
            self.cost_map[(k, self.next_index)] = cost
            norm_cost = cost / (
                (len(i_idx) + len(j_idx)) * len(self.label_map[k])
            )
            if norm_cost >= self.merge_cutoff:
                heapq.heappush(self.heap, (-norm_cost, (k, self.next_index)))
        self.label_map[self.next_index] = i_idx + j_idx
        self.active.add(self.next_index)
        self._eliminate(i)
        self._eliminate(j)
        self.next_index += 1

    def _eliminate(self, i):
        del self.label_map[i]
        self.active.remove(i)

    def _absorb(self):
        minor = {
            k for k, v in self.label_map.items()
            if len(v) < self.min_cluster_size
        }
        major = set(self.label_map) - minor
        if not major:
            return
        for i in list(minor):
            best_cost, best_j = -np.inf, None
            for j in major:
                pair = (i, j) if i < j else (j, i)
                norm_cost = self.cost_map[pair] / (
                    len(self.label_map[i]) * len(self.label_map[j])
                )
                if norm_cost > best_cost:
                    best_cost, best_j = norm_cost, j
            if best_cost >= self.absorb_cutoff and best_j is not None:
                self.label_map[best_j].extend(self.label_map[i])
                self._eliminate(i)

    def _relabel(self):
        labels = [-1] * len(self.labels)
        for lab, idxs in self.label_map.items():
            for i in idxs:
                labels[i] = lab
        remap, nxt = {}, 0
        for lab in labels:
            if lab not in remap:
                remap[lab] = nxt
                nxt += 1
        return [remap[lab] for lab in labels]
