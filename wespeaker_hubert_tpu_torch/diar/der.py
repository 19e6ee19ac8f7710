"""Diarization error rate: MISS + FA + speaker confusion, with a
forgiveness collar and the optimal one-to-one speaker map.

Counterpart of `wespeaker_hubert_tpu/diar/der.py` (numpy and scipy,
copied).  WeSpeaker scores DER with SCTK's md-eval.pl (collar 0.25); this
is the same metric in the framework: the timeline cut into elementary
intervals, +-collar around every reference boundary excluded, and a
Hungarian map (scipy's linear_sum_assignment) of hypothesis to reference
speakers maximizing scored overlap.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

__all__ = ["der", "der_details"]

Turn = Tuple[float, float, str]  # (begin, end, speaker)


def _collar_regions(ref: List[Turn], collar: float) -> List[Tuple[float, float]]:
    regions = []
    for b, e, _ in ref:
        regions.append((b - collar, b + collar))
        regions.append((e - collar, e + collar))
    return _merge_intervals(regions)


def _merge_intervals(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    if not iv:
        return []
    iv = sorted(iv)
    out = [list(iv[0])]
    for b, e in iv[1:]:
        if b <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([b, e])
    return [(b, e) for b, e in out]


def _subtract(iv: Tuple[float, float], cuts: List[Tuple[float, float]]):
    """interval minus merged cut list -> remaining pieces."""
    pieces = [iv]
    for cb, ce in cuts:
        nxt = []
        for b, e in pieces:
            if ce <= b or cb >= e:
                nxt.append((b, e))
            else:
                if b < cb:
                    nxt.append((b, cb))
                if ce < e:
                    nxt.append((ce, e))
        pieces = nxt
        if not pieces:
            break
    return pieces


def _events(ref: List[Turn], hyp: List[Turn], cuts):
    """Elementary intervals with constant ref/hyp speaker sets, collar
    regions removed."""
    bounds = set()
    for b, e, _ in ref + hyp:
        bounds.add(b)
        bounds.add(e)
    for b, e in cuts:
        bounds.add(b)
        bounds.add(e)
    bounds = sorted(bounds)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi - lo <= 1e-9:
            continue
        for b, e in _subtract((lo, hi), cuts):
            if e - b <= 1e-9:
                continue
            mid = (b + e) / 2
            r = frozenset(s for tb, te, s in ref if tb <= mid < te)
            h = frozenset(s for tb, te, s in hyp if tb <= mid < te)
            yield (e - b), r, h


def der_details(
    ref_turns: Dict[str, List[Turn]],
    hyp_turns: Dict[str, List[Turn]],
    collar: float = 0.25,
) -> Dict[str, float]:
    """Global DER over all utterances.  Returns dict with miss/fa/conf/
    total (seconds) and 'der'."""
    # ---- global speaker mapping per utt (speakers are per-utt labels)
    # iterate the UNION of utterances: hypothesis-only utts (naming
    # mismatches, hallucinated recordings) must score as false alarm,
    # not silently drop
    miss = fa = conf = total = 0.0
    for utt in sorted(set(ref_turns) | set(hyp_turns)):
        ref = ref_turns.get(utt, [])
        hyp = hyp_turns.get(utt, [])
        cuts = _collar_regions(ref, collar)
        ref_spks = sorted({s for _, _, s in ref})
        hyp_spks = sorted({s for _, _, s in hyp})
        # overlap matrix over scored regions
        overlap = np.zeros((len(ref_spks), len(hyp_spks)))
        events = list(_events(ref, hyp, cuts))
        ri = {s: i for i, s in enumerate(ref_spks)}
        hi = {s: i for i, s in enumerate(hyp_spks)}
        for d, r, h in events:
            for s in r:
                for t in h:
                    overlap[ri[s], hi[t]] += d
        if overlap.size:
            rows, cols = linear_sum_assignment(-overlap)
            mapping = {hyp_spks[c]: ref_spks[r] for r, c in zip(rows, cols)}
        else:
            mapping = {}
        for d, r, h in events:
            n_ref, n_hyp = len(r), len(h)
            mapped = {mapping.get(t) for t in h}
            n_correct = len(r & mapped)
            total += d * n_ref
            miss += d * max(0, n_ref - n_hyp)
            fa += d * max(0, n_hyp - n_ref)
            conf += d * (min(n_ref, n_hyp) - n_correct)
    errors = miss + fa + conf
    if total > 0:
        d = errors / total
    else:
        # no scored reference speech: perfect silence agreement is 0;
        # any hypothesized speech is an unbounded error, not a ratio
        # against epsilon
        d = 0.0 if errors == 0 else float("inf")
    return {
        "miss": miss,
        "fa": fa,
        "confusion": conf,
        "total": total,
        "der": d,
    }


def der(
    ref_turns: Dict[str, List[Turn]],
    hyp_turns: Dict[str, List[Turn]],
    collar: float = 0.25,
) -> float:
    return der_details(ref_turns, hyp_turns, collar)["der"]
