"""Port parity for the diarization modules (wespeaker_hubert_tpu_torch/diar)
against the JAX package's on numpy-seeded inputs.

Exact for the host modules (RTTM, subsegments, DER, SAD, PAHC, density),
partitions for the spectral path's k-means (the JAX package's comes from
sklearn's KMeans with its own random stream), 1e-6 for its Laplacian and
eigenvalues.  The port's spectral embedding and HDBSCAN, which stand in for
sklearn's, are also held against sklearn directly."""

import functools

import numpy as np
import pytest
import torch

from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from wespeaker_hubert_tpu import diar as jdiar
from wespeaker_hubert_tpu.diar import spectral as jspectral
from wespeaker_hubert_tpu_torch import diar as pdiar
from wespeaker_hubert_tpu_torch.diar import density as pdensity
from wespeaker_hubert_tpu_torch.diar import spectral as pspectral
from wespeaker_hubert_tpu_torch.diar.subsegment import subsegment_windows


def _clusters(rng, n_spk=3, n_per=30, d=32, spread=0.15, noise_points=0):
    centers = rng.standard_normal((n_spk, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    embs = [centers[i] + rng.standard_normal((n_per, d)) * spread for i in range(n_spk)]
    embs.append(rng.standard_normal((noise_points, d)))
    return np.concatenate(embs).astype(np.float32)


def _same_partition(a, b):
    """Equal up to a relabelling."""
    pairs = set(zip(a, b))
    return len(a) == len(b) and len(pairs) == len(set(a)) == len(set(b))


def _turns(rng, n, spk=("A", "B", "C"), t0=0.0):
    out, t = [], t0
    for _ in range(n):
        t += float(rng.uniform(0.0, 0.6))
        d = float(rng.uniform(0.2, 2.5))
        out.append((round(t, 3), round(t + d, 3), str(rng.choice(spk))))
        t += d * float(rng.uniform(0.3, 1.0))
    return sorted(out)


@pytest.mark.parametrize("seed", range(3))
def test_rttm_roundtrip_and_merge(seed, tmp_path):
    rng = np.random.default_rng(seed)
    subsegs = {}
    for utt in ("u1", "u2"):
        items, t = [], 0.0
        for _ in range(12):
            b = round(t, 2)
            e = round(b + float(rng.uniform(0.5, 1.5)), 2)
            items.append((b, e, str(rng.integers(3))))
            t = e - float(rng.choice([0.0, 0.3, -0.2]))
        subsegs[utt] = items
    merged = pdiar.merge_segments(subsegs)
    assert merged == jdiar.merge_segments(subsegs)
    pdiar.write_rttm(str(tmp_path / "p.rttm"), merged)
    jdiar.write_rttm(str(tmp_path / "j.rttm"), merged)
    assert (tmp_path / "p.rttm").read_text() == (tmp_path / "j.rttm").read_text()
    assert pdiar.read_rttm(str(tmp_path / "p.rttm")) == jdiar.read_rttm(str(tmp_path / "j.rttm"))
    labels = tmp_path / "labels"
    labels.write_text("".join(
        f"{u}-{b:08d}-{b + 900:08d}-{s:08d}-{s + 150:08d} {lab}\n"
        for u, b, s, lab in (("x", 0, 0, 1), ("x", 0, 75, 1), ("x", 1200, 0, 2))))
    assert pdiar.read_labels_file(str(labels)) == jdiar.read_labels_file(str(labels))


@pytest.mark.parametrize("seg_ms,frames", [(900, 88), (1500, 148), (4730, 471), (9000, 898),
                                           (3000, 120)])
def test_subsegment_ids_and_windows(seg_ms, frames):
    rng = np.random.default_rng(seg_ms)
    seg_id = pdiar.make_seg_id("utt-a", 1230, 1230 + seg_ms)
    assert seg_id == jdiar.make_seg_id("utt-a", 1230, 1230 + seg_ms)
    feats = rng.standard_normal((frames, 8)).astype(np.float32)
    p_ids, p_win = pdiar.subsegment_fbank(feats, seg_id)
    j_ids, j_win = jdiar.subsegment_fbank(feats, seg_id)
    assert p_ids == j_ids
    for a, b in zip(p_win, j_win):
        np.testing.assert_array_equal(a, b)
    ids, table = subsegment_windows(seg_id, frames)
    assert ids == p_ids
    for (start, m), w in zip(table, p_win):  # the device gather's rule: start + (r mod m)
        want = feats[start + np.arange(150) % max(m, 1)] if m else np.zeros((150, 8))
        np.testing.assert_array_equal(w, want)
    for sub in ids:
        assert pdiar.parse_subseg_id(sub) == jdiar.parse_subseg_id(sub)


DER_CASES = {
    "permutation": ({"u": [(0, 2, "A"), (2, 5, "B")]}, {"u": [(0, 2, "x"), (2, 5, "y")]}),
    "collar": ({"u": [(0, 2, "A"), (2, 5, "B")]}, {"u": [(0.1, 2.2, "y"), (2.2, 5, "x")]}),
    "miss_fa": ({"u": [(0, 4, "A")]}, {"u": [(1, 3, "s"), (5, 6, "s")]}),
    "confusion": ({"u": [(0, 3, "A"), (3, 6, "B"), (6, 9, "A")]},
                  {"u": [(0, 3, "s1"), (3, 9, "s2")]}),
    "overlap": ({"u": [(0, 4, "A"), (2, 6, "B")]}, {"u": [(0, 6, "s")]}),
    "hyp_only_utt": ({"u": [(0, 2, "A")]}, {"u": [(0, 2, "s")], "ghost": [(0, 1.5, "s")]}),
    "empty_reference": ({}, {"u": [(0, 1, "s")]}),
    "both_empty": ({}, {}),
}


@pytest.mark.parametrize("case", sorted(DER_CASES))
@pytest.mark.parametrize("collar", [0.0, 0.25])
def test_der_cases(case, collar):
    ref, hyp = DER_CASES[case]
    assert pdiar.der_details(ref, hyp, collar) == jdiar.der_details(ref, hyp, collar)


@pytest.mark.parametrize("seed", range(4))
def test_der_random_turns(seed):
    rng = np.random.default_rng(seed)
    ref = {u: _turns(rng, 15) for u in ("a", "b")}
    hyp = {u: _turns(rng, 18, spk=("s0", "s1", "s2", "s3")) for u in ("a", "b", "c")}
    for collar in (0.0, 0.25):
        assert pdiar.der_details(ref, hyp, collar) == jdiar.der_details(ref, hyp, collar)
        assert pdiar.der(ref, hyp, collar) == jdiar.der(ref, hyp, collar)


@pytest.mark.parametrize("seed", range(3))
def test_sad(seed):
    rng = np.random.default_rng(seed)
    turns = {"u": _turns(rng, 20), "v": _turns(rng, 6)}
    assert pdiar.oracle_sad(turns) == jdiar.oracle_sad(turns)
    assert pdiar.oracle_sad(turns, 1.0) == jdiar.oracle_sad(turns, 1.0)
    sr, parts = 16000, []
    for _ in range(8):
        n = int(rng.uniform(0.2, 1.5) * sr)
        amp = float(rng.choice([0.0, 1e-4, 0.3]))
        parts.append((amp * rng.standard_normal(n)).astype(np.float32))
    wav = np.concatenate(parts)
    assert pdiar.energy_vad(wav, sr) == jdiar.energy_vad(wav, sr)
    assert pdiar.system_sad(wav, sr) == jdiar.system_sad(wav, sr)


@pytest.mark.parametrize("seed", range(4))
def test_pahc(seed):
    rng = np.random.default_rng(seed)
    emb = _clusters(rng, n_spk=3, n_per=12, noise_points=5)
    labels = rng.choice([-1, 0, 3, 7], size=len(emb)).tolist()
    for kw in ({}, {"merge_cutoff": 0.1, "min_cluster_size": 5, "absorb_cutoff": -0.5}):
        got = pdiar.PAHC(**kw).fit_predict(labels, emb)
        assert got == jdiar.PAHC(**kw).fit_predict(labels, emb)


@pytest.mark.parametrize("n_spk,seed", [(2, 0), (3, 1), (4, 2), (5, 3)])
def test_spectral_host_matches_jax(n_spk, seed, monkeypatch):
    rng = np.random.default_rng(seed)
    emb = _clusters(rng, n_spk=n_spk, n_per=25, spread=0.15)
    sim = pspectral._cosine_similarity(emb)
    lap = pspectral._laplacian(pspectral._prune(sim, 0.01))
    jlap = jspectral._laplacian(jspectral._prune(jspectral._cosine_similarity(emb), 0.01))
    np.testing.assert_allclose(lap, jlap, rtol=0, atol=1e-6)
    import scipy.linalg

    np.testing.assert_allclose(scipy.linalg.eigh(lap)[0], scipy.linalg.eigh(jlap)[0],
                               rtol=0, atol=1e-6)
    want = jspectral.cluster(emb, seed=7)
    assert len(set(want)) == n_spk
    for num_spks in (None, n_spk):
        got = pdiar.spectral_cluster(emb, num_spks=num_spks, seed=7, impl="host")
        assert _same_partition(got, jspectral.cluster(emb, num_spks=num_spks, seed=7))
    assert pdiar.spectral_cluster(emb[:2]) == [0, 0]


@pytest.mark.parametrize("n_spk", [2, 4])
def test_spectral_device_path_on_cpu(n_spk, monkeypatch):
    rng = np.random.default_rng(10 + n_spk)
    emb = _clusters(rng, n_spk=n_spk, n_per=30, spread=0.15)
    host = pdiar.spectral_cluster(emb, num_spks=n_spk, seed=3, impl="host")
    dev = pdiar.spectral_cluster(emb, num_spks=n_spk, seed=3, impl="device", device="cpu")
    assert _same_partition(host, dev)
    # 'auto' takes the device only for a CUDA device, from AUTO_DEVICE_MIN
    # windows, with num_spks fixed: never for the eigengap estimate
    calls = []
    real = pspectral._spectral_eigh_device
    monkeypatch.setattr(pspectral, "_spectral_eigh_device",
                        lambda e, p, device: calls.append(str(device)) or real(e, p, "cpu"))
    pdiar.spectral_cluster(emb, num_spks=n_spk, seed=3, impl="auto", device="cuda")
    assert calls == []  # below AUTO_DEVICE_MIN
    monkeypatch.setattr(pspectral, "AUTO_DEVICE_MIN", 10)
    pdiar.spectral_cluster(emb, seed=3, impl="auto", device="cuda")
    pdiar.spectral_cluster(emb, num_spks=n_spk, seed=3, impl="auto", device="cpu")
    assert calls == []
    got = pdiar.spectral_cluster(emb, num_spks=n_spk, seed=3, impl="auto", device="cuda")
    assert calls == ["cuda"] and _same_partition(got, host)


def test_kmeans_is_seeded_and_finds_blobs():
    rng = np.random.default_rng(5)
    x = _clusters(rng, n_spk=4, n_per=20, d=3, spread=0.05)
    a = pspectral.kmeans(x, 4, seed=11)
    assert np.array_equal(a, pspectral.kmeans(x, 4, seed=np.random.default_rng(11)))
    assert _same_partition(a.tolist(), np.repeat(np.arange(4), 20).tolist())


DENSITY_SETS = [  # (n_spk, n_per, spread, noise points)
    (1, 3, 0.2, 0), (1, 4, 0.2, 0), (2, 10, 0.2, 0), (3, 25, 0.3, 0), (4, 20, 0.3, 3),
    (5, 18, 0.25, 6), (2, 40, 0.5, 0), (3, 8, 0.2, 4),
]


@pytest.mark.parametrize("n_spk,n_per,spread,noise", DENSITY_SETS)
def test_density_matches_jax(n_spk, n_per, spread, noise):
    rng = np.random.default_rng(100 * n_spk + n_per)
    emb = _clusters(rng, n_spk=n_spk, n_per=n_per, spread=spread, noise_points=noise)
    assert pdiar.density_cluster(emb) == jdiar.density_cluster(emb)


@pytest.mark.parametrize("seed", range(6))
def test_hdbscan_and_spectral_embedding_match_sklearn(seed):
    import warnings

    from sklearn.cluster import HDBSCAN
    from sklearn.manifold import SpectralEmbedding

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((int(rng.integers(12, 80)), 2))
    x[: len(x) // 2] += 3.0 * rng.standard_normal(2)
    for mcs in (4, 5, 9):
        want = HDBSCAN(allow_single_cluster=True, min_cluster_size=mcs, copy=True).fit_predict(x)
        np.testing.assert_array_equal(pdensity.hdbscan(x, mcs), want)
    emb = _clusters(rng, n_spk=3, n_per=15, spread=0.4).astype(np.float64)
    aff = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    sim = np.clip(0.5 * (1.0 + aff @ aff.T), 0.0, 1.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = SpectralEmbedding(n_components=2, affinity="precomputed",
                                 random_state=seed).fit_transform(sim)
    np.testing.assert_allclose(pdensity.spectral_embedding(sim, 2), want, rtol=0, atol=1e-6)


def test_jax_spectral_seed_pins_kmeans(monkeypatch):
    """The CPU tests seed the JAX side's KMeans as tests/test_diar_batch.py
    does; unseeded, the port's k-means draws fresh entropy like it."""
    rng = np.random.default_rng(3)
    emb = _clusters(rng, n_spk=3, n_per=10)
    pinned = functools.partial(jdiar.spectral_cluster, seed=7)
    assert pinned(emb) == pinned(emb)
    assert _same_partition(pdiar.spectral_cluster(emb, impl="host"), pinned(emb))
