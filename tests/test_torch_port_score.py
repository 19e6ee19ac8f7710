"""Port parity: the back end of the speaker-verification recipe against the
JAX package on the CPU, at a small seeded size.

Cosine trial scores (1e-5), cohort means and stds (1e-6), AS-Norm (2e-4),
the numbers of both packages' score files (atol 1.1e-5: one rounding flip at
`{:.5f}`), the EER and minDCF of JAX's score files (exact), QMF's Cllr fit
(1e-8) and its trial generator (the same file), and checkpoint averaging
(bit for bit against `from_jax_variables` of JAX's average).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from wespeaker_hubert_tpu.backend import calibration as jax_cal
from wespeaker_hubert_tpu.backend import score as jax_score
from wespeaker_hubert_tpu.bin import score as jax_bin_score
from wespeaker_hubert_tpu.bin import tools as jax_tools
from wespeaker_hubert_tpu.models.ecapa_tdnn import EcapaTdnn as JaxEcapa
from wespeaker_hubert_tpu.models.projections import ArcMarginProduct as JaxArcMargin
from wespeaker_hubert_tpu.utils import checkpoint as jax_ckpt
from wespeaker_hubert_tpu.utils.embeddings import save_embeddings as jax_save_embeddings
from wespeaker_hubert_tpu_torch.backend import calibration, score
from wespeaker_hubert_tpu_torch.bin import score as bin_score
from wespeaker_hubert_tpu_torch.bin import tools
from wespeaker_hubert_tpu_torch.bin.average_model import average_model
from wespeaker_hubert_tpu_torch.models.convert_jax import from_jax_variables
from wespeaker_hubert_tpu_torch.utils.checkpoint import average_checkpoints, save_checkpoint
from wespeaker_hubert_tpu_torch.utils.embeddings import (embeddings_dict, save_embeddings,
                                                      speaker_means)

N_SPK, PER_SPK, DIM = 12, 5, 16


def _embedding_set(seed=0):
    """Utterance embeddings with speaker structure: a speaker direction
    plus per-utterance noise, so the EER is neither 0 nor 50 %."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((N_SPK, DIM))
    keys, emb, utt2spk = [], [], {}
    for s in range(N_SPK):
        for u in range(PER_SPK):
            k = f"spk{s:02d}-u{u}"
            keys.append(k)
            emb.append(centers[s] + 1.3 * rng.standard_normal(DIM))
            utt2spk[k] = f"spk{s:02d}"
    return keys, np.asarray(emb, np.float32), utt2spk


def _trials(keys, utt2spk, n=400, seed=1):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        a, b = rng.choice(len(keys), 2, replace=False)
        lab = "target" if utt2spk[keys[a]] == utt2spk[keys[b]] else "nontarget"
        rows.append((keys[a], keys[b], lab))
    return rows


@pytest.fixture(scope="module")
def score_files(tmp_path_factory):
    """Both packages' cosine and AS-Norm score files over one seeded set."""
    root = tmp_path_factory.mktemp("score")
    keys, emb, utt2spk = _embedding_set()
    emb_path = str(root / "eval.npz")
    save_embeddings(emb_path, keys, emb)
    spks, means = speaker_means(keys, emb, utt2spk)
    cohort_path = str(root / "cohort.npz")
    save_embeddings(cohort_path, spks, means)
    mean_path = str(root / "mean.npy")
    np.save(mean_path, emb.mean(0))
    trial = root / "trials.kaldi"
    trial.write_text("".join(f"{a} {b} {lab}\n" for a, b, lab in _trials(keys, utt2spk)))
    out = {}
    for tag, mod, kw in (("jax", jax_bin_score, {}), ("port", bin_score, {"device": "cpu"})):
        d = root / tag
        sf = mod.score_trials(emb_path, [str(trial)], str(d), mean_path, **kw)[0]
        nf = mod.score_norm(sf, sf + ".asnorm", emb_path, cohort_path, top_n=7,
                            mean_vec_path=mean_path, **kw)
        out[tag] = (sf, nf)
    return {"emb": emb, "keys": keys, "utt2spk": utt2spk, "means": means,
            "mean_vec": emb.mean(0), "files": out}


def test_trial_scores_and_cohort_stats_match_jax(score_files, monkeypatch):
    emb, mean_vec = score_files["emb"], score_files["mean_vec"]
    rng = np.random.default_rng(2)
    e_idx, t_idx = rng.integers(0, len(emb), 300), rng.integers(0, len(emb), 300)
    want = jax_score.trial_cosine_scores(emb, e_idx, t_idx, mean_vec=mean_vec)
    got = score.trial_cosine_scores(emb, e_idx, t_idx, mean_vec=mean_vec, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        score.cosine_scores(torch.from_numpy(emb[e_idx]), torch.from_numpy(emb[t_idx])).numpy(),
        np.asarray(jax_score.cosine_scores(jnp.asarray(emb[e_idx]), jnp.asarray(emb[t_idx]))),
        rtol=0, atol=1e-5)
    cohort = score_files["means"] - mean_vec
    monkeypatch.setattr(score, "COHORT_ROW_BLOCK", 17)  # several row blocks
    for top_n in (5, 100):  # 100 is clamped to the cohort's 12 (S-Norm)
        jm, js = jax_score.cohort_mean_std(emb - mean_vec, cohort, top_n)
        pm, ps = score.cohort_mean_std(emb - mean_vec, cohort, top_n, device="cpu")
        np.testing.assert_allclose(pm, np.asarray(jm), rtol=0, atol=1e-6)
        np.testing.assert_allclose(ps, np.asarray(js), rtol=0, atol=1e-6)
    raw = want
    jn = jax_score.apply_asnorm(raw, e_idx, t_idx, np.asarray(jm), np.asarray(js),
                                np.asarray(jm), np.asarray(js))
    pn = score.apply_asnorm(raw, e_idx, t_idx, pm, ps, pm, ps)
    np.testing.assert_allclose(pn, jn, rtol=0, atol=2e-4)
    with pytest.raises(NotImplementedError, match="queue 1, data parallelism"):
        score.cohort_mean_std(emb, cohort, 5, device="cpu", mesh=object())


def _columns(path):
    rows = [ln.split() for ln in open(path)]
    names = [(r[0], r[1], r[3] if len(r) > 3 else None) for r in rows]
    nums = np.asarray([[float(x) for i, x in enumerate(r) if i >= 2 and i != 3] for r in rows])
    return names, nums


# per column of the score files: the bar of the number it holds plus one
# rounding flip of its format ({:.5f} scores, {:.4f} magnitudes and cohort
# means); the AS-Norm score's own bar is 2e-4
FILE_ATOL = {"cosine": [1.1e-5], "asnorm": [2e-4 + 1e-5] + [1.1e-4] * 4}


@pytest.mark.parametrize("which", ["cosine", "asnorm"])
def test_score_files_match_jax(score_files, which):
    i = 0 if which == "cosine" else 1
    jnames, jnums = _columns(score_files["files"]["jax"][i])
    pnames, pnums = _columns(score_files["files"]["port"][i])
    assert pnames == jnames
    assert pnums.shape == jnums.shape == ((400, 1) if which == "cosine" else (400, 5))
    for col, atol in enumerate(FILE_ATOL[which]):
        np.testing.assert_allclose(pnums[:, col], jnums[:, col], rtol=0, atol=atol,
                                   err_msg=f"column {col}")


def test_metrics_match_jax_exactly(score_files):
    eers = []
    for path in score_files["files"]["jax"]:
        got, want = bin_score.compute_metrics(path), jax_bin_score.compute_metrics(path)
        assert got == want
        eers.append(got[0])
    assert all(5.0 < e < 45.0 for e in eers), eers  # the set has speaker structure
    scores = np.asarray([float(ln.split()[2]) for ln in open(score_files["files"]["jax"][0])])
    labels = np.asarray([ln.split()[3] == "target" for ln in open(score_files["files"]["jax"][0])])
    from wespeaker_hubert_tpu.backend import metrics as jax_metrics
    from wespeaker_hubert_tpu_torch.backend import metrics

    assert metrics.eer_from_scores(scores, labels) == jax_metrics.eer_from_scores(scores, labels)
    fnr, fpr = metrics.compute_pmiss_pfa(scores, labels)
    for got, want in zip(metrics.det_points(fnr, fpr), jax_metrics.det_points(fnr, fpr)):
        np.testing.assert_array_equal(got, want)


def test_qmf_calibration_matches_jax(score_files, tmp_path):
    keys, utt2spk = score_files["keys"], score_files["utt2spk"]
    rng = np.random.default_rng(4)
    durs = {k: float(rng.choice([2.5, 3.2, 4.9, 6.5, 7.7, 12.0])) for k in keys}
    (tmp_path / "utt2dur").write_text("".join(f"{k} {d:.3f}\n" for k, d in durs.items()))
    (tmp_path / "utt2spk").write_text("".join(f"{k} {s}\n" for k, s in utt2spk.items()))
    for mod, name in ((jax_tools, "jax.trials"), (tools, "port.trials")):
        n = mod.generate_calibration_trial(str(tmp_path / "utt2dur"), str(tmp_path / "utt2spk"),
                                           str(tmp_path / name), each_trial_num=300, seed=5)
        assert n == 900
    assert (tmp_path / "port.trials").read_text() == (tmp_path / "jax.trials").read_text()
    lines = open(score_files["files"]["jax"][1]).readlines()
    jf, jmeta = jax_cal.gather_factors(lines, durs)
    pf, pmeta = calibration.gather_factors(lines, durs)
    assert pmeta == jmeta
    np.testing.assert_array_equal(pf, jf)
    labels = np.asarray([m[2] == "target" for m in jmeta], np.int32)
    jp, jl = jax_cal.train_calibration(jf, labels)
    pp, pl = calibration.train_calibration(pf, labels)
    np.testing.assert_allclose(pp, jp, rtol=0, atol=1e-8)
    assert abs(pl - jl) <= 1e-8 and pl < calibration.cllr(pf[labels == 1, 0], pf[labels == 0, 0])
    np.testing.assert_allclose(calibration.apply_calibration(pp, pf),
                               jax_cal.apply_calibration(jp, jf), rtol=0, atol=1e-8)


def _jax_ecapa_variables(seed):
    from tests.test_torch_port_train import _randomize

    net = JaxEcapa(32, 24, 16, "ASTP", True, False)
    shapes = jax.eval_shape(lambda: net.init(jax.random.key(0), jnp.zeros((1, 40, 24)),
                                             train=False))
    head = jax.eval_shape(lambda: JaxArcMargin(16, 9, 32.0).init(
        jax.random.key(0), jnp.zeros((1, 16)), jnp.zeros((1,), jnp.int32), 0.0))
    rng = np.random.default_rng(seed)
    return {"params": {"backbone": _randomize(shapes["params"], rng),
                       "projection": _randomize(head["params"], rng)},
            "batch_stats": {"backbone": _randomize(shapes["batch_stats"], rng)}}


def test_average_checkpoints_matches_jax(tmp_path):
    """Three seeded ECAPA + ArcMargin variable trees: JAX averages its
    `.ckpt` files, the port the converted `.pt` files; the port's average
    equals the conversion of JAX's bit for bit, names included, and
    bin/average_model takes the last `num` epochs."""
    trees = [_jax_ecapa_variables(seed) for seed in (11, 12, 13)]
    jpaths, ppaths = [], []
    for i, tree in enumerate(trees, 1):
        jpaths.append(str(tmp_path / f"model_{i}.ckpt"))
        jax_ckpt.save_checkpoint(jpaths[-1], tree)
        sd = from_jax_variables("ECAPA_TDNN_GLOB_c512", tree)
        sd["bn.num_batches_tracked"] = torch.tensor(10 * i)
        ppaths.append(str(tmp_path / f"model_{i}.pt"))
        save_checkpoint(ppaths[-1], sd)
    want = from_jax_variables("ECAPA_TDNN_GLOB_c512", jax_ckpt.average_checkpoints(jpaths))
    got = average_checkpoints(ppaths)
    assert int(got.pop("bn.num_batches_tracked")) == 30  # integers: the last file's
    want.pop("bn.num_batches_tracked")
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    dst = average_model(str(tmp_path), str(tmp_path / "avg_model.pt"), num=2)
    last_two = average_checkpoints(ppaths[1:])
    saved = torch.load(dst, weights_only=True)
    assert all(torch.equal(saved[k], last_two[k]) for k in last_two)
    with pytest.raises(FileNotFoundError):
        average_model(str(tmp_path), str(tmp_path / "x.pt"), min_epoch=7)


def test_speaker_means_and_vector_mean_match_jax(score_files, tmp_path):
    from wespeaker_hubert_tpu.utils.embeddings import embeddings_dict as jax_embeddings_dict
    from wespeaker_hubert_tpu.utils.embeddings import speaker_means as jax_speaker_means

    keys, emb, utt2spk = score_files["keys"], score_files["emb"], score_files["utt2spk"]
    jspks, jmeans = jax_speaker_means(keys, emb, utt2spk)
    pspks, pmeans = speaker_means(keys, emb, utt2spk)
    assert pspks == jspks
    np.testing.assert_array_equal(pmeans, jmeans)
    (tmp_path / "utt2spk").write_text("".join(f"{k} {s}\n" for k, s in utt2spk.items()))
    jax_save_embeddings(str(tmp_path / "e.npz"), keys, emb)
    for mod, out in ((jax_tools, "j.npz"), (tools, "p.npz")):
        assert mod.vector_mean(str(tmp_path / "e.npz"), str(tmp_path / "utt2spk"),
                               str(tmp_path / out)) == N_SPK
    j, p = np.load(tmp_path / "j.npz"), np.load(tmp_path / "p.npz")
    assert list(p["keys"]) == list(j["keys"]) and np.array_equal(p["emb"], j["emb"])
    got, want = embeddings_dict(str(tmp_path / "e.npz")), jax_embeddings_dict(str(tmp_path / "e.npz"))
    assert list(got) == list(want) and all(np.array_equal(got[k], want[k]) for k in want)
