"""The port's PLDA back end, embedding-processing chain, Kaldi I/O, data-dir
tools, DET points and offline fbank against the JAX package, on the same
seeded numpy inputs, on the CPU.

Bars: W and B after EM within 1e-10 relative (Frobenius), psi within 1e-9
relative, PLDA scores within 1e-8 absolute and 1e-7 after adaptation; chain
outputs within 1e-10 (LDA up to the sign of each column, which eigh leaves
free); the writers' bytes, the data-dir tables and the DET text identical;
compute_feats within rtol 1e-4 / atol 2e-3 (tests/test_fbank_pallas.py's
bar) with equal frame counts.  Eigenvectors are compared only through
quantities their signs do not change.  Inputs are float64 where the JAX
package would otherwise average float32 rows in float32 (its train-set
mean), so both sides see the same numbers.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from tests import test_plda as jax_plda_tests
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from wespeaker_hubert_tpu.backend import kaldi_io as jax_kaldi
from wespeaker_hubert_tpu.backend import processing as jax_proc
from wespeaker_hubert_tpu.backend.plda import TwoCovPLDA as JaxPLDA
from wespeaker_hubert_tpu.bin import compute_det as jax_det
from wespeaker_hubert_tpu.bin import datadir as jax_datadir
from wespeaker_hubert_tpu.bin import tools as jax_tools
from wespeaker_hubert_tpu_torch.backend import kaldi_io
from wespeaker_hubert_tpu_torch.backend import processing
from wespeaker_hubert_tpu_torch.backend.plda import TwoCovPLDA
from wespeaker_hubert_tpu_torch.bin import compute_det, datadir, tools
from wespeaker_hubert_tpu_torch.data.dataset import iter_feat_list
from wespeaker_hubert_tpu_torch.data.wav_io import write_wav

D = 24
DEFAULT_CHAIN = "mean-subtract | length-norm | lda --dim 10 | length-norm"


def _speakers(seed=0, n_spk=40, dim=D, offset=0.5):
    """{speaker: (n, dim) float64}, 1-8 rows each, a speaker centre plus
    unit noise."""
    rng = np.random.default_rng(seed)
    out = {}
    for s in range(n_spk):
        c = 2.0 * rng.standard_normal(dim) + offset
        out[f"spk{s:02d}"] = c + rng.standard_normal((int(rng.integers(1, 9)), dim))
    return out


def _enroll_test(seed=1, dim=D):
    rng = np.random.default_rng(seed)
    enroll = {f"m{i}": rng.standard_normal((int(rng.integers(1, 4)), dim)) for i in range(8)}
    test = {f"t{i}": rng.standard_normal(dim) for i in range(10)}
    trials = [(e, t) for e in enroll for t in test]
    return enroll, test, trials


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - b) / np.linalg.norm(b)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("normalize_length,subtract_mean",
                         [(False, False), (True, False), (True, True)])
def test_plda_matches_jax(normalize_length, subtract_mean):
    spk = _speakers()
    jax, port = (JaxPLDA(D, normalize_length, subtract_mean),
                 TwoCovPLDA(D, normalize_length, subtract_mean, device="cpu"))
    jax.accumulate(spk)
    port.accumulate(spk)
    for _ in range(3):
        jax.em_one_iter()
        port.em_one_iter()
    assert _rel(_np(port._W), jax._W) <= 1e-10 and _rel(_np(port._B), jax._B) <= 1e-10
    jax.finalize()
    port.finalize()
    assert _rel(_np(port.psi), jax.psi) <= 1e-9
    np.testing.assert_allclose(_np(port.mu), jax.mu, rtol=0, atol=1e-12)
    enroll, test, trials = _enroll_test()
    for multisession_avg in (True, False):
        np.testing.assert_allclose(
            port.score_trials(enroll, test, trials, multisession_avg=multisession_avg),
            jax.score_trials(enroll, test, trials, multisession_avg=multisession_avg),
            rtol=0, atol=1e-8)
    mean_vec = np.full(D, 0.3)
    np.testing.assert_allclose(port.score_trials(enroll, test, trials, mean_vec=mean_vec),
                               jax.score_trials(enroll, test, trials, mean_vec=mean_vec),
                               rtol=0, atol=1e-8)
    # the row-paired LLR with session counts
    rng = np.random.default_rng(2)
    e, t, n = rng.standard_normal((5, D)), rng.standard_normal((5, D)), [1, 3, 2, 1, 4]
    np.testing.assert_allclose(
        _np(port.llr(port.transform_embeddings(e), port.transform_embeddings(t),
                     np.asarray(n, np.float64))),
        jax.llr(jax.transform_embeddings(e), jax.transform_embeddings(t), n), atol=1e-8)
    # BUT adaptation on a shifted, wider in-domain set
    adp = 1.5 * rng.standard_normal((300, D)) + 0.4
    jax_a, port_a = jax.adapt(adp), port.adapt(adp)
    np.testing.assert_allclose(port_a.score_trials(enroll, test, trials),
                               jax_a.score_trials(enroll, test, trials), rtol=0, atol=1e-7)
    np.testing.assert_allclose(_np(port_a.mu), jax_a.mu, atol=1e-10)
    assert port_a.adapt_info["n_above_1"] > 0


def test_plda_rows_equal_dict_and_kaldi_import(tmp_path):
    """accumulate_rows over a speaker index is accumulate over the dict; a
    Kaldi binary model (written as tests/test_plda.py writes one) loads
    into both packages alike."""
    spk = _speakers(3)
    a = TwoCovPLDA(D, True, device="cpu").train(spk, 2)
    rows = np.concatenate(list(spk.values()))
    labels = np.repeat(np.arange(len(spk)), [len(v) for v in spk.values()])
    b = TwoCovPLDA(D, True, device="cpu").train_rows(rows, labels, 2)
    assert torch.equal(a.psi, b.psi) and torch.equal(a.transform, b.transform)
    path = str(tmp_path / "plda.kaldi")
    jax_plda_tests.TestKaldiImport()._write_kaldi_plda(path, _np(a.mu), _np(a.transform),
                                                       _np(a.psi))
    jax_m = jax_kaldi.load_kaldi_plda(path, normalize_length=False)
    port_m = kaldi_io.load_kaldi_plda(path, normalize_length=False, device="cpu")
    for name in ("mu", "transform", "psi"):
        np.testing.assert_array_equal(_np(getattr(port_m, name)), getattr(jax_m, name))
    np.testing.assert_allclose(_np(port_m.offset), jax_m.offset, rtol=0, atol=1e-12)
    enroll, test, trials = _enroll_test(4)
    np.testing.assert_allclose(port_m.score_trials(enroll, test, trials),
                               jax_m.score_trials(enroll, test, trials), atol=1e-8)


def _chain_inputs(seed=5):
    spk = _speakers(seed, n_spk=30, dim=20, offset=0.8)
    keys, rows, u2s = [], [], {}
    for s, v in spk.items():
        for i, x in enumerate(v):
            keys.append(f"{s}-{i}")
            rows.append(x)
            u2s[keys[-1]] = s
    keys.append("unlabeled")  # a row without a speaker: LDA leaves it out
    rows.append(np.full(20, 0.1))
    return np.asarray(rows), keys, u2s, spk


def _sign_aligned(got, want):
    """got with each column's sign matched to want's."""
    return got * np.sign(np.sum(got * want, axis=0))


@pytest.mark.parametrize("chain", ["mean-subtract", "length-norm", "whitening",
                                   "lda --dim 6", "mean-subtract | whitening | length-norm",
                                   DEFAULT_CHAIN])
def test_chain_matches_jax(chain):
    x, keys, u2s, _ = _chain_inputs()
    jax = jax_proc.EmbeddingProcessingChain().fit(chain, x, utt2spk=u2s, keys=keys)
    port = processing.EmbeddingProcessingChain(device="cpu").fit(chain, x, utt2spk=u2s,
                                                                 keys=keys)
    assert [m for m, _ in port.links] == [m for m, _ in jax.links]
    want = jax(x)
    np.testing.assert_allclose(_sign_aligned(_np(port(x)), want), want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("equal_speaker_weight", [False, True])
def test_lda_matches_jax(equal_speaker_weight):
    x, _, _, spk = _chain_inputs(6)
    jax = jax_proc._Lda.fit(spk, 7, equal_speaker_weight=equal_speaker_weight)
    port = processing._Lda.fit(spk, 7, equal_speaker_weight=equal_speaker_weight, device="cpu")
    np.testing.assert_allclose(_np(port.m), jax.m, atol=1e-12)
    want = jax(x)
    np.testing.assert_allclose(_sign_aligned(_np(port(torch.from_numpy(x))), want), want,
                               rtol=0, atol=1e-10)


def test_npz_files_cross_both_ways(tmp_path):
    """A PLDA model and a chain saved by either package load in the other
    and score / transform alike."""
    spk = _speakers(7)
    jax = JaxPLDA(D, normalize_length=True).train(spk, 2)
    port = TwoCovPLDA(D, normalize_length=True, device="cpu").train(spk, 2)
    jax.save(str(tmp_path / "jax_plda.npz"))
    port.save(str(tmp_path / "port_plda.npz"))
    enroll, test, trials = _enroll_test(8)
    from_jax = TwoCovPLDA.load(str(tmp_path / "jax_plda.npz"), device="cpu")
    from_port = JaxPLDA.load(str(tmp_path / "port_plda.npz"))
    want = jax.score_trials(enroll, test, trials)
    np.testing.assert_allclose(from_jax.score_trials(enroll, test, trials), want, atol=1e-8)
    np.testing.assert_allclose(from_port.score_trials(enroll, test, trials), want, atol=1e-8)
    assert sorted(np.load(str(tmp_path / "port_plda.npz"))) == sorted(
        np.load(str(tmp_path / "jax_plda.npz")))

    x, keys, u2s, _ = _chain_inputs(9)
    jc = jax_proc.EmbeddingProcessingChain().fit(DEFAULT_CHAIN, x, utt2spk=u2s, keys=keys)
    pc = processing.EmbeddingProcessingChain(device="cpu").fit(DEFAULT_CHAIN, x, utt2spk=u2s,
                                                               keys=keys)
    jc.save(str(tmp_path / "jax_chain.npz"))
    pc.save(str(tmp_path / "port_chain.npz"))
    want = jc(x)
    got = _np(processing.EmbeddingProcessingChain.load(str(tmp_path / "jax_chain.npz"),
                                                       device="cpu")(x))
    np.testing.assert_allclose(got, want, atol=1e-12)
    got = jax_proc.EmbeddingProcessingChain.load(str(tmp_path / "port_chain.npz"))(x)
    np.testing.assert_allclose(_sign_aligned(got, want), want, atol=1e-10)
    with np.load(str(tmp_path / "port_chain.npz")) as a, \
            np.load(str(tmp_path / "jax_chain.npz")) as b:
        assert sorted(a) == sorted(b) and list(a["spec"]) == list(b["spec"])


def test_kaldi_writers_byte_for_byte(tmp_path):
    rng = np.random.default_rng(10)
    names = ["utt-a", "utt-b", "utt-c"]
    vecs = [rng.standard_normal(D).astype(np.float32) for _ in names]
    mats = [rng.standard_normal((n, 16)).astype(np.float32) for n in (5, 1, 9)]
    for tag, mod in (("jax", jax_kaldi), ("port", kaldi_io)):
        d = tmp_path / tag
        d.mkdir()
        # the scp lines name the ark by the path given, so both write "v.ark"
        cwd = os.getcwd()
        os.chdir(d)
        try:
            mod.write_kaldi_vectors("v.ark", names, vecs, "v.scp")
            mod.write_kaldi_matrices("m.ark", names, mats, "m.scp")
        finally:
            os.chdir(cwd)
    for name in ("v.ark", "v.scp", "m.ark", "m.scp"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    got = kaldi_io.read_kaldi_vectors(str(tmp_path / "port" / "v.ark"))
    assert [k for k, _ in got] == names
    for (_, v), want in zip(got, vecs):
        np.testing.assert_array_equal(v, want)
    got = kaldi_io.read_kaldi_matrices(str(tmp_path / "port" / "m.ark"))
    for (_, m), want in zip(got, mats):
        assert m.dtype == np.float32
        np.testing.assert_array_equal(m, want)
    offset = (tmp_path / "port" / "m.scp").read_text().split()[3].rpartition(":")[2]
    np.testing.assert_array_equal(
        kaldi_io.read_kaldi_matrix(f"{tmp_path / 'port' / 'm.ark'}:{offset}"), mats[1])


def _data_dir(root, seed=11):
    """A data dir with wav.scp, utt2spk (one utt without audio), utt2dur."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    utts = [f"s{s}-u{i}" for s in range(5) for i in range(int(rng.integers(2, 5)))]
    rng.shuffle(utts)
    (root / "wav.scp").write_text("".join(f"{u} /audio/{u}.wav\n" for u in utts))
    (root / "utt2spk").write_text("".join(f"{u} {u.split('-')[0]}\n" for u in utts)
                                  + "ghost-u0 s9\n")
    (root / "utt2dur").write_text("".join(f"{u} {rng.uniform(1, 9):.2f}\n" for u in utts))
    return utts


def _tables(d):
    return {n: (d / n).read_text() for n in sorted(os.listdir(d))}


def test_datadir_matches_jax(tmp_path):
    for tag in ("jax", "port"):
        utts = _data_dir(tmp_path / tag / "src")
    ids = tmp_path / "ids"
    ids.write_text("".join(f"{u} x\n" for u in utts[::2]))
    lines = (tmp_path / "jax" / "src" / "utt2spk").read_text().splitlines()
    for f, e in ((1, False), (1, True), (2, False)):
        assert datadir.filter_scp(ids.read_text().splitlines(), lines, f, e) == \
            jax_datadir.filter_scp(ids.read_text().splitlines(), lines, f, e)
    spk2utt = jax_datadir.utt2spk_to_spk2utt(lines)
    assert datadir.utt2spk_to_spk2utt(lines) == spk2utt
    assert datadir.spk2utt_to_utt2spk(spk2utt) == jax_datadir.spk2utt_to_utt2spk(spk2utt)
    spk_list = tmp_path / "spks"
    spk_list.write_text("s1\ns3\n")
    calls = [("fix_data_dir", lambda m, t: m.fix_data_dir(str(t / "src")))]
    for mode in ("random", "first", "last", "shortest", "speakers", "per-spk"):
        calls.append((f"subset {mode}", lambda m, t, mode=mode: m.subset_data_dir(
            str(t / "src"), str(t / f"sub-{mode}"), n=2 if mode == "per-spk" else 6,
            mode=mode)))
    calls += [
        ("subset utt_list", lambda m, t: m.subset_data_dir(str(t / "src"), str(t / "sub-u"),
                                                           utt_list=str(ids))),
        ("copy spk_list", lambda m, t: m.copy_data_dir(str(t / "src"), str(t / "copy-s"),
                                                       spk_list=str(spk_list))),
        ("copy", lambda m, t: m.copy_data_dir(str(t / "src"), str(t / "copy"))),
        ("combine", lambda m, t: m.combine_data(str(t / "comb"),
                                                [str(t / "sub-first"), str(t / "sub-last")])),
    ]
    for what, call in calls:
        assert call(datadir, tmp_path / "port") == call(jax_datadir, tmp_path / "jax"), what
    for sub in sorted(os.listdir(tmp_path / "jax")):
        assert _tables(tmp_path / "port" / sub) == _tables(tmp_path / "jax" / sub), sub
    with pytest.raises(ValueError, match="duplicate"):
        datadir.combine_data(str(tmp_path / "dup"), [str(tmp_path / "port" / "copy")] * 2)


def test_feat_list_and_det_match_jax(tmp_path, monkeypatch):
    """make_feat_list's list and compute_det's text, without matplotlib
    (the card's machine has none; importing and drawing it takes seconds
    and the PNG is not compared)."""
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    scp = tmp_path / "feats.scp"
    scp.write_text("a /f.ark:10\nb /f.ark:99\nc /f.ark:200\n")
    u2s = tmp_path / "utt2spk"
    u2s.write_text("a s1\nc s2\n")
    assert tools.make_feat_list(str(scp), str(u2s), str(tmp_path / "port.list")) == \
        jax_tools.make_feat_list(str(scp), str(u2s), str(tmp_path / "jax.list")) == 2
    assert (tmp_path / "port.list").read_bytes() == (tmp_path / "jax.list").read_bytes()

    rng = np.random.default_rng(12)
    lab = rng.integers(0, 2, 400)
    s = rng.standard_normal(400) + 1.5 * lab
    score = tmp_path / "x.score"
    score.write_text("".join(f"e{i} t{i} {v:.5f} {'target' if y else 'nontarget'}\n"
                             for i, (v, y) in enumerate(zip(s, lab))))
    got = compute_det.compute_det(str(score), str(tmp_path / "port"))
    want = jax_det.compute_det(str(score), str(tmp_path / "jax"))
    assert got[0] == want[0]
    assert (tmp_path / "port.det.txt").read_text() == (tmp_path / "jax.det.txt").read_text()


def test_compute_feats_matches_jax(tmp_path):
    """compute_feats (16 kHz, as its signature fixes) on the CPU against the
    JAX package's jitted one: two utterances in one power-of-two bucket."""
    rng = np.random.default_rng(13)
    scp = []
    for i, n in enumerate((19200, 24100)):
        t = np.arange(n) / 16000
        x = 0.2 * np.sin(2 * np.pi * (150 + 90 * i) * t) + 0.02 * rng.standard_normal(n)
        write_wav(str(tmp_path / f"u{i}.wav"), x.astype(np.float32))
        scp.append(f"u{i} {tmp_path / f'u{i}.wav'}")
    (tmp_path / "wav.scp").write_text("\n".join(scp) + "\n")
    kw = dict(num_mel_bins=24)
    assert tools.compute_feats(str(tmp_path / "wav.scp"), str(tmp_path / "p.ark"),
                               str(tmp_path / "p.scp"), device="cpu", **kw) == 2
    jax_tools.compute_feats(str(tmp_path / "wav.scp"), str(tmp_path / "j.ark"),
                            str(tmp_path / "j.scp"), **kw)
    got = kaldi_io.read_kaldi_matrices(str(tmp_path / "p.ark"))
    want = jax_kaldi.read_kaldi_matrices(str(tmp_path / "j.ark"))
    assert [k for k, _ in got] == [k for k, _ in want] == ["u0", "u1"]
    for (_, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.shape[1] == 24
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=2e-3)
    # the feat data type reads the port's arks back through its scp
    shutil.copy(tmp_path / "p.scp", tmp_path / "feats.scp")
    (tmp_path / "utt2spk").write_text("u0 s0\nu1 s1\n")
    tools.make_feat_list(str(tmp_path / "feats.scp"), str(tmp_path / "utt2spk"),
                         str(tmp_path / "feat.list"))
    read = list(iter_feat_list((tmp_path / "feat.list").read_text().splitlines()))
    for r, (_, g) in zip(read, got):
        np.testing.assert_array_equal(r["feat"], g)
