"""Two-covariance PLDA (Kaldi semantics) in float64 on the device.

Counterpart of `wespeaker_hubert_tpu/backend/plda.py`, with its attributes,
methods and `.npz` layout, so a model saved by either package loads in the
other.  Every array is a float64 torch tensor on the model's `device`; no
step drops to float32.  Where the JAX package loops over speakers on the
host, this one works on whole arrays:

  * `accumulate`: per-speaker sums and counts are `index_add_` / `bincount`
    over a speaker index, the within-speaker scatter is one GEMM per chunk
    of rows (the rows minus their speaker's mean);
  * `em_one_iter`: the per-speaker (B^-1 + n W^-1)^-1 comes from one
    simultaneous diagonalisation of B and W (V^T W V = I, V^T B V = L):
    (B^-1 + n W^-1)^-1 = V^-T diag(l / (1 + n l)) V^-1, so every speaker's
    terms are diagonal scalings summed by two GEMMs over the speakers;
  * `score_trials`: the LLR of a trial is a per-enroll term plus one dot
    product of a per-enroll and a per-test vector (2 D long), evaluated over
    index arrays in chunks of trials;
  * `adapt`: scipy's generalised `eigh(data_cov, t)` is a Cholesky reduction
    (t = L L^T, eigh of L^-1 data_cov L^-T), with the eigenvectors scaled as
    scipy's, e^T t e = I.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["TwoCovPLDA", "norm_embeddings"]

M_LOG_2PI = 1.8378770664093454835606594728112
ROW_CHUNK = 1 << 18  # rows per within-scatter GEMM
TRIAL_CHUNK = 1 << 18  # trials per scoring chunk

logger = logging.getLogger(__name__)
Array = Union[np.ndarray, torch.Tensor]


def _f64(x: Array, device: torch.device) -> torch.Tensor:
    """x as a float64 tensor on `device` (float32 input crosses as float32)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device).to(torch.float64)


def _index(labels: Array, device: torch.device) -> torch.Tensor:
    """Integer labels as an int64 tensor on `device`."""
    t = labels if isinstance(labels, torch.Tensor) else torch.as_tensor(np.asarray(labels))
    return t.to(device, torch.int64)


def norm_embeddings(emb: torch.Tensor, kaldi_style: bool = True) -> torch.Tensor:
    """Unit-length (or sqrt(dim)-length, Kaldi-style) rows."""
    scale = math.sqrt(emb.shape[-1]) if kaldi_style else 1.0
    norms = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return scale * emb / torch.clamp_min(norms, 1e-12)


def _sym(a: torch.Tensor) -> torch.Tensor:
    return 0.5 * (a + a.T)


def _cholesky(covar: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, retried with 1e-6 on the diagonal."""
    c, info = torch.linalg.cholesky_ex(covar)
    if int(info) != 0:
        eye = torch.eye(covar.shape[0], dtype=covar.dtype, device=covar.device)
        c = torch.linalg.cholesky(covar + eye * 1e-6)
    return c


def _normalizing_transform(covar: torch.Tensor) -> torch.Tensor:
    """inv(cholesky(covar)): whitens covar."""
    c = _cholesky(covar)
    eye = torch.eye(c.shape[0], dtype=c.dtype, device=c.device)
    return torch.linalg.solve_triangular(c, eye, upper=False)


def _reduced_eigh(a: torch.Tensor, b: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Generalised eigenproblem a e = v b e by Cholesky reduction: returns
    (v ascending, e with e^T b e = I, L Q = e^-T) where b = L L^T and Q are
    the eigenvectors of L^-1 a L^-T."""
    lo = torch.linalg.cholesky(b)
    x = torch.linalg.solve_triangular(lo, a, upper=False)
    c = _sym(torch.linalg.solve_triangular(lo, x.T, upper=False))
    v, q = torch.linalg.eigh(c)
    e = torch.linalg.solve_triangular(lo.T, q, upper=True)
    return v, e, lo @ q


class TwoCovPLDA:
    """mu / transform / psi parameterisation: `transform` whitens the
    within-class covariance and diagonalises the across-class one; `psi` is
    the across-class variance diagonal in that space."""

    def __init__(self, dim: int = 0, normalize_length: bool = False,
                 subtract_train_set_mean: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self.dim = dim
        self.normalize_length = normalize_length
        self.subtract_train_set_mean = subtract_train_set_mean
        z = dict(dtype=torch.float64, device=self.device)
        self.mu = torch.zeros(dim, **z)
        self.transform = torch.zeros(dim, dim, **z)
        self.psi = torch.zeros(dim, **z)
        self.offset = torch.zeros(dim, **z)
        # training state: per-speaker means (S, D) and counts (S,)
        self._B = torch.eye(dim, **z)
        self._W = torch.eye(dim, **z)
        self._class_means = torch.zeros(0, dim, **z)
        self._class_counts = torch.zeros(0, **z)
        self._offset_scatter = torch.zeros(dim, dim, **z)
        self._sum = torch.zeros(dim, **z)

    # ------------------------------------------------------ stats + EM
    def accumulate(self, spk_to_embeddings: Dict[str, Array]) -> None:
        """Per-speaker statistics of {speaker: (n, D) rows}, speakers in the
        dict's order."""
        mats = [np.atleast_2d(np.asarray(v)) for v in spk_to_embeddings.values()]
        labels = np.repeat(np.arange(len(mats)), [len(m) for m in mats])
        self.accumulate_rows(np.concatenate(mats), labels)

    def accumulate_rows(self, emb: Array, labels: Array) -> None:
        """Per-speaker statistics of the rows `emb` (N, D), row i of speaker
        labels[i]; labels are 0..S-1 and every speaker has a row."""
        x = _f64(emb, self.device)
        idx = _index(labels, self.device)
        if self.subtract_train_set_mean:
            x = x - x.mean(0)
        if self.normalize_length:
            x = norm_embeddings(x)
        n_spk = int(idx.max()) + 1
        counts = torch.bincount(idx, minlength=n_spk).to(torch.float64)
        sums = torch.zeros(n_spk, self.dim, dtype=torch.float64, device=self.device)
        sums.index_add_(0, idx, x)
        means = sums / counts[:, None]
        for s in range(0, len(x), ROW_CHUNK):
            diff = x[s:s + ROW_CHUNK] - means[idx[s:s + ROW_CHUNK]]
            self._offset_scatter += diff.T @ diff
        self._class_means = torch.cat([self._class_means, means])
        self._class_counts = torch.cat([self._class_counts, counts])
        self._sum += means.sum(0)
        self.mu = self._sum / len(self._class_means)

    def em_one_iter(self) -> None:
        """One EM step, every speaker at once through the simultaneous
        diagonalisation of B and W."""
        n = self._class_counts
        n_classes = len(n)
        m = self._class_means - self._sum / n_classes
        # V^T W V = I, V^T B V = diag(lam); V^-T = L Q
        lam, v, v_inv_t = _reduced_eigh(self._B, self._W)
        y = m @ v  # (S, D): V^T m per speaker
        nl = n[:, None] * lam[None, :]
        g = nl / (1.0 + nl) * y  # V^T w
        h = y / (1.0 + nl)  # V^T (m - w)
        diag_b = torch.sum(lam[None, :] / (1.0 + nl), 0)
        inner_b = torch.diag(diag_b) + g.T @ g
        hs = h * torch.sqrt(n)[:, None]
        inner_w = torch.diag(torch.sum(nl / (1.0 + nl), 0)) + hs.T @ hs
        b_stats = v_inv_t @ inner_b @ v_inv_t.T
        w_stats = self._offset_scatter + v_inv_t @ inner_w @ v_inv_t.T
        self._W = _sym(w_stats / float(n.sum()))
        self._B = _sym(b_stats / float(n_classes))

    def finalize(self) -> None:
        """Diagonalise into (transform, psi)."""
        self.mu = self._sum / len(self._class_means)
        t1 = _normalizing_transform(self._W)
        s, u = torch.linalg.eigh(_sym(t1 @ self._B @ t1.T))
        s = torch.clamp_min(s, 0.0)
        order = torch.argsort(s, descending=True, stable=True)
        self.transform = u[:, order].T @ t1
        self.psi = s[order]
        self.offset = -self.transform @ self.mu

    def train(self, spk_to_embeddings: Dict[str, Array], num_em_iters: int = 5):
        self.accumulate(spk_to_embeddings)
        return self._fit(num_em_iters)

    def train_rows(self, emb: Array, labels: Array, num_em_iters: int = 5):
        self.accumulate_rows(emb, labels)
        return self._fit(num_em_iters)

    def _fit(self, num_em_iters: int):
        for _ in range(num_em_iters):
            self.em_one_iter()
        self.finalize()
        return self

    # ------------------------------------------------------ scoring
    def transform_embeddings(self, emb: Array) -> torch.Tensor:
        """Rows projected into the diagonalised space (Kaldi length norm to
        sqrt(dim) when normalize_length)."""
        x = _f64(emb, self.device)
        out = torch.atleast_2d(x) @ self.transform.T + self.offset
        if self.normalize_length:
            out = out * (math.sqrt(self.dim) / torch.linalg.vector_norm(out, dim=1))[:, None]
        return out

    def llr(self, enroll_t: Array, test_t: Array, counts: Optional[Array] = None) -> torch.Tensor:
        """Log-likelihood ratio of row-paired transformed embeddings, each
        enroll row the mean of counts[i] sessions."""
        e = torch.atleast_2d(_f64(enroll_t, self.device))
        t = torch.atleast_2d(_f64(test_t, self.device))
        n = (torch.ones(len(e), dtype=torch.float64, device=self.device) if counts is None
             else _f64(counts, self.device))[:, None]
        psi = self.psi[None, :]
        mean = n * psi / (n * psi + 1.0) * e
        var_given = 1.0 + psi / (n * psi + 1.0)
        ll_given = -0.5 * (torch.log(var_given).sum(1) + M_LOG_2PI * self.dim
                           + torch.sum((t - mean) ** 2 / var_given, 1))
        var_no = self.psi + 1.0
        ll_no = -0.5 * (torch.log(var_no).sum() + M_LOG_2PI * self.dim
                        + torch.sum(t ** 2 / var_no, 1))
        return ll_given - ll_no

    def score_indexed(self, enroll_t: torch.Tensor, counts: torch.Tensor, test_t: torch.Tensor,
                      enroll_idx: Array, test_idx: Array) -> torch.Tensor:
        """llr(enroll_t[enroll_idx], test_t[test_idx], counts[enroll_idx])
        without gathering (N, D) arrays: -0.5 (K_e + P_e . Q_t), with
        K_e = sum(log v) - sum(log(psi + 1)) + sum(a^2 e^2 / v),
        P_e = [1 / v - 1 / (psi + 1), -2 a e / v] and Q_t = [t^2, t], where
        a = n psi / (n psi + 1), v = 1 + psi / (n psi + 1)."""
        n = counts.to(self.device, torch.float64)[:, None]
        psi = self.psi[None, :]
        a = n * psi / (n * psi + 1.0)
        v = 1.0 + psi / (n * psi + 1.0)
        k = (torch.log(v).sum(1) - torch.log(self.psi + 1.0).sum()
             + torch.sum(a * a * enroll_t * enroll_t / v, 1))
        p = torch.cat([1.0 / v - 1.0 / (psi + 1.0), -2.0 * a * enroll_t / v], 1)
        q = torch.cat([test_t * test_t, test_t], 1)
        e_idx, t_idx = _index(enroll_idx, self.device), _index(test_idx, self.device)
        out = torch.empty(len(e_idx), dtype=torch.float64, device=self.device)
        for s in range(0, len(e_idx), TRIAL_CHUNK):
            ei, ti = e_idx[s:s + TRIAL_CHUNK], t_idx[s:s + TRIAL_CHUNK]
            out[s:s + TRIAL_CHUNK] = -0.5 * (k[ei] + torch.sum(p[ei] * q[ti], 1))
        return out

    def score_trials(
        self,
        enroll_emb: Dict[str, Array],
        test_emb: Dict[str, Array],
        trials: Sequence[Tuple[str, str]],
        multisession_avg: bool = True,
        mean_vec: Optional[Array] = None,
    ) -> np.ndarray:
        """Scores of (enroll_key, test_key) trials, float64 on the host.
        An enroll value may be an (n, D) stack of sessions: averaged, with
        n used in the LLR when multisession_avg is False."""
        d = self.dim
        mean = (torch.zeros(d, dtype=torch.float64, device=self.device) if mean_vec is None
                else _f64(mean_vec, self.device))
        e_keys, t_keys = sorted(enroll_emb), sorted(test_emb)
        stacks = [np.atleast_2d(np.asarray(enroll_emb[k])) for k in e_keys]
        sizes = torch.as_tensor([len(s) for s in stacks], dtype=torch.float64)
        rows = _f64(np.concatenate(stacks), self.device) - mean
        model = torch.repeat_interleave(torch.arange(len(stacks)), sizes.long()).to(self.device)
        e_mean = torch.zeros(len(stacks), d, dtype=torch.float64, device=self.device)
        e_mean.index_add_(0, model, rows)
        e_mean = e_mean / sizes.to(self.device)[:, None]
        t_rows = _f64(np.stack([np.asarray(test_emb[k]) for k in t_keys]), self.device) - mean
        if self.normalize_length:
            e_mean, t_rows = norm_embeddings(e_mean), norm_embeddings(t_rows)
        counts = torch.ones_like(sizes) if multisession_avg else sizes
        e_pos = {k: i for i, k in enumerate(e_keys)}
        t_pos = {k: i for i, k in enumerate(t_keys)}
        e_idx = np.fromiter((e_pos[a] for a, _ in trials), np.int64, len(trials))
        t_idx = np.fromiter((t_pos[b] for _, b in trials), np.int64, len(trials))
        scores = self.score_indexed(self.transform_embeddings(e_mean), counts,
                                    self.transform_embeddings(t_rows), e_idx, t_idx)
        return scores.cpu().numpy()

    # ------------------------------------------------------ adaptation
    def adapt(self, adapt_data: Array, ac_scale: float = 0.5,
              wc_scale: float = 0.5) -> "TwoCovPLDA":
        """Unsupervised domain adaptation (the BUT recipe): the adaptation
        data's variance in excess of the model's total covariance is split
        into the across- and within-class covariances by ac_scale and
        wc_scale.  The returned model's `adapt_info` holds the number of
        generalised eigenvalues above 1 and the smallest |v - 1|."""
        adp = _f64(adapt_data, self.device)
        mean_vec = adp.mean(0)
        adp = adp - mean_vec
        if self.normalize_length:
            adp = norm_embeddings(adp)
        eye = torch.eye(self.dim, dtype=torch.float64, device=self.device)
        tt = self.transform
        w = _sym(torch.linalg.solve(tt.T @ tt, eye))
        b = _sym(torch.linalg.solve((tt.T / self.psi) @ tt, eye))
        t = b + w
        centred = adp - adp.mean(0)
        data_cov = _sym(centred.T @ centred / (len(adp) - 1))
        v, _, iet = _reduced_eigh(data_cov, _sym(t))
        above = v > 1
        excess = iet[:, above] * torch.sqrt(v[above] - 1)[None, :]
        b_adp = b + ac_scale * (excess @ excess.T)
        w_adp = w + wc_scale * (excess @ excess.T)
        mu_adp = adp.mean(0) + mean_vec

        a = _sym(b_adp)
        d_eig, v_eig = torch.linalg.eigh(_sym(w_adp))
        t1 = (1.0 / torch.sqrt(d_eig + 1e-9))[:, None] * v_eig.T
        _, t2 = torch.linalg.eigh(_sym(t1 @ a @ t1.T))
        t_joint = t2.T @ t1

        out = TwoCovPLDA(self.dim, self.normalize_length, self.subtract_train_set_mean,
                         device=self.device)
        out.mu = mu_adp
        out.transform = t_joint
        out.psi = torch.diagonal(t_joint @ a @ t_joint.T).clone()
        out.offset = -out.transform @ out.mu
        out.adapt_info = {"n_above_1": int(above.sum()),
                          "min_abs_v_minus_1": float(torch.abs(v - 1).min())}
        logger.info("PLDA adaptation: %d generalised eigenvalues above 1, min |v - 1| %.3e",
                    out.adapt_info["n_above_1"], out.adapt_info["min_abs_v_minus_1"])
        return out

    # ------------------------------------------------------ persistence
    def save(self, path: str) -> None:
        np.savez(
            path,
            mu=self.mu.cpu().numpy(),
            transform=self.transform.cpu().numpy(),
            psi=self.psi.cpu().numpy(),
            offset=self.offset.cpu().numpy(),
            normalize_length=int(self.normalize_length),
            subtract_train_set_mean=int(self.subtract_train_set_mean),
        )

    @staticmethod
    def load(path: str, device="cuda") -> "TwoCovPLDA":
        data = np.load(path)
        plda = TwoCovPLDA(
            dim=len(data["mu"]),
            normalize_length=bool(data["normalize_length"]),
            subtract_train_set_mean=bool(data["subtract_train_set_mean"]),
            device=device,
        )
        for name in ("mu", "transform", "psi", "offset"):
            setattr(plda, name, _f64(data[name], plda.device))
        return plda
