"""DET curve points of a score file.

Counterpart of `wespeaker_hubert_tpu/bin/compute_det.py`:

    python -m wespeaker_hubert_tpu_torch.bin.compute_det SCORES... [--output_prefix P]

writes `<prefix>.det.txt` (fpr, fnr and their probits, as text) and, where
matplotlib imports, `<prefix>.det.png`; prints each file's EER.  Host numpy
(backend/metrics.py), as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..backend.metrics import compute_eer, compute_pmiss_pfa, det_points

__all__ = ["compute_det"]


def compute_det(score_file: str, output_prefix: str = None):
    scores, labels = [], []
    with open(score_file) as f:
        for line in f:
            parts = line.split()
            scores.append(float(parts[2]))
            labels.append(1 if parts[3] == "target" else 0)
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    fnr, fpr = compute_pmiss_pfa(scores, labels)
    eer = compute_eer(fnr, fpr)
    x, y = det_points(fnr, fpr)

    prefix = output_prefix or score_file
    np.savetxt(
        prefix + ".det.txt",
        np.stack([fpr, fnr, x, y], axis=1),
        header="fpr fnr probit_fpr probit_fnr",
    )
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from scipy.stats import norm

        plt.figure()
        plt.plot(x, y, "r")
        ticks = [0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.4]
        plt.xticks(norm.ppf(ticks), [str(t * 100) for t in ticks])
        plt.yticks(norm.ppf(ticks), [str(t * 100) for t in ticks])
        plt.xlabel("false-alarm rate [%]")
        plt.ylabel("false-reject rate [%]")
        plt.plot(norm.ppf(eer), norm.ppf(eer), "o")
        plt.title(f"EER = {eer * 100:.2f}%")
        plt.grid()
        plt.savefig(prefix + ".det.png")
        plt.close()
    except ImportError:
        pass
    return eer, fnr, fpr


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("scores", nargs="+")
    p.add_argument("--output_prefix", default=None)
    args = p.parse_args()
    for sf in args.scores:
        eer, _, _ = compute_det(sf, args.output_prefix)
        print(f"{sf}: EER {eer * 100:.3f}%")


if __name__ == "__main__":
    main()
