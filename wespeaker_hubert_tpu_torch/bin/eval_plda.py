"""`python -m wespeaker_hubert_tpu_torch.bin.eval_plda` -- see plda_bins.py."""
from .plda_bins import main_eval as main  # noqa: F401

if __name__ == "__main__":
    main()
