"""`python -m wespeaker_hubert_tpu_torch.bin.train_plda` -- see plda_bins.py."""
from .plda_bins import main_train as main  # noqa: F401

if __name__ == "__main__":
    main()
