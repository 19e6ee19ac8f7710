"""Run an exported model program on a wav: the deployment smoke test.

Counterpart of `wespeaker_hubert_tpu/bin/infer_export.py`, whose artefact
is a StableHLO export; here it is the `torch.export` program that
`bin/export_model.py --program` (and the recipes' export stage) write,
`model.pt2` (feats -> embedding, symbolic batch and time).  It is loaded
with `bin/export_model.load_program`, without the port's model code.  The
features are Kaldi fbank at the wav's sample rate, dither off, with CMN and
no CVN, as extraction computes them: the CUDA fbank kernel on the card.

    python -m wespeaker_hubert_tpu_torch.bin.infer_export \\
        --export_path model.pt2 --wav_path a.wav [--num_mel_bins 80] \\
        [--output emb.npy] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["compute_fbank", "infer", "main"]


def compute_fbank(
    wav_path: str,
    num_mel_bins: int = 80,
    frame_length: int = 25,
    frame_shift: int = 10,
    device="cuda",
) -> torch.Tensor:
    """(1, T, num_mel_bins) float32 fbank (dither off) + CMN of a wav, on
    `device`."""
    from ..data.wav_io import read_wav
    from ..ops.fbank import FbankConfig, fbank
    from ..ops.feature_utils import apply_cmvn

    device = resolve_device(device)
    wav, sr = read_wav(wav_path)
    cfg = FbankConfig(num_mel_bins=num_mel_bins, frame_length_ms=frame_length,
                      frame_shift_ms=frame_shift, dither=0.0, sample_rate=sr,
                      spectrum_impl="kernel")
    with torch.inference_mode():
        feats, _ = fbank(torch.from_numpy(wav).to(device)[None], cfg)
        return apply_cmvn(feats, norm_mean=True, norm_var=False)


def infer(export_path: str, feats: torch.Tensor, device="cuda") -> np.ndarray:
    """The program at `export_path` on (B, T, F) feats -> (B, D) float32."""
    from .export_model import load_program

    device = resolve_device(device)
    program = load_program(export_path, device=device)
    with torch.inference_mode():
        return program(torch.as_tensor(feats, dtype=torch.float32).to(device)).cpu().numpy()


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--export_path", required=True,
                   help="model.pt2 from bin/export_model --program")
    p.add_argument("--wav_path", required=True)
    p.add_argument("--num_mel_bins", type=int, default=80)
    p.add_argument("--output", default=None, help="write the embedding .npy here")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    feats = compute_fbank(args.wav_path, num_mel_bins=args.num_mel_bins, device=args.device)
    emb = infer(args.export_path, feats, device=args.device)
    print(emb.squeeze(0))
    if args.output:
        np.save(args.output, emb.squeeze(0))


if __name__ == "__main__":
    main()
