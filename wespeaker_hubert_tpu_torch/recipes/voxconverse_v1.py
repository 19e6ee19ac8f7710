"""VoxConverse v1 diarization recipe on the port.

Counterpart of `examples/voxconverse/v1/run.py`, with its arguments and
`--device` (CUDA unless the caller asks for the CPU): SAD, oracle (from
the per-utterance reference RTTMs, segments under `--min_duration`
dropped) or system (the model directory's Silero `vad.npz`, else the
energy VAD) -> windowed embeddings and spectral clustering -> RTTM -> DER
(collar 0.25):

    python -m wespeaker_hubert_tpu_torch.recipes.voxconverse_v1 \\
        --model_dir DIR --wav_scp wav.scp [--sad_type oracle|system] \\
        [--ref_rttm_dir DIR] [--min_duration 0.255] \\
        [--out_rttm exp/diar_v1/hyp.rttm] [--device cuda|cpu]

`--ref_rttm_dir` holds `<utt>.rttm` per utterance; oracle SAD needs it.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from ..cli.speaker import load_model
from ..data.wav_io import read_wav
from ..diar import oracle_sad, read_rttm, write_rttm
from .voxconverse_v2 import report_der

__all__ = ["parse_args", "main"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model_dir", required=True)
    p.add_argument("--wav_scp", required=True, help="utt wav-path per line")
    p.add_argument("--sad_type", choices=["oracle", "system"], default="oracle")
    p.add_argument("--ref_rttm_dir", default=None,
                   help="per-utt ground-truth <utt>.rttm dir (oracle SAD + DER scoring)")
    p.add_argument("--min_duration", type=float, default=0.255)
    p.add_argument("--out_rttm", default="exp/diar_v1/hyp.rttm")
    p.add_argument("--collar", type=float, default=0.25)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    if args.sad_type == "oracle" and not args.ref_rttm_dir:
        raise ValueError("--ref_rttm_dir is needed for oracle SAD")
    model = load_model(args.model_dir, args.device)
    if args.sad_type == "system":
        model.set_vad(True)
    os.makedirs(os.path.dirname(args.out_rttm) or ".", exist_ok=True)

    entries = []
    with open(args.wav_scp) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                entries.append((parts[0], parts[1]))

    all_segments = []
    for utt, path in entries:
        if args.sad_type == "oracle":
            ref = read_rttm(os.path.join(args.ref_rttm_dir, f"{utt}.rttm"))
            sad = oracle_sad({utt: ref.get(utt, [])},
                             min_duration=args.min_duration).get(utt, [])
            wav, _ = read_wav(path)
            segs = model.diarize_segments(wav, sad, utt=utt, clusterer="spectral")
        else:
            segs = model.diarize(path, utt=utt, clusterer="spectral")
        all_segments += [(u, b, e, f"spk{lab}") for (u, b, e, lab) in segs]
        print(f"{utt}: {len(segs)} segments")
    write_rttm(args.out_rttm, all_segments)
    print(f"hypothesis RTTM -> {args.out_rttm}")

    if args.ref_rttm_dir:
        ref = {}
        for utt, _ in entries:
            ref.update(read_rttm(os.path.join(args.ref_rttm_dir, f"{utt}.rttm")))
        return report_der(ref, args.out_rttm, args.collar)
    return None


if __name__ == "__main__":
    main()
