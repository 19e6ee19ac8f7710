"""VoxConverse v2 diarization recipe on the port.

Counterpart of `examples/voxconverse/v2/run.py`, with its arguments and
`--device` (CUDA unless the caller asks for the CPU): SAD (the energy
VAD, as examples/voxconverse/v2/run.py runs it) -> fbank -> sliding
subsegment windows -> embeddings -> spectral or density clustering ->
RTTM -> DER (collar 0.25) against `--ref_rttm`, in the framework (no
md-eval.pl):

    python -m wespeaker_hubert_tpu_torch.recipes.voxconverse_v2 \\
        --model_dir DIR --wav_scp wav.scp [--ref_rttm ref.rttm] \\
        [--out_rttm exp/diar/hyp.rttm] [--clusterer spectral|density] \\
        [--window_secs 1.5] [--period_secs 0.75] [--subseg_cmn true|false] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

from ..cli.speaker import load_model
from ..diar import der_details, read_rttm, write_rttm

__all__ = ["parse_args", "report_der", "main"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model_dir", required=True)
    p.add_argument("--wav_scp", required=True, help="utt wav-path per line")
    p.add_argument("--ref_rttm", default=None)
    p.add_argument("--out_rttm", default="exp/diar/hyp.rttm")
    p.add_argument("--clusterer", choices=["spectral", "density"], default="spectral")
    p.add_argument("--collar", type=float, default=0.25)
    p.add_argument("--window_secs", type=float, default=1.5,
                   help="subsegment window (WeSpeaker's run.sh stage 5)")
    p.add_argument("--period_secs", type=float, default=0.75, help="subsegment shift")
    p.add_argument("--subseg_cmn", default=True, type=lambda x: x.lower() == "true",
                   help="true: CMN per window (the default); false: CMN once per "
                        "VAD segment (make_fbank.py)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def report_der(ref: Dict, hyp_rttm: str, collar: float) -> Dict[str, float]:
    """DER of the hypothesis RTTM against `ref` (utt -> turns), printed as
    examples/voxconverse/v{1,2}/run.py print it; returns der_details' dict."""
    d = der_details(ref, read_rttm(hyp_rttm), collar=collar)
    if d["total"] > 0:
        print("DER {:.2f}% (miss {:.2f}% fa {:.2f}% conf {:.2f}%)".format(
            100 * d["der"], 100 * d["miss"] / d["total"],
            100 * d["fa"] / d["total"], 100 * d["confusion"] / d["total"],
        ))
    else:
        print(f"DER undefined: reference has no scored speech (fa {d['fa']:.2f}s)")
    return d


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    model = load_model(args.model_dir, args.device)
    model.set_diarization_params(args.window_secs, args.period_secs,
                                 subseg_cmn=args.subseg_cmn)
    os.makedirs(os.path.dirname(args.out_rttm) or ".", exist_ok=True)

    all_segments = []
    with open(args.wav_scp) as f:
        for line in f:
            utt, path = line.split()[:2]
            segs = model.diarize(path, utt=utt, clusterer=args.clusterer)
            all_segments += [(u, b, e, f"spk{lab}") for (u, b, e, lab) in segs]
            print(f"{utt}: {len(segs)} segments")
    write_rttm(args.out_rttm, all_segments)
    print(f"hypothesis RTTM -> {args.out_rttm}")
    if args.ref_rttm:
        return report_der(read_rttm(args.ref_rttm), args.out_rttm, args.collar)
    return None


if __name__ == "__main__":
    main()
