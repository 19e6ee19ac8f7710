"""NIST SRE (16/18/21) v3 recipe on the port: the embedding-processing chain
before the PLDA back end.

Counterpart of `examples/sre/v3/run.py`, with its arguments plus
`--device` (CUDA unless the caller asks for the CPU) and `a.b.c=value`
overrides of `--config`:

  1. the CTS-superset key TSV -> wav.scp / utt2spk / spk2utt, system SAD
     (Silero from `--vad_npz`, else the energy VAD) into a `vad` file, the
     voiced-duration filter (`--dur_thres`), `cts_vox` (CTS + `--vox_dir`)
     and `cts_aug` (`--aug_copies` copies of every row);
  2. raw lists (VAD-cropped; shards of `cts_vox` with `data_type: shard`)
     and the aug stores;
  3. training on `cts_vox`;
  4. averaging and extraction of `cts_aug` and `--eval_sets`;
  5. export of the model directory (`EXP/export`);
  6. fit the chain (DEFAULT_CHAIN) on the CTS embeddings, train the PLDA on
     them as processed, score the trials through the chain;
  7. the chain's mean-subtraction refitted on the in-domain set, rescore;
  8. PLDA adaptation on the chain-processed in-domain set, rescore.

    python -m wespeaker_hubert_tpu_torch.recipes.sre_v3 --stage 1 --stop_stage 8 \\
        --config conf.yaml --data_root data --cts_dir CTS --exp_dir exp/sre_v3 \\
        --enroll_emb E.npz --enroll_utt2spk utt2mdl --test_emb T.npz --trials trials \\
        --indomain_emb major.npz [--device cuda|cpu] [a.b.c=value ...]

The chain and the PLDA run in float64 on the device (backend/processing.py,
backend/plda.py); the stage-1 helpers are host code.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import Dict, List, Optional

from ..backend.plda import TwoCovPLDA
from ..bin.embd_proc import apply_chain, prep_chain, update_chain
from ..bin.plda_bins import eval_plda, train_plda
from ..utils.embeddings import load_embeddings

__all__ = [
    "DEFAULT_CHAIN", "prepare_cts", "make_system_sad_file", "utt2voice_duration",
    "filter_by_voice_dur", "generate_aug_copies", "combine_data", "parse_args", "run",
    "main",
]

DEFAULT_CHAIN = (
    "mean-subtract | length-norm | lda --dim {dim} | length-norm"
)


# ---------------------------------------------------------------- stage 1-2
def prepare_cts(cts_dir, out_dir):
    """CTS-superset key TSV -> wav.scp / utt2spk / spk2utt (column 1 is the
    segment file, column 3 the speaker).  Audio is looked up under
    <cts_dir>/data/ as .wav, then .sph; NIST SPHERE files must be converted
    to RIFF wav first (the wav reader takes RIFF only), and the function
    exits naming the remedy when any is left."""
    key = os.path.join(cts_dir, "docs", "cts_superset_segment_key.tsv")
    os.makedirs(out_dir, exist_ok=True)
    spk2utt: Dict[str, List[str]] = {}
    n_sph = 0
    with open(key) as f, open(os.path.join(out_dir, "wav.scp"), "w") as ws, \
            open(os.path.join(out_dir, "utt2spk"), "w") as us:
        next(f)  # header
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 3:
                continue
            utt = os.path.splitext(cols[0])[0]
            spk = cols[2]
            base = os.path.join(cts_dir, "data", utt)
            path = next((base + ext for ext in (".wav", ".sph", "")
                         if os.path.exists(base + ext)), base + ".sph")
            if path.endswith(".sph"):
                n_sph += 1
            ws.write(f"{utt} {path}\n")
            us.write(f"{utt} {spk}\n")
            spk2utt.setdefault(spk, []).append(utt)
    if n_sph:
        raise SystemExit(
            f"prepare_cts: {n_sph} utterances are NIST SPHERE (.sph); "
            "convert them to RIFF wav first, e.g.\n"
            "  for f in data/*.sph; do ffmpeg -i $f -ar 8000 ${f%.sph}.wav; done\n"
            "then re-run stage 1 (the .wav next to each .sph is preferred).")
    with open(os.path.join(out_dir, "spk2utt"), "w") as f:
        for spk in sorted(spk2utt):
            f.write(spk + " " + " ".join(spk2utt[spk]) + "\n")
    return len(spk2utt)


def make_system_sad_file(wav_scp, vad_out, vad_npz=None, min_duration=0.255, threshold=0.18,
                         device="cpu"):
    """System SAD over a wav.scp -> a `seg_id utt begin end` vad file:
    Silero (`vad_npz`, run at 16 kHz: other rates are resampled first) at
    `threshold`, else the energy VAD; returns the segment count."""
    from ..data.wav_io import read_wav
    from ..diar.sad import system_sad

    vad_model = None
    if vad_npz and os.path.exists(vad_npz):
        from ..diar.silero import SileroVAD

        vad_model = SileroVAD.from_file(vad_npz, device=device)
    n = 0
    with open(wav_scp) as f, open(vad_out, "w") as out:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            utt, path = parts[0], parts[1]
            wav, sr = read_wav(path)
            if vad_model is not None and sr != 16000:
                # timestamps are seconds, so they map back unchanged
                from scipy.signal import resample_poly

                g = math.gcd(sr, 16000)
                wav = resample_poly(wav, 16000 // g, sr // g).astype("float32")
                sr = 16000
            segs = system_sad(wav, sr, vad_model=vad_model, min_duration=min_duration,
                              threshold=threshold)
            for i, (b, e) in enumerate(segs):
                out.write(f"{utt}-{i:04d} {utt} {b:.3f} {e:.3f}\n")
                n += 1
    return n


def utt2voice_duration(vad_file, out_path):
    """Voiced seconds per utterance of a vad file, in first-seen order."""
    durs: Dict[str, float] = {}
    with open(vad_file) as f:
        for line in f:
            parts = line.split()
            utt, b, e = parts[-3], float(parts[-2]), float(parts[-1])
            durs[utt] = durs.get(utt, 0.0) + e - b
    with open(out_path, "w") as f:
        for utt, d in durs.items():
            f.write(f"{utt} {d}\n")
    return durs


def filter_by_voice_dur(wav_scp, utt2dur_path, out_scp, dur_thres=5.0):
    """Keep the utterances with more than `dur_thres` voiced seconds."""
    durs = {}
    with open(utt2dur_path) as f:
        for line in f:
            u, d = line.split()
            durs[u] = float(d)
    n = 0
    with open(wav_scp) as f, open(out_scp, "w") as out:
        for line in f:
            if durs.get(line.split()[0], 0.0) > dur_thres:
                out.write(line)
                n += 1
    return n


def generate_aug_copies(ori_dir, aug_dir, aug_copy_num=2):
    """Every wav.scp / utt2spk / vad row as `_copy-i` rows, i in
    0..aug_copy_num: the PLDA training set's copies."""
    os.makedirs(aug_dir, exist_ok=True)
    for name in ("wav.scp", "utt2spk"):
        with open(os.path.join(ori_dir, name)) as f, \
                open(os.path.join(aug_dir, name), "w") as out:
            for line in f:
                parts = line.rstrip("\n").split(None, 1)
                if len(parts) < 2:
                    continue
                for i in range(aug_copy_num + 1):
                    out.write(f"{parts[0]}_copy-{i} {parts[1]}\n")
    vad = os.path.join(ori_dir, "vad")
    if os.path.exists(vad):
        with open(vad) as f, open(os.path.join(aug_dir, "vad"), "w") as out:
            for line in f:
                seg, utt, rest = line.rstrip("\n").split(None, 2)
                for i in range(aug_copy_num + 1):
                    out.write(f"{seg}_copy-{i} {utt}_copy-{i} {rest}\n")


def combine_data(out_dir, in_dirs):
    """wav.scp / utt2spk / vad of several data dirs, concatenated."""
    os.makedirs(out_dir, exist_ok=True)
    for name in ("wav.scp", "utt2spk", "vad"):
        rows = []
        for d in in_dirs:
            p = os.path.join(d, name)
            if os.path.exists(p):
                with open(p) as f:
                    rows.extend(f.read().splitlines())
        if rows:
            with open(os.path.join(out_dir, name), "w") as f:
                f.write("\n".join(rows) + "\n")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stage", type=int, default=6)
    p.add_argument("--stop_stage", type=int, default=8)
    p.add_argument("--exp_dir", default="exp/sre_v3")
    p.add_argument("--train_emb", default=None,
                   help="CTS(-aug) back-end training embeddings .npz (from --config's stage 4 "
                        "when omitted)")
    p.add_argument("--train_utt2spk", default=None)
    p.add_argument("--enroll_emb", default=None)
    p.add_argument("--enroll_utt2spk", default=None,
                   help="utt2mdl mapping for multisession enrollment")
    p.add_argument("--test_emb", default=None)
    p.add_argument("--trials", default=None)
    p.add_argument("--indomain_emb", default=None,
                   help="unlabeled in-domain .npz (sre16 major / sre18 unlabeled)")
    p.add_argument("--lda_dim", type=int, default=100)
    p.add_argument("--chain", default=None, help="override the processing-chain string")
    p.add_argument("--em_iters", type=int, default=5)
    p.add_argument("--config", default=None, help="extractor train config")
    p.add_argument("--data_root", default="data")
    p.add_argument("--cts_dir", default=None, help="CTS-superset root (docs/ + data/)")
    p.add_argument("--vox_dir", default=None,
                   help="optional VoxCeleb data dir merged into cts_vox")
    p.add_argument("--vad_npz", default=None, help="Silero parameters; energy VAD without")
    p.add_argument("--aug_copies", type=int, default=2)
    p.add_argument("--dur_thres", type=float, default=5.0)
    p.add_argument("--eval_sets", default="sre16_major,sre16_enroll,sre16_test",
                   help="data-root subdirs (wav.scp [+utt2spk]) to extract")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*", help="a.b.c=value overrides of --config")
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> Dict[int, Dict]:
    """Stages [args.stage, args.stop_stage]; returns {stage: {"s": seconds,
    "lines": printed result lines}}."""
    device = args.device
    os.makedirs(args.exp_dir, exist_ok=True)
    done: Dict[int, Dict] = {}

    def begin(s: int, what: str) -> List[str]:
        print(f"stage {s}: {what}", flush=True)
        done[s] = {"lines": [], "t0": time.perf_counter()}
        return done[s]["lines"]

    def end(s: int) -> None:
        done[s]["s"] = time.perf_counter() - done[s].pop("t0")

    def in_range(s: int) -> bool:
        return args.stage <= s <= args.stop_stage

    config = exp_dir = emb_dir = None
    if args.config:
        from ..utils.config import apply_overrides, load_config

        config = apply_overrides(load_config(args.config), args.overrides)
        exp_dir = config["exp_dir"]
        emb_dir = os.path.join(exp_dir, "embeddings")
    eval_sets = [s for s in args.eval_sets.split(",") if s.strip()]

    if in_range(1) and args.cts_dir:
        begin(1, "CTS-superset prep + system SAD + voice-dur filter")
        cts = os.path.join(args.data_root, "cts")
        prepare_cts(args.cts_dir, cts)
        make_system_sad_file(os.path.join(cts, "wav.scp"), os.path.join(cts, "vad"),
                             vad_npz=args.vad_npz, device=device)
        utt2voice_duration(os.path.join(cts, "vad"), os.path.join(cts, "utt2voice_dur"))
        # short utterances out, wav.scp rewritten in place
        filtered = os.path.join(cts, "wav.scp.filtered")
        filter_by_voice_dur(os.path.join(cts, "wav.scp"), os.path.join(cts, "utt2voice_dur"),
                            filtered, dur_thres=args.dur_thres)
        os.replace(filtered, os.path.join(cts, "wav.scp"))
        combine_data(os.path.join(args.data_root, "cts_vox"),
                     [cts] + ([args.vox_dir] if args.vox_dir else []))
        generate_aug_copies(cts, os.path.join(args.data_root, "cts_aug"),
                            aug_copy_num=args.aug_copies)
        end(1)

    if in_range(2):
        begin(2, "shard/raw lists (VAD-cropped) + aug stores")
        from ..bin.tools import build_aug_store, make_raw_list, make_shard_list

        def vad_of(d):
            v = os.path.join(d, "vad")
            return v if os.path.exists(v) else None

        cv = os.path.join(args.data_root, "cts_vox")
        if os.path.exists(os.path.join(cv, "wav.scp")):
            if config and config.get("data_type", "raw") == "shard":
                make_shard_list(os.path.join(cv, "wav.scp"), os.path.join(cv, "utt2spk"),
                                os.path.join(cv, "shards"), os.path.join(cv, "shard.list"),
                                vad_file=vad_of(cv))
            make_raw_list(os.path.join(cv, "wav.scp"), os.path.join(cv, "utt2spk"),
                          os.path.join(cv, "raw.list"), vad_of(cv))
        for dset in ["cts_aug"] + eval_sets:
            dd = os.path.join(args.data_root, dset)
            if not os.path.exists(os.path.join(dd, "wav.scp")):
                continue
            u2s = os.path.join(dd, "utt2spk")
            if not os.path.exists(u2s):
                # unlabeled sets: a dummy speaker
                with open(os.path.join(dd, "wav.scp")) as ws, open(u2s, "w") as f:
                    for ln in ws:
                        f.write(f"{ln.split()[0]} unk\n")
            make_raw_list(os.path.join(dd, "wav.scp"), u2s, os.path.join(dd, "raw.list"),
                          vad_of(dd))
        for x in ("musan", "rirs"):
            scp = os.path.join(args.data_root, x, "wav.scp")
            store = os.path.join(args.data_root, f"{x}_aug_store")
            if os.path.exists(scp) and not os.path.exists(store):
                build_aug_store(scp, store)
        end(2)

    if in_range(3) and config:
        begin(3, "train extractor on cts_vox")
        from ..bin.train import train

        train(config, device=device)
        end(3)

    if in_range(4) and config:
        begin(4, "average + extract embeddings per set")
        from ..bin.average_model import average_model
        from ..bin.extract import extract

        avg_ckpt = os.path.join(exp_dir, "avg_model.pt")
        average_model(os.path.join(exp_dir, "models"), avg_ckpt, num=config.get("num_avg", 10))
        for dset in ["cts_aug"] + eval_sets:
            lst = os.path.join(args.data_root, dset, "raw.list")
            if os.path.exists(lst):
                extract(config, lst, avg_ckpt, os.path.join(emb_dir, f"{dset}.npz"),
                        device=device)
        end(4)

    if in_range(5) and config:
        begin(5, "export the final model")
        from ..bin.export_model import export_model

        export_model(exp_dir, os.path.join(exp_dir, "export"),
                     checkpoint=os.path.join(exp_dir, "avg_model.pt"))
        end(5)

    if args.stop_stage < 6:
        return done
    # the back end's inputs default to the front half's outputs
    if emb_dir and not args.train_emb:
        args.train_emb = os.path.join(emb_dir, "cts_aug.npz")
        args.train_utt2spk = args.train_utt2spk or os.path.join(args.data_root, "cts_aug",
                                                                "utt2spk")
    if args.train_emb is None or args.enroll_emb is None:
        if args.stage >= 6:
            raise ValueError("stages 6-8 need --train_emb/--enroll_emb/--test_emb (or "
                             "--config with extracted embeddings)")
        return done
    chain_str = args.chain or DEFAULT_CHAIN.format(dim=args.lda_dim)
    chain_path = os.path.join(args.exp_dir, "embd_proc_cts.npz")
    plda_path = os.path.join(args.exp_dir, "plda.npz")
    proc_dir = os.path.join(args.exp_dir, "proc_emb")
    os.makedirs(proc_dir, exist_ok=True)

    def processed(chain_file, emb_path, name):
        out = os.path.join(proc_dir, name)
        apply_chain(chain_file, emb_path, out, device=device)
        return out

    def score_with(chain_file, plda_file, tag, lines):
        """Chain-process enroll and test, PLDA-score the trials."""
        _, eer, mindcf = eval_plda(
            plda_file, processed(chain_file, args.enroll_emb, f"{tag}_enroll.npz"),
            processed(chain_file, args.test_emb, f"{tag}_test.npz"), args.trials,
            os.path.join(args.exp_dir, "scores", f"{tag}.score"),
            enroll_utt2spk=args.enroll_utt2spk, device=device)
        if eer is not None:
            lines.append(f"{tag}.score: EER {eer:.3f}% minDCF {mindcf:.4f}")

    if in_range(6):
        lines = begin(6, f"fit chain [{chain_str}] + train PLDA + score")
        prep_chain(chain_str, args.train_emb, chain_path, utt2spk=args.train_utt2spk,
                   device=device)
        train_plda(processed(chain_path, args.train_emb, "cts.npz"), args.train_utt2spk,
                   plda_path, em_iters=args.em_iters, device=device)
        score_with(chain_path, plda_path, "plda_ctsmean", lines)
        end(6)

    chain_indom = os.path.join(args.exp_dir, "embd_proc_indomain.npz")
    if in_range(7) and args.indomain_emb:
        lines = begin(7, "in-domain mean (update chain link 0) + rescore")
        # the CTS mean-subtraction replaced by the in-domain mean, nothing
        # else refitted
        update_chain(chain_path, args.indomain_emb, chain_indom, device=device)
        score_with(chain_indom, plda_path, "plda_indomainmean", lines)
        end(7)

    if in_range(8) and args.indomain_emb:
        lines = begin(8, "PLDA adaptation on chain-processed in-domain data")
        chain_file = chain_indom if os.path.exists(chain_indom) else chain_path
        _, indom = load_embeddings(processed(chain_file, args.indomain_emb, "indomain.npz"))
        adapted = TwoCovPLDA.load(plda_path, device=device).adapt(indom, ac_scale=0.5,
                                                                  wc_scale=0.5)
        adapted_path = os.path.join(args.exp_dir, "plda_adapt.npz")
        adapted.save(adapted_path)
        score_with(chain_file, adapted_path, "plda_adapt", lines)
        end(8)
    return done


def main(argv: Optional[List[str]] = None) -> Dict[int, Dict]:
    import logging

    import torch

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return run(args)


if __name__ == "__main__":
    main()
