"""Kaldi-style data-directory utilities.

Counterpart of `wespeaker_hubert_tpu/bin/datadir.py`: the operations of
Kaldi's data-dir scripts (filter_scp.pl, utt2spk_to_spk2utt.pl,
spk2utt_to_utt2spk.pl, fix_data_dir.sh, subset_data_dir.sh,
combine_data.sh, copy_data_dir.sh) as plain Python over a data dir of
per-utterance tables:

    wav.scp   <utt> <path>
    utt2spk   <utt> <spk>
    spk2utt   <spk> <utt> <utt> ...
    utt2dur / feats.scp / vad.scp / text   optional extras

    python -m wespeaker_hubert_tpu_torch.bin.datadir fix DIR
    python -m wespeaker_hubert_tpu_torch.bin.datadir subset SRC DEST --n 100 [--mode ...]
    python -m wespeaker_hubert_tpu_torch.bin.datadir combine DEST SRC [SRC ...]
    python -m wespeaker_hubert_tpu_torch.bin.datadir copy SRC DEST [--utt_list L | --spk_list L]
    python -m wespeaker_hubert_tpu_torch.bin.datadir filter_scp ID_LIST SCP [-f N] [--exclude]
    python -m wespeaker_hubert_tpu_torch.bin.datadir utt2spk_to_spk2utt | spk2utt_to_utt2spk TABLE

All tables are kept key-sorted (Kaldi's LC_ALL=C invariant) and
`fix_data_dir` restores the cross-table key intersection as fix_data_dir.sh
does.  The seeded subsets draw what the JAX package draws.
"""

from __future__ import annotations

import os
import random
import shutil
from typing import Dict, Iterable, List, Optional, Sequence

__all__ = [
    "filter_scp",
    "utt2spk_to_spk2utt",
    "spk2utt_to_utt2spk",
    "fix_data_dir",
    "subset_data_dir",
    "combine_data",
    "copy_data_dir",
]

# per-utterance tables fix/subset/combine operate on when present
_UTT_TABLES = ("wav.scp", "utt2spk", "utt2dur", "feats.scp", "vad.scp", "text")
# tables that DEFINE the utterance set (fix intersects over these);
# the rest (utt2dur, vad.scp) are auxiliary and only get filtered —
# kaldi's fix_data_dir.sh never lets a partial utt2dur shrink the data
_CORE_TABLES = ("wav.scp", "utt2spk", "feats.scp", "text")


def _read_lines(path: str) -> List[str]:
    with open(path) as f:
        return [ln.rstrip("\n") for ln in f if ln.strip()]


def _write_lines(path: str, lines: Iterable[str]) -> None:
    with open(path, "w") as f:
        for ln in lines:
            f.write(ln + "\n")


def filter_scp(
    ids: Sequence[str],
    lines: Sequence[str],
    field: int = 1,
    exclude: bool = False,
) -> List[str]:
    """Keep the lines whose `field`-th (1-based) token is in `ids`
    (Kaldi's filter_scp.pl, with its -f and --exclude switches).  `ids`
    entries may be full lines; only their first token
    counts, like the perl script."""
    keep = {i.split()[0] for i in ids if i.strip()}
    out = []
    for ln in lines:
        toks = ln.split()
        if len(toks) < field:
            continue
        if (toks[field - 1] in keep) != exclude:
            out.append(ln)
    return out


def utt2spk_to_spk2utt(lines: Sequence[str]) -> List[str]:
    """utt2spk lines -> spk2utt lines (utt2spk_to_spk2utt.pl); speakers
    sorted, utts in input order."""
    spk2utt: Dict[str, List[str]] = {}
    for ln in lines:
        utt, spk = ln.split()[:2]
        spk2utt.setdefault(spk, []).append(utt)
    return [f"{spk} {' '.join(us)}" for spk, us in sorted(spk2utt.items())]


def spk2utt_to_utt2spk(lines: Sequence[str]) -> List[str]:
    """spk2utt lines -> sorted utt2spk lines (spk2utt_to_utt2spk.pl)."""
    out = []
    for ln in lines:
        toks = ln.split()
        out.extend(f"{u} {toks[0]}" for u in toks[1:])
    return sorted(out)


def _utt_keys(d: str, name: str) -> List[str]:
    return [ln.split()[0] for ln in _read_lines(os.path.join(d, name))]


def fix_data_dir(d: str) -> int:
    """Sort every per-utt table by key and drop utts missing from any of
    them (fix_data_dir.sh); spk2utt is rebuilt from the
    fixed utt2spk.  Returns the surviving utterance count."""
    present = [n for n in _UTT_TABLES if os.path.exists(os.path.join(d, n))]
    core = [n for n in present if n in _CORE_TABLES]
    if not core:
        raise FileNotFoundError(f"{d}: no data-dir tables found")
    common: Optional[set] = None
    for n in core:
        keys = set(_utt_keys(d, n))
        common = keys if common is None else common & keys
    for n in present:
        lines = _read_lines(os.path.join(d, n))
        lines = sorted(
            (ln for ln in lines if ln.split()[0] in common),
            key=lambda ln: ln.split()[0],
        )
        _write_lines(os.path.join(d, n), lines)
    if "utt2spk" in present:
        _write_lines(
            os.path.join(d, "spk2utt"),
            utt2spk_to_spk2utt(_read_lines(os.path.join(d, "utt2spk"))),
        )
    return len(common)


def _materialize(src: str, dest: str, utts: Sequence[str]) -> None:
    os.makedirs(dest, exist_ok=True)
    keep = list(utts)
    for n in _UTT_TABLES:
        p = os.path.join(src, n)
        if os.path.exists(p):
            _write_lines(
                os.path.join(dest, n), filter_scp(keep, _read_lines(p))
            )
    fix_data_dir(dest)


def subset_data_dir(
    src: str,
    dest: str,
    n: Optional[int] = None,
    mode: str = "random",
    utt_list: Optional[str] = None,
    spk_list: Optional[str] = None,
    seed: int = 777,
) -> int:
    """Subset a data dir (subset_data_dir.sh).

    Modes with `n` utterances: 'random' (default), 'first', 'last',
    'shortest' (needs utt2dur), 'speakers' (random speakers until n utts
    are covered), 'per-spk' (up to n utts per speaker).  Alternatively
    pass `utt_list` / `spk_list` files.  Returns the utt count kept."""
    u2s = _read_lines(os.path.join(src, "utt2spk"))
    utts = [ln.split()[0] for ln in u2s]
    if utt_list:
        keep = [u.split()[0] for u in _read_lines(utt_list)]
    elif spk_list:
        spks = {s.split()[0] for s in _read_lines(spk_list)}
        keep = [ln.split()[0] for ln in u2s if ln.split()[1] in spks]
    else:
        assert n is not None, "n required without utt_list/spk_list"
        if mode == "first":
            keep = utts[:n]
        elif mode == "last":
            keep = utts[-n:] if n else []
        elif mode == "shortest":
            durs = dict(
                ln.split()[:2]
                for ln in _read_lines(os.path.join(src, "utt2dur"))
            )
            keep = sorted(utts, key=lambda u: float(durs[u]))[:n]
        elif mode == "speakers":
            spk_utts: Dict[str, List[str]] = {}
            for ln in u2s:
                u, s = ln.split()[:2]
                spk_utts.setdefault(s, []).append(u)
            order = sorted(spk_utts)
            random.Random(seed).shuffle(order)
            keep = []
            for s in order:
                if len(keep) >= n:
                    break
                keep.extend(spk_utts[s])
        elif mode == "per-spk":
            spk_utts = {}
            for ln in u2s:
                u, s = ln.split()[:2]
                spk_utts.setdefault(s, []).append(u)
            keep = [u for s in sorted(spk_utts) for u in spk_utts[s][:n]]
        elif mode == "random":
            keep = sorted(random.Random(seed).sample(utts, min(n, len(utts))))
        else:
            raise ValueError(f"unknown subset mode {mode!r}")
    _materialize(src, dest, keep)
    return len(_utt_keys(dest, "utt2spk"))


def combine_data(dest: str, srcs: Sequence[str]) -> int:
    """Concatenate data dirs into `dest` (combine_data.sh:
    only tables present in EVERY source are combined), then fix.  Returns
    the combined utt count."""
    assert srcs, "no source dirs"
    for s in srcs:
        if not os.path.exists(os.path.join(s, "utt2spk")):
            raise FileNotFoundError(f"{s}/utt2spk")
    os.makedirs(dest, exist_ok=True)
    all_utts: List[str] = []
    for s in srcs:
        all_utts.extend(_utt_keys(s, "utt2spk"))
    if len(set(all_utts)) != len(all_utts):
        dupes = sorted({u for u in all_utts if all_utts.count(u) > 1})
        # combine_data.sh exits 1 on duplicate utt-ids
        raise ValueError(f"duplicate utt ids across sources: {dupes[:10]}")
    shared = [
        n for n in _UTT_TABLES
        if all(os.path.exists(os.path.join(s, n)) for s in srcs)
    ]
    for n in shared:
        lines: List[str] = []
        for s in srcs:
            lines.extend(_read_lines(os.path.join(s, n)))
        _write_lines(os.path.join(dest, n), lines)
    return fix_data_dir(dest)


def copy_data_dir(
    src: str,
    dest: str,
    utt_list: Optional[str] = None,
    spk_list: Optional[str] = None,
) -> int:
    """Copy a data dir, optionally restricted to an utt or spk list
    (copy_data_dir.sh).  Returns the utt count."""
    assert os.path.abspath(src) != os.path.abspath(dest), "src == dest"
    assert not (utt_list and spk_list), "pass utt_list OR spk_list"
    if utt_list or spk_list:
        return subset_data_dir(
            src, dest, utt_list=utt_list, spk_list=spk_list
        )
    os.makedirs(dest, exist_ok=True)
    for n in _UTT_TABLES + ("spk2utt",):
        p = os.path.join(src, n)
        if os.path.exists(p):
            shutil.copy(p, os.path.join(dest, n))
    return fix_data_dir(dest)


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    f = sub.add_parser("filter_scp", help="filter lines by id list")
    f.add_argument("id_list")
    f.add_argument("scp")
    f.add_argument("-f", "--field", type=int, default=1)
    f.add_argument("--exclude", action="store_true")

    for name in ("utt2spk_to_spk2utt", "spk2utt_to_utt2spk"):
        c = sub.add_parser(name)
        c.add_argument("table")

    c = sub.add_parser("fix", help="fix_data_dir.sh role")
    c.add_argument("dir")

    c = sub.add_parser("subset", help="subset_data_dir.sh role")
    c.add_argument("src")
    c.add_argument("dest")
    c.add_argument("--n", type=int)
    c.add_argument("--mode", default="random",
                   choices=["random", "first", "last", "shortest",
                            "speakers", "per-spk"])
    c.add_argument("--utt_list")
    c.add_argument("--spk_list")
    c.add_argument("--seed", type=int, default=777)

    c = sub.add_parser("combine", help="combine_data.sh role")
    c.add_argument("dest")
    c.add_argument("srcs", nargs="+")

    c = sub.add_parser("copy", help="copy_data_dir.sh role")
    c.add_argument("src")
    c.add_argument("dest")
    c.add_argument("--utt_list")
    c.add_argument("--spk_list")

    args = p.parse_args()
    if args.cmd == "filter_scp":
        for ln in filter_scp(
            _read_lines(args.id_list), _read_lines(args.scp),
            field=args.field, exclude=args.exclude,
        ):
            print(ln)
    elif args.cmd == "utt2spk_to_spk2utt":
        for ln in utt2spk_to_spk2utt(_read_lines(args.table)):
            print(ln)
    elif args.cmd == "spk2utt_to_utt2spk":
        for ln in spk2utt_to_utt2spk(_read_lines(args.table)):
            print(ln)
    elif args.cmd == "fix":
        print(fix_data_dir(args.dir))
    elif args.cmd == "subset":
        print(subset_data_dir(
            args.src, args.dest, n=args.n, mode=args.mode,
            utt_list=args.utt_list, spk_list=args.spk_list, seed=args.seed,
        ))
    elif args.cmd == "combine":
        print(combine_data(args.dest, args.srcs))
    elif args.cmd == "copy":
        print(copy_data_dir(
            args.src, args.dest, utt_list=args.utt_list,
            spk_list=args.spk_list,
        ))


if __name__ == "__main__":
    main()
