"""A/B of K2's float32 kernels and the float32 paths that run them, across
source trees.

For each tree named on the command line, in the order given, one child
process runs from that tree (its own `wespeaker_hubert_tpu_torch` and
`chip_smoke.py`) on the card:

- `chip_smoke.phase_build`, then `phase_k2_checks` and `phase_k2_bwd_checks`:
  every float32 K2 row (WavLM's gated bias, key lengths, a broadcast bias,
  no bias; Whisper's shapes), each kernel's device time (profiler) and its
  error against the plain version;
- `chip_smoke.phase_ssl_extract`: WavLM-Large + ECAPA extraction through
  bin/extract, bf16 and float32 (the float32 run goes through the float32
  forward with the factored gated bias), its audio-seconds per second.

Run parent, change, change, parent on one card, e.g. with the parent
unpacked by `git archive` into a git-ignored directory:

    python3 perf_k2_f32_ab.py build/parent . . build/parent

Prints one JSON line per child and writes them all to
chiprun_out/k2_f32_ab.json.  Imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, tempfile
import chip_smoke

report, failed = {}, {}
for name, fn, args in (("build", chip_smoke.phase_build, ()),
                       ("k2", chip_smoke.phase_k2_checks, ()),
                       ("k2_bwd", chip_smoke.phase_k2_bwd_checks, ())):
    try:
        fn(report, *args)
    except chip_smoke.PhaseFailed as e:
        failed[name] = str(e)
with tempfile.TemporaryDirectory() as root:
    try:
        chip_smoke.phase_ssl_extract(report, root)
    except chip_smoke.PhaseFailed as e:
        failed["ssl"] = str(e)

keep = ("shape", "bias", "key_len", "max_abs_s", "seed", "ok", "ms", "dkv_ms", "dq_ms",
        "max_abs_err", "max_abs_err_vs_f64", "bar_vs_f64", "library_ms")
rows = lambda key: [{k: r[k] for k in keep if k in r} for r in report.get(key, [])
                    if r["dtype"] == "f32"]
ssl = report.get("ssl_extract", {})
out = {"failed": failed, "fwd": rows("k2_checks") + rows("k2_whisper_checks"),
       "bwd": rows("k2_bwd_checks") + rows("k2_whisper_bwd_checks"),
       "ssl_audio_s_per_s": {t: ssl[t]["audio_s_per_s"] for t in ("bf16", "f32") if t in ssl},
       "ssl_f32_cos_min": min(ssl.get("cos_f32_card_vs_cpu", {0: None}).values())}
print("AB_RESULT " + json.dumps(out), flush=True)
"""


def main(argv):
    trees = argv or ["."]
    results = []
    for i, tree in enumerate(trees):
        tree = Path(tree).resolve()
        env = dict(os.environ, PYTHONPATH=str(tree))
        proc = subprocess.run([sys.executable, "-u", "-c", CHILD], cwd=tree, env=env,
                              capture_output=True, text=True, timeout=900)
        line = next((x for x in proc.stdout.splitlines() if x.startswith("AB_RESULT ")), None)
        if proc.returncode != 0 or line is None:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
            raise SystemExit(f"run {i} in {tree} failed ({proc.returncode})")
        row = {"run": i, "tree": str(tree), **json.loads(line[len("AB_RESULT "):])}
        results.append(row)
        print(json.dumps(row), flush=True)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "k2_f32_ab.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
