"""A/B of the port's K2 host time and bf16 train step across source trees.

For each tree named on the command line, in the order given, one child
process runs from that tree (its own `wespeaker_hubert_tpu_torch` and
`chip_smoke.py`) on the card and measures:

- one WavLM layer's attention at the training shape (64, 75, 16, 64) bf16
  as that tree's encoder calls it (the gated bias as table + gate where
  `flash_attention` takes `bias_gate`, else materialized as
  gate * table[None]), forward and backward through autograd:
  - host microseconds per call (wall time of calls issued back to back,
    before one synchronize), forward alone and forward + backward;
  - of those, the microseconds inside the C entry points (tensor-map
    encoding and launch), by wrapping the ctypes library;
  - device milliseconds per forward + backward (CUDA events);
- `chip_smoke.phase_train`: bin/train's 6 bf16 steps of batch 64 on
  WavLM-Large + ECAPA_TDNN_GLOB_c512, the step times.

Run parent, change, change, parent on one card, e.g. with the parent
unpacked by `git archive` into a git-ignored directory:

    python3 perf_torch_train_ab.py build/parent . . build/parent

Prints one JSON line per child and writes them all to
chiprun_out/train_ab.json.  Imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import inspect, json, statistics, tempfile, time
import torch
import chip_smoke
from wespeaker_hubert_tpu_torch.ops import flash_attention as k2

report = {}
chip_smoke.phase_build(report)
b, t, h = 64, 75, 16
gen = torch.Generator(device="cuda").manual_seed(0)
bf = torch.bfloat16
q, k, v = (torch.randn((b, t, h, 64), generator=gen, device="cuda").to(bf).requires_grad_()
           for _ in range(3))
pad = -t % 8
table_rows = torch.randn((h, t, t + pad), generator=gen, device="cuda").to(bf).requires_grad_()
gate = (1.0 + 2.0 * torch.rand((b, h, t, 1), generator=gen, device="cuda")).to(bf)
gate.requires_grad_()
dout = torch.randn((b, t, h, 64), generator=gen, device="cuda").to(bf)
factored = "bias_gate" in inspect.signature(k2.flash_attention).parameters


def forward():
    table = table_rows[..., :t]
    if factored:
        return k2.flash_attention(q, k, v, bias=table, scale=0.125, bias_gate=gate)
    return k2.flash_attention(q, k, v, bias=gate * table[None], scale=0.125)


def forward_backward():
    forward().backward(dout)


class Timed:
    # the ctypes library with the wall time of its entry points summed
    def __init__(self, lib):
        self.lib, self.s = lib, 0.0

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if not name.startswith("flash_attention_") or name.endswith("error_string"):
            return fn

        def call(*args):
            t0 = time.perf_counter()
            rc = fn(*args)
            self.s += time.perf_counter() - t0
            return rc
        return call


def host_us(fn, n):
    fn()
    torch.cuda.synchronize()
    k2._LIB, k2._BWD_LIB = Timed(k2._library()), Timed(k2._bwd_library())
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    wall = (time.perf_counter() - t0) / n * 1e6
    inside = (k2._LIB.s + k2._BWD_LIB.s) / n * 1e6
    torch.cuda.synchronize()
    k2._LIB, k2._BWD_LIB = k2._LIB.lib, k2._BWD_LIB.lib
    return wall, inside


def device_ms(fn, n=20):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(n):
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


out = {"factored_bias": factored}
reps = []
for _ in range(5):  # medians over 5 repetitions of 50 calls each
    f_us, f_in = host_us(forward, 50)
    fb_us, fb_in = host_us(forward_backward, 50)
    reps.append((f_us, f_in, fb_us, fb_in))
cols = list(zip(*reps))
out.update(fwd_host_us=statistics.median(cols[0]), fwd_c_entry_us=statistics.median(cols[1]),
           fwd_bwd_host_us=statistics.median(cols[2]),
           fwd_bwd_c_entry_us=statistics.median(cols[3]),
           fwd_bwd_device_ms=device_ms(forward_backward), host_us_reps=reps)
q.grad = k.grad = v.grad = table_rows.grad = gate.grad = None
del q, k, v, table_rows, gate, dout
torch.cuda.empty_cache()
with tempfile.TemporaryDirectory() as root:
    chip_smoke.phase_train(report, root)
tr = report["train"]
out.update(step_ms=tr["step_ms"], step_ms_median_after_first=tr["step_ms_median_after_first"],
           launches=tr["launches"])
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
        print(json.dumps({k: v for k, v in row.items() if k != "host_us_reps"}), flush=True)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "train_ab.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
