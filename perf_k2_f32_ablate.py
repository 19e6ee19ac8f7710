#!/usr/bin/env python3
"""What K2's float32 kernels (3xTF32 on wgmma) spend their time on, on one
NVIDIA GPU: each kernel built as it is and in variants with a part taken out,
timed at Whisper-large-v2's shapes.

    python3 perf_k2_f32_ablate.py

The variants are compiled from copies of wespeaker_hubert_tpu_torch/csrc
under build/ablate/ with a textual change each, and are wrong on purpose
(they only time):
  design     the sources as they are;
  cvt_split  the tf32 rounding of the split by cvt.rna.tf32.f32 (the same
             bits as the design's integer rounding);
  no_split   the split pass of each key (forward) or query (dK/dV) tile left
             out: the products read tiles the pass did not write;
  one_pass   only the hi x hi pass of each product (1xTF32's tensor work);
  no_wgmma   the products left out (the split pass, softmax and loads alone).
Each is timed by torch.profiler (the kernel's device time per launch) in
turns: design, variants, design.  Writes k2_f32_ablate.json into
chip_smoke's output directory.

The textual changes match the float32 kernels' sources as they were when
PERF.md §7's ablation was taken; an edit to those kernels can make a change
miss (`str.index` raises) or break the build, and the script then has to be
brought up to date with them before it measures anything.
"""

import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from wespeaker_hubert_tpu_torch.ops import flash_attention as k2  # noqa: E402
from wespeaker_hubert_tpu_torch.utils import cuda_build  # noqa: E402

FWD_SHAPES = ((16, 1500), (64, 251))
BWD_SHAPES = ((16, 251),)


def _drop_loop(src, head):
    """`src` without the `#pragma unroll` for-loop statement that starts with
    `head` (one line, or a braced body)."""
    start = src.index(head)
    start = src.rindex("#pragma unroll", 0, start)
    line_end = src.index("\n", src.index(head))  # the end of the `for` line
    if src[line_end - 1] == "{":
        depth, i = 1, line_end + 1
        while depth:
            depth += {"{": 1, "}": -1}.get(src[i], 0)
            i += 1
        end = src.index("\n", i) + 1
    elif src[line_end - 1] == ";":  # the body on the `for` line
        end = line_end + 1
    else:  # the body on the next line
        end = src.index(";\n", line_end) + 2
    return src[:start] + src[end:]


CVT = """__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));
  return r;
}"""


ALL_TERMS = "for (int term = 0; term < 3; ++term)"  # a product's three passes


def variant_sources(name):
    """{file name: text} of the header and the forward's and the backward's
    sources for variant `name`."""
    head = (cuda_build.CSRC_DIR / "flash_sm90.cuh").read_text()
    fwd = (cuda_build.CSRC_DIR / "flash_attention.cu").read_text()
    bwd = (cuda_build.CSRC_DIR / "flash_attention_bwd.cu").read_text()
    if name == "cvt_split":  # the split by cvt.rna.tf32.f32
        start = head.index("__device__ __forceinline__ uint32_t to_tf32(float x) {")
        end = head.index("\n}\n", start) + 2
        head = head[:start] + CVT + head[end:]
    f0 = fwd.index("flash_fwd_f32_sm90(const")
    b0 = bwd.index("flash_bwd_dkv_f32_sm90(const")
    fk, bk = fwd[f0:], bwd[b0:]  # the float32 kernels and what follows them
    if name == "no_split":
        for call in ("    split_tile(st, khi, klo", "    split_transposed<C::BN>(st + C::KV_BYTES"):
            line = fk[fk.index(call):fk.index("\n", fk.index(call)) + 1]
            fk = fk.replace(line, "", 1)
        for call in ("    sm90::split_tile(st, qhi", "    sm90::split_transposed<C::BQ>(st, qthi",
                     "    sm90::split_tile(st + C::QT_BYTES",
                     "    sm90::split_transposed<C::BQ>(st + C::QT_BYTES"):
            line = bk[bk.index(call):bk.index("\n", bk.index(call)) + 1]
            bk = bk.replace(line, "", 1)
    elif name == "one_pass":
        fk = fk.replace(ALL_TERMS, "for (int term = 2; term < 3; ++term)", 1)
        for loop in ("(o, pl[ks]", "(o, ph[ks], desc_k(vtlo"):
            fk = _drop_loop(fk, "for (int ks = 0; ks < 8; ++ks)\n      wgmma_tf32_rs64" + loop)
        bk = bk.replace(ALL_TERMS, "for (int term = 2; term < 3; ++term)", 2)
        for loop in ("(dv, pl[ks]", "(dv, ph[ks], desc_k(dotlo)", "(dk, sl[ks]",
                     "(dk, sh[ks], desc_k(qtlo)"):
            bk = _drop_loop(bk, "for (int ks = 0; ks < 4; ++ks) wgmma_tf32_rs64" + loop)
    elif name == "no_wgmma":
        fk = fk.replace(ALL_TERMS, "for (int term = 3; term < 3; ++term)", 1)
        for _ in range(3):
            fk = _drop_loop(fk, "for (int ks = 0; ks < 8; ++ks)\n      wgmma_tf32_rs64(o")
        bk = bk.replace(ALL_TERMS, "for (int term = 3; term < 3; ++term)", 2)
        for _ in range(6):
            bk = _drop_loop(bk, "for (int ks = 0; ks < 4; ++ks) wgmma_tf32_rs64(")
    elif name not in ("design", "cvt_split"):
        raise ValueError(name)
    return {"flash_sm90.cuh": head, "flash_attention.cu": fwd[:f0] + fk,
            "flash_attention_bwd.cu": bwd[:b0] + bk}


def build(name):
    """The variant's two libraries, compiled into build/ablate/<name>/."""
    out = ROOT / "build" / "ablate" / name
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    libs = {}
    sources = variant_sources(name)
    (out / "flash_sm90.cuh").write_text(sources.pop("flash_sm90.cuh"))
    for fname, text in sources.items():
        (out / fname).write_text(text)
        so = out / f"lib{Path(fname).stem}.so"
        proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
                               str(out / fname)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}/{fname}:\n{proc.stderr[-3000:]}")
        libs[fname] = ctypes.CDLL(str(so))
    return libs


def use(libs):
    """Points the K2 wrappers at a variant's libraries (their argtypes set
    as the wrappers' own loaders set them)."""
    k2._LIB = k2._BWD_LIB = None
    real = cuda_build.load_library
    try:
        cuda_build.load_library = lambda name, sources: libs[sources[0]]
        k2._library()
        k2._bwd_library()
    finally:
        cuda_build.load_library = real


def time_variant(results, name):
    for b, t in FWD_SHAPES:
        q, k, v = cs.whisper_qkv(b, t, torch.float32, 700 + b + t)
        ms = cs.kernel_device_ms(lambda: k2.flash_attention_fwd(q, k, v, None, None, 1.0),
                                 ("flash_fwd",), reps=10)["flash_fwd"]
        results.setdefault(f"fwd ({b}, {t}, 20)", {}).setdefault(name, []).append(ms)
        del q, k, v
    for b, t in BWD_SHAPES:
        q, k, v = cs.whisper_qkv(b, t, torch.float32, 800 + b + t)
        dout = torch.randn_like(q)
        out, lse = k2.flash_attention_fwd(q, k, v, None, None, 1.0, return_lse=True)
        ms = cs.kernel_device_ms(
            lambda: k2.flash_attention_bwd(q, k, v, None, None, 1.0, out, lse, dout),
            ("flash_bwd_dkv",), reps=10)["flash_bwd_dkv"]
        results.setdefault(f"dkv ({b}, {t}, 20)", {}).setdefault(name, []).append(ms)
        del q, k, v, dout, out, lse
    torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        print("perf_k2_f32_ablate: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    names = ["design", "cvt_split", "no_split", "one_pass", "no_wgmma"]
    with ThreadPoolExecutor(len(names)) as pool:  # the nvcc runs in parallel
        libs = dict(zip(names, pool.map(build, names)))
    results = {}
    for name in names + ["design"]:  # the design first and last
        use(libs[name])
        time_variant(results, name)
    report = {"device": smi, "ms": results, "variants": __doc__}
    for shape, by in results.items():
        print(f"[ablate] {shape}: " + ", ".join(
            f"{n} {' / '.join(f'{x:.4f}' for x in ms)} ms" for n, ms in by.items()))
    print(f"[ablate] {smi}")
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / "k2_f32_ablate.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
