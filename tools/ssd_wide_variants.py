#!/usr/bin/env python3
"""Time variants of the wide SSD-scan kernel (`csrc/ssd_scan_wide.cu`)
against the kernel as it is, at xlstm-1.3b's prefill shape on an NVIDIA
GPU, to see where its time goes and what its design choices bought:

    python3 tools/ssd_wide_variants.py [NAME ...]

Each variant is a copy of the kernel's source with one text edit
(`VARIANTS`), built with the kernel's own nvcc flags into
`kernels/_build/variants/` (removed afterwards), all builds started
together. Two kinds:

  * other choices, to compare with the present design: the states'
    entering-state stores as scattered 4-byte stores from the
    accumulators, the outputs at 64-column tiles, the scores' copies issued
    before their MMAs in a 4-deep ring, a 3-deep ring for the states (the
    outputs' 2-deep ring of 80 KB stages has no room for a third);
  * ablations, which drop one part of one phase (its copies after the
    first, its MMAs, its stores) and so give wrong results on purpose:
    what a phase costs without that part bounds what the part costs.

Per variant, the memory call (`ssd_scan_wide_cuda`, dv = 512) and the pair
(`mlstm_scan_cuda`) at B = 4, S = 8192, H = 4, dk = 512, chunk 256, bf16,
forget bias 6, in ms (CUDA events), each launch's device ms
(torch.profiler), and the largest error of the pair's y, C, nm and n
against the plain version. The variants run in order and then in reverse
order (A B ... B A). Prints the card's name and power limit first and one
line per run. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

_STAGED = '''      if (c > 0) {         // S_in[c], hi and lo, 64 columns a pass'''
_SCATTERED = '''      if (c > 0) {
#pragma unroll
        for (int e = 0; e < BN / 2; e += 2) {
          const int d = d0 + 16 * warp + g + 8 * ((e >> 1) & 1);
          const int j = j0 + 8 * (e >> 2) + 2 * tq;
          uint32_t hi, lo;
          split2(acc[e], acc[e + 1], hi, lo);
          const long long o = (rc * a.dkp + d) * a.dvp + j;
          *reinterpret_cast<uint32_t*>(a.s_hi + o) = hi;
          *reinterpret_cast<uint32_t*>(a.s_lo + o) = lo;
        }
      }
      if (c < 0) {'''
_SC_COPIES = ('''    if (i + kScoresStages - 1 < steps) load(i + kScoresStages - 1);
    cp_async_commit();
''')
_SC_MMA_END = '''                   sw128_desc(kb + kk * 32, 16, 1024), p > 0 || kk > 0);
    wgmma_commit();
'''
_SC_EARLY = '''    __syncthreads();       // panels i landed; panels i - 1's stage is free
'''

# name -> list of (text in the source, its replacement); each text must
# occur once
VARIANTS = {
    "states:scattered-stores": [(_STAGED, _SCATTERED)],
    "outputs:64-wide": [
        ("  return launch_smem(wide_outputs<BN>,",
         "  return launch_smem(wide_outputs<64>,"),
        ("((a.dv + BN - 1) / BN), kOutThreads,\n                     "
         "OutTile<BN>::SMEM",
         "((a.dv + 63) / 64), kOutThreads,\n                     "
         "OutTile<64>::SMEM")],
    "scores:copies-first-4-deep": [
        (_SC_MMA_END + "    // the next panels' copies go out while the MMAs "
         "run\n" + _SC_COPIES, _SC_MMA_END),
        (_SC_EARLY, _SC_EARLY + _SC_COPIES),
        ("constexpr int kScoresStages = 3;",
         "constexpr int kScoresStages = 4;")],
    "states:3-deep": [("constexpr int kStatesStages = 2;",
                       "constexpr int kStatesStages = 3;")],
    "states:no-copies": [
        ("    if (i + kStatesStages - 1 < steps) load(",
         "    if (i + kStatesStages - 1 < steps && i < 0) load(")],
    "states:no-mma": [
        ("      mma_rs<BN>(acc, ah[kk], db);\n      mma_rs<BN>(acc, al[kk], "
         "db);",
         "      if (c < 0) {\n        mma_rs<BN>(acc, ah[kk], db);\n        "
         "mma_rs<BN>(acc, al[kk], db);\n      }")],
    "states:no-stores": [(_STAGED, "      if (c < 0) {")],
    "scores:no-copies": [
        ("    if (i + kScoresStages - 1 < steps) load(",
         "    if (i + kScoresStages - 1 < steps && i < 0) load(")],
    "scores:no-stores": [
        ("    if (p == P - 1) {      // G for",
         "    if (p == P - 1 && i < 0) {      // G for")],
    "outputs:no-copies": [
        ("    if (i + kOutStages - 1 < steps) load(",
         "    if (i + kOutStages - 1 < steps && i < 0) load(")],
    "outputs:no-mma": [
        ("    if (!active) continue;", "    if (active || !active) continue;")],
    "outputs:no-stores": [
        ("    if (t >= C || pos >= S || j >= a.dv) continue;",
         "    if (t >= C || pos >= S || j >= a.dv || t >= 0) continue;")],
}


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"the text to edit is not in the source once: "
                               f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_all(names):
    """{name: loaded ssd_scan_wide_fwd} for the kernel as it is (None) and
    each named variant, built in parallel."""
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_scan_wide as SSDW
    src = (build.CSRC / "ssd_scan_wide.cu").read_text()
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, name in enumerate(names):
        cu = out / f"v{i}.cu"
        cu.write_text(variant_source(src, VARIANTS[name]))
        so = out / f"libv{i}.so"
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.MODEL_NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), so)
    ref = SSDW._kernel_lib()
    fns = {None: ref}
    for name, (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        fn = ctypes.CDLL(str(so)).ssd_scan_wide_fwd
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
        fns[name] = fn
    return fns, out


def run(fns, names, dev):
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ssd_scan_wide as SSDW
    b, s, h, d, chunk = cs.SERVE_B, cs.SERVE_S, cs.XLSTM_H, cs.XLSTM_D, 256
    args = cs.mlstm_scan_inputs(dev, 7, b, s, h, d, d, cs.SLOW_FORGET_BIAS)
    ref = SSDW.mlstm_scan_plain(*args, chunk=chunk)
    real = SSDW._kernel_lib
    order = [None, *names]
    try:
        for name in order + order[::-1]:
            SSDW._kernel_lib = lambda fn=fns[name]: fn
            got = SSDW.mlstm_scan_cuda(*args, chunk=chunk)
            torch.cuda.synchronize()
            errs = [float((x.float() - r.float()).abs().max())
                    for x, r in zip(got, ref)]
            del got
            memory = cs.cuda_ms(lambda: SSDW.ssd_scan_wide_cuda(
                *args, chunk=chunk), iters=10, warmup=2)
            pair = cs.cuda_ms(lambda: SSDW.mlstm_scan_cuda(
                *args, chunk=chunk), iters=10, warmup=2)
            top = cs.device_busy(lambda: SSDW.mlstm_scan_cuda(
                *args, chunk=chunk), cpu=False)["top"]
            phases = {p: round(sum(t["device_s"] * 1e3 for t in top
                                   if f"wide_{p}" in t["kernel"]), 4)
                      for p in cs.WIDE_PHASES}
            print(f"{name or 'as it is':28s} memory {memory:.4f} ms, pair "
                  f"{pair:.4f} ms, pair's launches (ms) {phases}, pair's "
                  f"errors (y, C, nm, n) {[float(f'{e:.3g}') for e in errs]}",
                  flush=True)
    finally:
        SSDW._kernel_lib = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*", metavar="NAME",
                    help=f"variants to run (default: all): {sorted(VARIANTS)}")
    names = ap.parse_args(argv).names or list(VARIANTS)
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        ap.error(f"unknown variants {unknown}")
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    fns, out = build_all(names)
    try:
        for name, fn in fns.items():
            if name is not None:
                print(f"built {name}")
        run(fns, names, torch.device("cuda"))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
