#!/usr/bin/env python3
"""Time variants of the flash-attention backward kernel
(`csrc/flash_attention_bwd.cu`) against the kernel as it is, at
chip_smoke.py's BWD_SHAPES on an NVIDIA GPU, to see what its design
choices buy, and what bounds its registers:

    python3 tools/flash_bwd_variants.py [NAME ...] [--shapes 0 1 2 3]

Each variant is a copy of the kernel's source with text edits
(`VARIANTS`), built with the kernel's own nvcc flags into
`kernels/_build/variants/` (removed afterwards), all builds started
together; `SPLITS` variants run the kernel as it is with another split of
the query heads (the wrapper's launch helper, `flash_attention._bwd_launch`,
given a `bwd_plan` with that split). Per variant and
shape: the call's ms (CUDA events), each launch's device ms
(torch.profiler), the largest error of dq, dk, dv against the plain
version (chip_smoke.py's `grad_err`, limit BWD_TOL) and ptxas's registers,
spills and C7512 warnings for the dK / dV and dQ kernels (`COMPILE_ONLY`
variants report these alone). The variants run in order and then in
reverse order (A B ... B A). Prints the card's name
and power limit first and one line per run. Imports nothing of JAX.
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

# The dK / dV step of the earlier order: S^T; P^T; dP^T with dV in one
# group; dS^T; dK (three waits a step; ~234 registers).
_STEP = '''        // S^T = K Q^T
        float sc[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < T::KSTEPS; ++kk) {
          const uint32_t off = (kk / 4) * T::K_PANEL + (kk % 4) * 32;
          const uint32_t qoff = (kk / 4) * T::Q_PANEL + (kk % 4) * 32;
          wgmma_ss_n64(sc, sw128_desc(ka + off, 16, 1024),
                       sw128_desc(sq(s) + qoff, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sc);'''
_STEP_P_END = '''        uint32_t pa[4][4];
        pack_a<64>(sc, pa);
        // dP^T = V dO^T and dV += P^T dO in one group
        float dp[32];
        fence_regs(dv);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < T::KSTEPS; ++kk) {
          const uint32_t off = (kk / 4) * T::K_PANEL + (kk % 4) * 32;
          const uint32_t qoff = (kk / 4) * T::Q_PANEL + (kk % 4) * 32;
          wgmma_ss_n64(dp, sw128_desc(va + off, 16, 1024),
                       sw128_desc(sdo(s) + qoff, 16, 1024), kk > 0);
        }
#pragma unroll
        for (int j = 0; j < kSQ / 16; ++j)
          wgmma_rs<DHP>(dv, pa[j],
                        sw128_desc(sdo(s) + j * 16 * 128, T::Q_PANEL, 1024));
        wgmma_commit();
        wgmma_wait0();
        fence_regs(dp);
        fence_regs(dv);'''
_STEP_DS = '''          dp[e] = sc[e] * (dp[e] - ((e & 1) ? x.w : x.y));
        }
        uint32_t da[4][4];
        pack_a<64>(dp, da);
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kSQ / 16; ++j)
          wgmma_rs<DHP>(dk, da[j],
                        sw128_desc(sq(s) + j * 16 * 128, T::Q_PANEL, 1024));
        wgmma_commit();
        wgmma_wait0();
        fence_regs(dk);'''
# The order as it is: S^T and dP^T in one group, P^T and dS^T, dV and dK
# in one group (two waits a step); the variant edits it back.
_TWO_GROUPS = [
    (_STEP, '''        float sc[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < T::KSTEPS; ++kk) {
          const uint32_t off = (kk / 4) * T::K_PANEL + (kk % 4) * 32;
          const uint32_t qoff = (kk / 4) * T::Q_PANEL + (kk % 4) * 32;
          wgmma_ss_n64(sc, sw128_desc(ka + off, 16, 1024),
                       sw128_desc(sq(s) + qoff, 16, 1024), kk > 0);
          wgmma_ss_n64(dp, sw128_desc(va + off, 16, 1024),
                       sw128_desc(sdo(s) + qoff, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sc);
        fence_regs(dp);'''),
    (_STEP_P_END, '''        uint32_t pa[4][4];
        pack_a<64>(sc, pa);'''),
    (_STEP_DS, '''          dp[e] = sc[e] * (dp[e] - ((e & 1) ? x.w : x.y));
        }
        uint32_t da[4][4];
        pack_a<64>(dp, da);
        fence_regs(dk);
        fence_regs(dv);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kSQ / 16; ++j) {
          wgmma_rs<DHP>(dv, pa[j],
                        sw128_desc(sdo(s) + j * 16 * 128, T::Q_PANEL, 1024));
          wgmma_rs<DHP>(dk, da[j],
                        sw128_desc(sq(s) + j * 16 * 128, T::Q_PANEL, 1024));
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(dk);
        fence_regs(dv);''')]


def _ring(stages: int, ahead: int):
    return [("constexpr int kStagesKV = 4;", f"constexpr int kStagesKV = "
             f"{stages};"),
            ("constexpr int kAheadKV = 2;", f"constexpr int kAheadKV = "
             f"{ahead};")]


# The dK / dV kernel compiled for up to 384 threads (it still launches
# 256): ptxas caps it at 168 registers a thread, and it spills; with every
# warp running setmaxnreg.inc 240 at kernel entry, ptxas compiles it
# within 240.
_BOUNDS_384 = [("__launch_bounds__(kDkdvThreads, 1)\n    bwd_dkdv(",
                "__launch_bounds__(384, 1)\n    bwd_dkdv(")]
_SETMAXNREG_240 = [("  using T = KvTile<DH>;\n",
                    "  using T = KvTile<DH>;\n  asm volatile(\"setmaxnreg.inc."
                    "sync.aligned.u32 240;\\n\" ::: \"memory\");\n")]

# name -> list of (text in the source, its replacement); each text must
# occur once
VARIANTS = {
    "dkdv:bounds-384": _BOUNDS_384,
    "dkdv:bounds-384-setmaxnreg-240": _BOUNDS_384 + _SETMAXNREG_240,
    "dkdv:three-groups": [(new, old) for old, new in _TWO_GROUPS],
    "dkdv:ring-3-ahead-1": _ring(3, 1),
    "dkdv:ring-4-ahead-3": _ring(4, 3),
    "dkdv:ring-2-ahead-1": _ring(2, 1),
    "dq:ring-2": [("constexpr int kStagesQ = 3;",
                   "constexpr int kStagesQ = 2;")],
}
# variants built for their ptxas report only: a setmaxnreg.inc that found
# no registers free would wait, not trap
COMPILE_ONLY = {"dkdv:bounds-384-setmaxnreg-240"}
# name -> the split of the query heads the kernel as it is runs with
SPLITS = {"splits:1": 1, "splits:2": 2, "splits:4": 4, "splits:8": 8}


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"the text to edit is not in the source once: "
                               f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_all(names):
    """{name: (loaded flash_attention_bwd, ptxas log)} for the kernel as it
    is (None) and each named source variant, built in parallel."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, name in enumerate(n for n in names if n in VARIANTS):
        cu = out / f"bwd{i}.cu"
        cu.write_text(variant_source(src, VARIANTS[name]))
        so = out / f"libbwd{i}.so"
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.MODEL_NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), so)
    ref = FA._bwd_kernel_lib()
    fns = {None: (ref, build.build_log["flash_attention_bwd"]["ptxas"])}
    for name, (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        fn = ctypes.CDLL(str(so)).flash_attention_bwd
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
        fns[name] = (fn, err)
    for name in names:
        if name in SPLITS:
            fns[name] = fns[None]
    return fns, out


def ptxas_summary(log: str, dh: int) -> dict:
    import chip_smoke as cs
    out = {kind: (st.get("registers"), st.get("spill_stores"))
           for name, st in cs.ptxas_kernel_stats(log).items()
           for kind in ("dkdv", "dq")
           if f"bwd_{kind}I" in name and f"ILi{dh}E" in name}
    out["C7512"] = sum(f"bwd_{k}ILi{dh}E" in line for line in log.splitlines()
                       if "C7512" in line for k in ("dkdv", "dq"))
    return out


def run(fns, names, shapes, dev):
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as FA
    real = FA._bwd_kernel_lib
    for name in names:
        if name in COMPILE_ONLY:
            report = {dh: ptxas_summary(fns[name][1], dh) for dh in (64, 128)}
            print(f"{name}: built, not run; ptxas at dh 64 and 128 {report}")
    order = [None, *(n for n in names if n not in COMPILE_ONLY)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    try:
        for i in shapes:
            b, s, h, kv, dh, win = cs.BWD_SHAPES[i]
            q, k, v = cs._attn_inputs(dev, 500 + i, b, s, h, kv, dh)
            g = torch.Generator(device=dev).manual_seed(501 + i)
            do = torch.randn((b, s, h, dh), dtype=torch.bfloat16, device=dev,
                             generator=g)
            o, lse = FA.flash_attention_cuda(q, k, v, window=win,
                                             return_lse=True)
            args = (q, k, v, o, lse, do)
            plain = FA.flash_attention_bwd_plain(
                *(t.float() for t in (q, k, v, o)), lse, do.float(),
                window=win)
            for name in order + order[::-1]:
                fn, log = fns[name]
                FA._bwd_kernel_lib = lambda fn=fn: fn
                splits = SPLITS.get(name)
                if splits is not None and (h // kv) % splits:
                    continue            # not a split of this group

                plan = FA.bwd_plan(b, s, s, h, kv, dh, sms=sms,
                                   splits=splits)

                def call():
                    return FA._bwd_launch(*args, plan, True, win)[:3]
                got = call()
                torch.cuda.synchronize()
                err = max(cs.grad_err(x, z) for x, z in zip(got, plain))
                del got
                ms = cs.cuda_ms(call, iters=10, warmup=2)
                top = cs.device_busy(call, cpu=False)["top"]
                launches = {p: round(sum(t["device_s"] * 1e3 for t in top
                                         if f"bwd_{p}" in t["kernel"]), 4)
                            for p in cs.BWD_LAUNCHES}
                print(f"{cs.BWD_SHAPES[i]} {name or 'as it is':22s} "
                      f"{ms:.4f} ms, launches (ms) {launches}, err "
                      f"{err:.3g} (limit {cs.BWD_TOL}), ptxas "
                      f"{ptxas_summary(log, dh)}", flush=True)
            del q, k, v, o, lse, do, plain, args
            torch.cuda.empty_cache()
    finally:
        FA._bwd_kernel_lib = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*", metavar="NAME",
                    help=f"variants to run (default: all): "
                         f"{sorted(VARIANTS) + sorted(SPLITS)}")
    ap.add_argument("--shapes", nargs="+", type=int, default=[0, 1, 2, 3],
                    help="indices into chip_smoke.BWD_SHAPES")
    args = ap.parse_args(argv)
    names = args.names or [*VARIANTS, *SPLITS]
    unknown = sorted(set(names) - set(VARIANTS) - set(SPLITS))
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
        run(fns, names, args.shapes, torch.device("cuda"))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
