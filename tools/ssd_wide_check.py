#!/usr/bin/env python3
"""Check and time the wide SSD-scan kernel (`csrc/ssd_scan_wide.cu`) at
xlstm-1.3b's prefill shape on an NVIDIA GPU, or show that its check
catches a fault planted in a copy of the kernel:

    python3 tools/ssd_wide_check.py                 # the kernel as it is
    python3 tools/ssd_wide_check.py --plant carry lt

Both run `chip_smoke.py`'s own wide-kernel check (`measure_wide_ssd`):
B = 4, S = 8192, H = 4, dk = 512, chunk 256, bf16, the scan alone at dv =
512 (the memory) and dv = 1 (the normaliser, v = ones), and the pair
(`mlstm_scan_cuda`, both in one call), against the plain version at fast
and slow forget-gate decay, and at a ragged shape; then the kernel's and
the plain version's ms and each of its launches' device ms.

`--plant` builds, for each fault named, a copy of the kernel's source with
that fault in its carry over chunks (the states phase, where the
accumulators are scaled at each chunk's start), into
`kernels/_build/planted/` (removed afterwards), and runs the same check on
it:

  * carry — the state entering a chunk dropped from the carry (scaled by 0:
    the next chunk's entering state is this chunk's own contribution);
  * lt    — the previous chunk's total decay applied in place of this one's.

Prints the card's name and power limit, then per shape and fault the
errors, the verdicts and the faults the check reports. Exits 1 if the
kernel as it is fails its check, or if the check passes a planted fault.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CARRY = "const float carry = expf(LT[c]);"
PLANTS = {"carry": (CARRY, "const float carry = 0.f;"),
          "lt": (CARRY, "const float carry = expf(LT[c > 0 ? c - 1 : 0]);")}


@contextlib.contextmanager
def planted(fault: str):
    """The wide kernel's wrapper launching a copy of its source with
    `fault` planted, for the time of the block."""
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_scan_wide as SSDW
    old, new = PLANTS[fault]
    src = (build.CSRC / "ssd_scan_wide.cu").read_text()
    if src.count(old) != 1:
        raise RuntimeError(f"the carry line to plant {fault!r} in is not "
                           f"in the source once: {old!r}")
    out = build.BUILD_DIR / "planted"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"ssd_scan_wide_{fault}.cu"
    so = out / f"libssd_scan_wide_{fault}.so"
    cu.write_text(src.replace(old, new))
    real = SSDW._kernel_lib
    try:
        subprocess.run([build.nvcc_path(), *build.MODEL_NVCC_FLAGS, "-I",
                        str(build.CSRC), "-o", str(so), str(cu)], check=True,
                       capture_output=True, text=True)
        fn = ctypes.CDLL(str(so)).ssd_scan_wide_fwd
        ref = real()
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
        SSDW._kernel_lib = lambda: fn
        yield
    finally:
        SSDW._kernel_lib = real
        shutil.rmtree(out, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--plant", nargs="*", default=[], choices=sorted(PLANTS))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    rc = 0
    for fault in [None, *args.plant]:
        ctx = planted(fault) if fault else contextlib.nullcontext()
        with ctx:
            for dv, pair in ((cs.XLSTM_D, False), (1, False),
                             (cs.XLSTM_D, True)):
                print(f"{fault or 'the kernel as it is'}, dv={dv}"
                      f"{' (the pair)' if pair else ''}:")
                row = cs.measure_wide_ssd(dev, dv, pair)
                cs.print_wide_ssd(row)
                faults = cs.wide_ssd_faults(row["checks"]) + \
                    cs.wide_ssd_faults(row["ragged_checks"])
                fast = [r["ok"] for c in (row["checks"], row["ragged_checks"])
                        for b, r in c.items() if b != cs.SLOW_FORGET_BIAS]
                print(f"  the check reports {faults or 'nothing'}; at fast "
                      f"decay alone it would pass: {all(fast)}")
                if bool(faults) != bool(fault):
                    rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
