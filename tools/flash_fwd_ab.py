#!/usr/bin/env python3
"""Compare the flash-attention forward kernel of another checkout (the
parent of a change, say) with this tree's on one NVIDIA GPU: its time in
alternating pairs of runs, and its SASS.

    python3 tools/flash_fwd_ab.py --parent OLD_CHECKOUT [--pairs 10]

Each run is one process of `tools/port_kernel_times.py --parts flash`
(the smoke's windowed B = 4 serving call and its causal B = 1 case, the
time between CUDA events and the kernel's device time under the profiler)
on one checkout; pair i runs the parent first when i is even and this tree first
when it is odd. Then it disassembles the forward kernels of both built
libraries (`cuobjdump -sass` on `libflash_attention-*.so` under each
checkout's `src/repro_torch/kernels/_build/`), with instruction addresses
and nvcc's per-file hashes taken out of the names, and counts the kernels
and the SASS lines that differ (kernels whose names still differ are
paired in the order cuobjdump lists them). Prints the card's name and power
limit, one line per run, and a JSON summary as its last line: each
metric's readings for both, their medians, and in how many pairs this
tree read slower. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
METRICS = ("flash_window_b4_ms", "flash_causal_b1_ms",
           "flash_window_b4_device_ms", "flash_causal_b1_device_ms")
# a per-file hash nvcc puts into the names of a file's internal functions
HASH = re.compile(r"(?<=_)[0-9a-f]{8}")


def run_times(root: Path) -> dict:
    out = subprocess.run(
        [sys.executable, str(HERE / "tools" / "port_kernel_times.py"),
         "--root", str(root), "--parts", "flash"],
        capture_output=True, text=True, check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def sass_by_kernel(root: Path) -> dict[str, list[str]]:
    """{kernel: normalised SASS lines} of the newest built forward library
    under `root`."""
    libs = sorted((root / "src" / "repro_torch" / "kernels" / "_build")
                  .glob("libflash_attention-*.so"),
                  key=lambda p: p.stat().st_mtime)
    if not libs:
        raise RuntimeError(f"no built forward library under {root}")
    cuobjdump = Path("/usr/local/cuda/bin/cuobjdump")
    text = subprocess.run(
        [str(cuobjdump) if cuobjdump.exists() else "cuobjdump", "-sass",
         str(libs[-1])], capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = HASH.sub("H", m.group(1))
            out[name] = []
        elif name is not None and "/*" in line:
            ins = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)
            ins = re.sub(r"/\*.*?\*/", "", ins).strip()
            if ins:
                out[name].append(HASH.sub("H", ins))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="the other checkout (its src/repro_torch is run)")
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    parent = Path(args.parent).resolve()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card.splitlines()[0], flush=True)
    roots = {"parent": parent, "tree": HERE}
    got = {who: {m: [] for m in METRICS} for who in roots}
    slower = {m: 0 for m in METRICS}
    for i in range(args.pairs):
        pair = {}
        for who in (("parent", "tree") if i % 2 == 0 else
                    ("tree", "parent")):
            res = run_times(roots[who])
            pair[who] = res
            for m in METRICS:
                got[who][m].append(res[m])
            print(f"pair {i} {who}: " + ", ".join(
                f"{m} {res[m]:.4f}" for m in METRICS), flush=True)
        for m in METRICS:
            slower[m] += pair["tree"][m] > pair["parent"][m]
    sass = {who: sass_by_kernel(root) for who, root in roots.items()}
    if set(sass["parent"]) == set(sass["tree"]):
        pairs = [(n, n) for n in sorted(sass["tree"])]
    else:
        pairs = list(zip(sass["parent"], sass["tree"]))
    differ = {t: sum(a != b for a, b in zip(sass["parent"][p],
                                            sass["tree"][t]))
              + abs(len(sass["parent"][p]) - len(sass["tree"][t]))
              for p, t in pairs}
    summary = {
        "card": card.splitlines()[0], "pairs": args.pairs,
        "readings": got,
        "median": {who: {m: statistics.median(v) for m, v in d.items()}
                   for who, d in got.items()},
        "pairs_tree_slower": slower,
        "sass": {"kernels": [len(sass["parent"]), len(sass["tree"])],
                 "names_matched": set(sass["parent"]) == set(sass["tree"]),
                 "names": [list(sass["parent"])[:2], list(sass["tree"])[:2]],
                 "kernels_differing": sum(v > 0 for v in differ.values()),
                 "lines": sum(len(v) for v in sass["tree"].values()),
                 "lines_differing": sum(differ.values())}}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
