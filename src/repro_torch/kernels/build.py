"""Build the hand-written CUDA kernels at first use and load them by ctypes.

Each kernel source under `csrc/` exposes a plain C entry point, so `nvcc`
compiles it in seconds without PyTorch's headers. The shared library lands
in `_build/` beside this file (listed in .gitignore), named by a hash of its
sources and flags, so an edited source never loads a stale build. A failed
build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# sm_90a: Hopper. No --use_fast_math. --fmad=false keeps every product and
# sum rounded on its own, as the plain PyTorch versions round them, so a
# kernel's gains differ from its plain version only by summation order.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")
# The model kernels (attention, SSD scan, RMSNorm) are held to tolerances,
# not to the plain version's rounding, so they keep fused multiply-adds.
MODEL_NVCC_FLAGS = tuple(f for f in NVCC_FLAGS if f != "--fmad=false")

_LIBS: dict[str, ctypes.CDLL] = {}
build_log: dict[str, dict] = {}     # name -> {"seconds", "cached", "ptxas"}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built from source at first use")
    return found


def _library_path(name: str, sources: tuple[str, ...],
                  flags: tuple[str, ...]) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update((CSRC / src).read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def start_build(name: str, sources: tuple[str, ...],
                flags: tuple[str, ...] = NVCC_FLAGS):
    """Start `nvcc` for one library in the background; returns a handle for
    `finish_build`, or None when the library is already built (its ptxas
    report, left beside it, then goes into `build_log`)."""
    so = _library_path(name, sources, flags)
    if so.exists():
        log = so.with_suffix(".ptxas.txt")
        build_log.setdefault(name, {
            "seconds": 0.0, "cached": True,
            "ptxas": log.read_text() if log.exists() else ""})
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *flags, "-o", str(tmp),
           *(str(CSRC / s) for s in sources)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, so, time.perf_counter()


def finish_build(name: str, handle) -> None:
    if handle is None:              # built before
        return
    proc, tmp, so, t0 = handle
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (exit "
                           f"{proc.returncode}):\n{out}{err}")
    so.with_suffix(".ptxas.txt").write_text(err)
    os.replace(tmp, so)             # atomic: concurrent builds agree
    build_log[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                       "ptxas": err}


def load_library(name: str, sources: tuple[str, ...],
                 flags: tuple[str, ...] = NVCC_FLAGS) -> ctypes.CDLL:
    """The loaded library for `name`, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        finish_build(name, start_build(name, sources, flags))
        lib = ctypes.CDLL(str(_library_path(name, sources, flags)))
        _LIBS[name] = lib
    return lib
