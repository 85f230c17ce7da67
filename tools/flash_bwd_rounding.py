#!/usr/bin/env python3
"""Where the flash backward kernel's error against its plain version comes
from, on an NVIDIA GPU:

    python3 tools/flash_bwd_rounding.py [--shapes qwen ragged]

For each shape (`chip_smoke.BWD_SHAPES`' qwen2.5-3b training microbatch
and ragged S = 1500 cases, on the smoke's inputs) it computes dq, dk, dv
three ways: the kernel, the plain float32 backward, and the plain backward
with P and dS rounded to bf16 before the products that take them (what
the kernel's bf16 mma operands do). For each pair it prints the smoke's
metric, max |d| / (rms of the reference tensor + |reference|), with the
entry and the positions where the error is largest. When the kernel
sits as far from the float32 version as the bf16-rounded plain one does,
the error is that rounding, not a fault. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SHAPES = {"qwen": 0, "zamba2": 1, "ragged": 2, "gqa3": 3}


def rounded_plain(q, k, v, o, lse, do, window=0, chunk=1024):
    """`flash_attention_bwd_plain` with P and dS rounded to bf16 as the
    operands of dV += P^T dO, dK += dS^T Q and dQ += dS K."""
    import torch
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1 / math.sqrt(dh)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    delta = (dof * o.float()).sum(-1)
    lsef = lse.float().transpose(1, 2)
    dq = torch.zeros((b, sq, h, dh), device=q.device)
    dk = torch.zeros((b, sk, kv, dh), device=q.device)
    dv = torch.zeros_like(dk)

    def r16(t):
        return t.bfloat16().float()
    for i0 in range(0, sq, chunk):
        r = min(chunk, sq - i0)
        qc = qf[:, i0:i0 + r].reshape(b, r, kv, g, dh)
        doc = dof[:, i0:i0 + r].reshape(b, r, kv, g, dh)
        dc = delta[:, i0:i0 + r].reshape(b, r, kv, g, 1)
        lc = lsef[:, i0:i0 + r].reshape(b, r, kv, g, 1)
        qpos = torch.arange(i0, i0 + r, device=q.device)
        for j0 in range(0, sk, chunk):
            t = min(chunk, sk - j0)
            kpos = torch.arange(j0, j0 + t, device=q.device)
            mask = kpos[None] <= qpos[:, None]
            if window:
                mask &= kpos[None] > qpos[:, None] - window
            if not bool(mask.any()):
                continue
            kc, vc = kf[:, j0:j0 + t], vf[:, j0:j0 + t]
            s = torch.einsum("bcngd,btnd->bcngt", qc, kc) * scale
            p = torch.where(mask[None, :, None, None, :], torch.exp(s - lc),
                            0.0)
            dv[:, j0:j0 + t] += torch.einsum("bcngt,bcngd->btnd", r16(p), doc)
            dp = torch.einsum("bcngd,btnd->bcngt", doc, vc)
            ds = r16(p * (dp - dc))
            dq[:, i0:i0 + r] += torch.einsum(
                "bcngt,btnd->bcngd", ds, kc).reshape(b, r, h, dh)
            dk[:, j0:j0 + t] += torch.einsum("bcngt,bcngd->btnd", ds, qc)
    return dq * scale, dk * scale, dv


def describe(x, z) -> str:
    import numpy as np
    x, z = x.float(), z.float()
    d = (x - z).abs()
    rms = z.square().mean().sqrt()
    m = d / (rms + z.abs())
    i = int(m.argmax())
    idx = tuple(int(t) for t in np.unravel_index(i, z.shape))
    worst = d.amax(dim=(0, 2, 3)).topk(5).indices.tolist()
    return (f"metric {float(m.max()):.3e} at {idx} ({float(x.flatten()[i]):.5g}"
            f" vs {float(z.flatten()[i]):.5g}; rms {float(rms):.4g}), max |d|"
            f" {float(d.max()):.3g}, largest at positions {worst}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", nargs="+", choices=sorted(SHAPES),
                    default=["qwen", "ragged"])
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as FA
    if not torch.cuda.is_available():
        print("flash_bwd_rounding: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    for name in args.shapes:
        i = SHAPES[name]
        b, s, h, kv, dh, w = cs.BWD_SHAPES[i]
        q, k, v = cs._attn_inputs(dev, 500 + i, b, s, h, kv, dh)
        g = torch.Generator(device=dev).manual_seed(501 + i)
        do = torch.randn((b, s, h, dh), dtype=torch.bfloat16, device=dev,
                         generator=g)
        o, lse = FA.flash_attention_cuda(q, k, v, window=w, return_lse=True)
        got = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, window=w)
        f32 = FA.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                           o.float(), lse, do.float(),
                                           window=w)
        r16 = rounded_plain(q, k, v, o, lse, do, w)
        print(f"{name} (B, S, H, KV, dh, window) = {(b, s, h, kv, dh, w)}")
        for n, x, z, e in zip(("dq", "dk", "dv"), got, f32, r16):
            print(f"  {n} kernel vs float32 plain:      {describe(x, z)}")
            print(f"  {n} bf16-rounded plain vs float32: {describe(e, z)}")
            print(f"  {n} kernel vs bf16-rounded plain: {describe(x, e)}")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
