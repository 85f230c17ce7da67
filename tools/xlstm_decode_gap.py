#!/usr/bin/env python3
"""Where xlstm-1.3b's decode-vs-forward gap comes from, on an NVIDIA GPU.

    python3 tools/xlstm_decode_gap.py [--seq 2048] [--batch 4] [--layers 48]

For the model at full width (random weights from seed 0, `--layers` cuts
its depth) in bfloat16 and in float32, with prompts of `--seq` random
tokens, it runs the model's forward over the whole prompt, and its prefill
over all but the last token followed by one decode step from the
resulting caches, each through `Model._run_stack` with every block traced.
After every block it prints the largest relative gap between the two
residual streams at the last token (max over requests of |x_forward -
x_decode| / |x_forward|), then the largest logit gap. Beside it, the same
forward with the plain SSD scan (`linear_scan_chunked`) in place of the
wide kernel, so the gap two summation orders of one function leave at the
logits is shown beside the decode-vs-forward gap. Prints the
card's name and power limit first. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


@contextlib.contextmanager
def tracing(trace: list):
    """Record the last token's residual stream after every mLSTM and sLSTM
    block that `Model._run_stack` applies, in `trace`, for the time of the
    block."""
    from repro_torch.models import model as M
    real = {kind: getattr(M, f"_apply_{kind}_block")
            for kind in ("mlstm", "slstm")}

    def traced(kind):
        def apply(*args, **kw):
            x, c = real[kind](*args, **kw)
            trace.append((kind, x[:, -1].float()))
            return x, c
        return apply
    for kind in real:
        setattr(M, f"_apply_{kind}_block", traced(kind))
    try:
        yield trace
    finally:
        for kind, fn in real.items():
            setattr(M, f"_apply_{kind}_block", fn)


def gaps(model, toks):
    import torch
    from repro_torch.kernels import ops
    with torch.no_grad():
        with tracing([]) as full_tr:
            full = model.forward({"tokens": toks})[:, -1]
        _, cache = model.prefill({"tokens": toks[:, :-1]})
        with tracing([]) as dec_tr:
            dec = model.decode_step(toks[:, -1:], cache,
                                    toks.shape[1] - 1)[0][:, -1]
        del cache
        real = ops.ssd_scan
        ops.ssd_scan = lambda *a, chunk=256: ops.linear_scan_chunked(
            *a, chunk=chunk)
        try:
            plain = model.forward({"tokens": toks})[:, -1]
        finally:
            ops.ssd_scan = real
    blocks = [(kind, float(((a - b).norm(dim=-1) / a.norm(dim=-1)).max()))
              for (kind, a), (_, b) in zip(full_tr, dec_tr)]
    return {"blocks": blocks,
            "decode_vs_forward": [float(v) for v in
                                  (dec - full).abs().amax(-1)],
            "plain_vs_kernel_forward": [float(v) for v in
                                        (plain - full).abs().amax(-1)],
            "logit_rms": float(full.square().mean().sqrt())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--layers", type=int, default=48)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    for dtype in ("bfloat16", "float32"):
        cfg = get_arch("xlstm-1.3b").with_(n_layers=args.layers, dtype=dtype)
        model = Model(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(0))
        if dtype == "bfloat16":
            model = model.to(torch.bfloat16)     # the serving copy
        toks = torch.randint(0, cfg.vocab_size, (args.batch, args.seq),
                             device=dev, generator=torch.Generator(
                                 device=dev).manual_seed(1))
        r = gaps(model, toks)
        print(f"{dtype}: logit rms {r['logit_rms']:.3f}; decode vs forward "
              f"{[round(v, 4) for v in r['decode_vs_forward']]}; plain-SSD "
              f"vs kernel forward "
              f"{[round(v, 4) for v in r['plain_vs_kernel_forward']]}")
        print("  residual gap after each block: " + " ".join(
            f"{k[0]}{v:.1e}" for k, v in r["blocks"]))
        del model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
