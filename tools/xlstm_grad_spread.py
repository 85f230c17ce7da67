#!/usr/bin/env python3
"""Where the float32 spread of xlstm-1.3b's gradients comes from, on the
CPU at a reduced width:

    python3 tools/xlstm_grad_spread.py [--layers 8 16] [--d-model 512]
        [--head-dim 128] [--seq 1024] [--threads 4]

Builds xlstm-1.3b at `--d-model` / `--head-dim` (vocabulary 4096) and each
depth of `--layers` from a seeded initialisation, and takes one sequence's
gradients at float32 compute by several routes, each against the plain
scans' autograd at chunk 256 (`chip_smoke.group_rel_errs`, per leaf group;
worst and median printed):

  * chunk 64: the same recurrence, other float32 rounding in the scans;
  * the scans' backward in float64 (`mlstm_scan_bwd_plain` on float64
    copies, through `ops._MLSTMScan`) under their float32 forward;
  * the scans in float64 (forward and autograd), and those with the
    embedding scaled by (1 + 1e-7 N(0, 1)) entrywise: how far a change of
    rounding size moves the gradients when the scans' own arithmetic is
    exact to float32.

Imports nothing of JAX; runs no kernel.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[8, 16])
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan_bwd as SB
    from repro_torch.kernels import ssd_scan_wide as SSDW
    from repro_torch.models import linear_scan as LS
    from repro_torch.models.model import Model
    from repro_torch.train.data import DataConfig, batch_for_step
    from repro_torch.train.train_step import compute_copy, loss_and_grads
    torch.set_num_threads(args.threads)
    dev = torch.device("cpu")

    def pair_fwd(*a, **kw):
        with torch.no_grad():
            return SSDW.mlstm_scan_plain(*a, **kw)

    def pair_bwd_f64(*a, **kw):
        a = [None if t is None else t.double() for t in a]
        return tuple(g.float() for g in SB.mlstm_scan_bwd_plain(*a, **kw))

    def grads(model, p, mb, chunk=256, scan_dtype=torch.float32,
              function=False):
        """The gradients with the plain scans' arithmetic in `scan_dtype`,
        or through `ops._MLSTMScan` with a float64 backward."""
        real = ops._on_card, SSDW.mlstm_scan_cuda, SB.mlstm_scan_bwd_cuda
        LS.f32 = scan_dtype
        if function:
            ops._on_card = lambda x: True
            SSDW.mlstm_scan_cuda, SB.mlstm_scan_bwd_cuda = pair_fwd, \
                pair_bwd_f64
        model.cfg = model.cfg.with_(ssm_chunk=chunk)
        try:
            return loss_and_grads(model, p, mb)[2]
        finally:
            LS.f32 = torch.float32
            ops._on_card, SSDW.mlstm_scan_cuda, SB.mlstm_scan_bwd_cuda = real

    def show(tag, g, ref):
        rel = cs.group_rel_errs(g, ref)
        w = sorted(rel.values(), reverse=True)
        worst = max(rel, key=rel.get)
        print(f"  {tag}: worst {w[0]:.2e} ({worst}), median "
              f"{w[len(w) // 2]:.2e}", flush=True)

    for n_layers in args.layers:
        cfg = get_arch("xlstm-1.3b").with_(
            n_layers=n_layers, d_model=args.d_model, head_dim=args.head_dim,
            vocab_size=4096, dtype="float32")
        model = Model(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(0))
        p = compute_copy(dict(model.named_parameters()), torch.float32)
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                        global_batch=1)
        mb = {k: torch.from_numpy(v) for k, v in batch_for_step(dc, 0).items()}
        ref = grads(model, p, mb)
        gn = sum(float(g.square().sum()) for g in ref.values()) ** 0.5
        print(f"xlstm-1.3b at d_model {args.d_model}, head_dim "
              f"{args.head_dim}, {n_layers} blocks, 1 x {args.seq} tokens, "
              f"float32; gradient norm {gn:.1f}; against the plain scans at "
              f"chunk 256:", flush=True)
        show("plain scans, chunk 64", grads(model, p, mb, chunk=64), ref)
        show("the scans' backward in float64", grads(model, p, mb,
                                                     function=True), ref)
        ref64 = grads(model, p, mb, scan_dtype=torch.float64)
        show("scans in float64, chunk 256", ref64, ref)
        g = torch.Generator().manual_seed(1)
        q = dict(p)
        q["embed"] = (p["embed"].detach() * (1 + 1e-7 * torch.randn(
            p["embed"].shape, generator=g))).requires_grad_()
        show("scans in float64, the embedding scaled by 1 + 1e-7 N(0, 1), "
             "against the same unscaled",
             grads(model, q, mb, scan_dtype=torch.float64), ref64)
    return 0


if __name__ == "__main__":
    sys.exit(main())
