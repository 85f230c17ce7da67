"""End-to-end training on the PyTorch port: the steps of `train_lm.py`
(a ~100M-param qwen-family model, a few hundred steps, checkpoints, resume
and fault injection) through `repro_torch.launch.train.train`, whose
recovery loop restores the latest checkpoint and replays after the
injected failure.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]
          [--params 100] [--device cpu]
(~100M params is the default; use --params 20 for a faster demo. cuda is
the default device, which raises without a card.)
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.launch.train import train
from repro_torch.models.model import count_params
from repro_torch.train.optimizer import OptimizerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--params", type=int, default=100, help="target M params")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--inject-failure-at", type=int, default=-1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # scale a qwen2.5-family config down to ~args.params M parameters
    base = get_arch("qwen2.5-3b")
    if args.params >= 100:
        cfg = base.with_(n_layers=8, d_model=512, n_heads=8, n_kv_heads=2,
                         head_dim=64, d_ff=2048, vocab_size=32000,
                         attn_chunk_q=128, attn_chunk_k=128)
    else:
        cfg = base.with_(n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
                         head_dim=64, d_ff=1024, vocab_size=8000,
                         attn_chunk_q=128, attn_chunk_k=128)
    print(f"model: {cfg.name}-scaled, {count_params(cfg) / 1e6:.1f}M params")

    opt = OptimizerConfig(lr=1e-3, warmup_steps=20, decay_steps=args.steps)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_torch_train_lm")
    failed = []

    def inject(step_fn):
        def run(state, batch):
            if state.step == args.inject_failure_at and not failed:
                failed.append(state.step)
                raise RuntimeError("injected failure (demo)")
            return step_fn(state, batch)
        return run

    out = train(cfg.name, config=cfg, smoke=False, steps=args.steps,
                batch=args.batch, seq=args.seq, ckpt_dir=ckpt_dir,
                ckpt_every=50, device=dev, opt=opt, step_wrapper=inject,
                resume=True)
    losses = [h["loss"] for h in out["history"]]
    if losses:
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        print(f"\nfirst-10 mean loss {first:.4f} -> last-10 mean {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'}); "
              f"{out['restarts']} restarts")
    print("final checkpoint at", ckpt_dir)


if __name__ == "__main__":
    main()
