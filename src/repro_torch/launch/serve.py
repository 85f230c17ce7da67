"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Batched prefill + greedy decode with the ServeEngine on the reduced
(`smoke_config`) model of an architecture, with random weights from a seed;
optionally schedules a mixed request stream across two pools with the
paper's CAB policy against LB (--heterogeneous). Runs on the card unless
`--device cpu` is given. The open-trace replay (--traffic) is not ported
yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch, smoke_config
from repro_torch.models.model import Model
from repro_torch.serve.engine import ServeEngine, request_service_fns


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--heterogeneous", action="store_true",
                    help="CAB-schedule a prefill/decode mix over two pools")
    ap.add_argument("--traffic", action="store_true",
                    help="replay an open request trace (not yet ported)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.traffic:
        raise NotImplementedError("--traffic (open-trace replay through "
                                  "GrIn-P and admission control) is not "
                                  "yet ported")

    dev = resolve_device(args.device)
    cfg = smoke_config(get_arch(args.arch))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = Model(cfg, device=dev).init(gen)
    engine = ServeEngine(model, max_len=args.prompt_len + args.steps + 8)

    tgen = torch.Generator().manual_seed(args.seed + 1)
    toks = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                         generator=tgen).to(dev)
    batch = {"tokens": toks}

    t0 = time.perf_counter()
    out = engine.generate(batch, steps=args.steps)
    engine.synchronize()
    dt = time.perf_counter() - t0
    n_tok = out.numel()
    print(f"[serve] {cfg.name} on {dev}: generated {tuple(out.shape)} tokens "
          f"in {dt:.2f}s ({n_tok / dt:.1f} tok/s incl. kernel builds)")
    print("[serve] sample:", out[0].tolist()[:16])

    if args.heterogeneous:
        from repro_torch.core import classify_2x2
        from repro_torch.sched import SchedulerCore, get_policy
        from repro_torch.sched.virtual import VirtualTimeCluster

        fns = request_service_fns(engine, batch, toks)
        vc = VirtualTimeCluster(fns)
        mu = vc.measure_rates(2, reps=3)
        print(f"[serve] measured mu:\n{np.round(mu, 2)} "
              f"({classify_2x2(mu).value})")
        types = [0] * 4 + [1] * 4
        for name in ("cab", "lb"):
            sched = SchedulerCore(get_policy(name), mu, device=dev)
            m = VirtualTimeCluster(fns).run_closed(
                sched, types, n_completions=60, warmup=10)
            print(f"[serve] {sched.name}: X={m.throughput:.2f} req/s")


if __name__ == "__main__":
    main()
