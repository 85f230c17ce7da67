"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Batched prefill + greedy decode with the ServeEngine on the reduced
(`smoke_config`) model of an architecture of any family: dense (yi-6b,
qwen2.5-3b/32b, granite-34b), moe (granite-moe-1b-a400m,
granite-moe-3b-a800m), audio (musicgen-medium: (B, K, S) prompts, one
token per codebook a step), vlm (phi-3-vision-4.2b: random image-patch
embeddings before the prompt), hybrid (zamba2-7b) or ssm (xlstm-1.3b),
with random weights and prompts from a seed;
optionally schedules a mixed request stream across two pools with the
paper's CAB policy against LB (--heterogeneous), or replays an open request
trace through GrIn-P placement plus SLO admission control (--traffic,
`serve_traffic`). Runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch, smoke_config
from repro_torch.models.model import Model
from repro_torch.serve.engine import ServeEngine, request_service_fns

_TRACE = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                      "examples", "data", "serve_trace.json")


def serve_traffic(engine, batch, toks, *, trace=None, load: float = 1.2,
                  trace_out=None, device=None):
    """Replay an open request trace on two virtual-time pools of `engine`.

    Measures the 2 x 2 mu of the prefill / decode request classes
    (`request_service_fns` on `VirtualTimeCluster`), scales the trace
    (default: the bundled examples/data/serve_trace.json) so the offered
    rate is `load` x the saturation knee of its class mix, and replays it
    through `GrInPriorityPolicy((2, 1))` plus an `AdmissionController`
    with a protected prefill SLO and a best-effort decode SLO. With
    `trace_out`, scheduler and admission decisions go to a Chrome trace
    there. Returns (OpenReplayMetrics, mu, trace events written or 0)."""
    from repro_torch.obs import TraceRecorder
    from repro_torch.sched import SchedulerCore
    from repro_torch.sched.priority import GrInPriorityPolicy
    from repro_torch.sched.virtual import VirtualTimeCluster
    from repro_torch.traffic import (AdmissionController, SLOClass,
                                     load_trace, replay_open)

    fns = request_service_fns(engine, batch, toks)
    vc = VirtualTimeCluster(fns)
    mu = vc.measure_rates(2, reps=3)
    print(f"[serve] measured mu:\n{np.round(mu, 2)}")
    # saturation knee given the trace's class mix: the load where the
    # busiest class fills its best pool; scale the trace so the offered
    # rate is `load` x that
    times, classes = load_trace(trace or os.path.normpath(_TRACE))
    trace_rate = len(times) / float(times[-1] - times[0])
    shares = np.bincount(classes, minlength=2) / len(classes)
    x_knee = 1.0 / max(shares[c] / mu[c].max() for c in range(2))
    times = times * (trace_rate / (load * x_knee))
    rec = TraceRecorder() if trace_out else None
    core = SchedulerCore(GrInPriorityPolicy((2.0, 1.0)), mu, recorder=rec,
                         device=device)
    # SLOs: protect the interactive prefill class at its own service plus
    # 1.5x a worst-case head-of-line decode block (pools are FCFS); the
    # decode class is best-effort
    slo = (SLOClass(deadline=1.5 / mu[1].min() + 6.0 / mu[0].max(),
                    percentile=0.9, protected=True),
           SLOClass(deadline=60.0 / mu[1].max(), percentile=0.9))
    adm = AdmissionController(core, slo, class_of_type=[0, 1],
                              queue_capacity=6, window=64, adapt_every=8)
    m = replay_open(vc, adm, times, classes, warmup=len(times) // 10)
    n_events = 0
    if rec is not None:
        n_events = rec.export(trace_out)
        print(f"[serve] wrote {n_events} trace events to {trace_out} "
            f"({rec.dropped} dropped)")
    print(f"[serve] GrIn-P + admission @ load {load:.2f}: "
        f"goodput {m.throughput:.2f} req/s")
    for c, name in enumerate(("prefill", "decode")):
        print(f"[serve]   class {c} ({name}): done "
            f"{int(m.class_completed[c])} shed {int(m.class_shed[c])} "
            f"p50 {m.class_p50[c]:.3f}s p99 {m.class_p99[c]:.3f}s "
            f"SLO-met {m.class_deadline_met[c]:.2f} "
            f"limit {m.limits[c]:.0f}")
    return m, mu, n_events


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--heterogeneous", action="store_true",
                    help="CAB-schedule a prefill/decode mix over two pools")
    ap.add_argument("--traffic", action="store_true",
                    help="replay an open request trace through GrIn-P "
                         "placement with SLO admission control")
    ap.add_argument("--trace", default=None,
                    help="request trace JSON (default: the bundled "
                         "examples/data/serve_trace.json)")
    ap.add_argument("--load", type=float, default=1.2,
                    help="offered load as a fraction of measured capacity "
                         "(--traffic; >1 = overload)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace of scheduler + admission "
                         "decisions here (--traffic; open in Perfetto)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(get_arch(args.arch))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = Model(cfg, device=dev).init(gen)
    n_patches = cfg.n_patches if cfg.family == "vlm" else 0
    engine = ServeEngine(model, max_len=n_patches + args.prompt_len
                         + args.steps + 8)

    tgen = torch.Generator().manual_seed(args.seed + 1)
    shape = ((args.batch, cfg.n_codebooks, args.prompt_len)
             if cfg.family == "audio" else (args.batch, args.prompt_len))
    toks = torch.randint(0, cfg.vocab_size, shape, generator=tgen).to(dev)
    batch = {"tokens": toks}
    if n_patches:
        batch["patch_embeds"] = torch.randn(
            (args.batch, n_patches, cfg.d_model), generator=tgen).to(
            dev, torch.bfloat16)

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

    if args.traffic:
        serve_traffic(engine, batch, toks, trace=args.trace, load=args.load,
                      trace_out=args.trace_out, device=dev)


if __name__ == "__main__":
    main()
