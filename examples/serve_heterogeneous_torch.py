"""Heterogeneous serving on the PyTorch port, with real model steps: the
steps of `serve_heterogeneous.py` through `repro_torch`.

Two pools serve a mix of request classes with real executions of a small
LM (`ServeEngine`). Pool A holds long caches ("compute pool"), pool B
short ones ("latency pool"); the measured affinity matrix drives a GrIn-P
`SchedulerCore` (class 0 = interactive prefill, weighted 2 : 1; class 1 =
batch decode) behind an SLO `AdmissionController`, and the bundled open
request trace (`examples/data/serve_trace.json`) replays against it in
virtual time (`VirtualTimeCluster`) at rising load.

Run:  PYTHONPATH=src python examples/serve_heterogeneous_torch.py [--smoke]
          [--device cpu]
(cuda is the default device, which raises without a card.)
"""
import argparse
import os

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch, smoke_config
from repro_torch.core import classify_2x2
from repro_torch.models.model import Model
from repro_torch.sched import SchedulerCore
from repro_torch.sched.priority import GrInPriorityPolicy
from repro_torch.sched.virtual import VirtualTimeCluster
from repro_torch.serve.engine import ServeEngine
from repro_torch.traffic import (AdmissionController, SLOClass, load_trace,
                                 replay_open)

TRACE = os.path.join(os.path.dirname(__file__), "data", "serve_trace.json")


def build_service_fns(dev):
    cfg = smoke_config(get_arch("qwen2.5-3b")).with_(
        n_layers=2, d_model=128, vocab_size=1024)
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    engA = ServeEngine(model, max_len=256)      # pool A: long contexts
    engB = ServeEngine(model, max_len=64)       # pool B: short decode
    toks = torch.randint(0, 1024, (1, 192), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))

    def prefill_on_A(size):  # 192-token context in one call
        engA.prefill({"tokens": toks})
        engA.synchronize()

    def prefill_on_B(size):  # B must chunk the context into 64-token windows
        for i in range(3):
            engB.prefill({"tokens": toks[:, i * 64:(i + 1) * 64]})
        engB.synchronize()

    def decode_on_A(size):   # 24 greedy steps against the 256-slot cache
        _, cache = engA.prefill({"tokens": toks[:, :16]})
        engA.decode_run(toks[:, :1], cache, 16, 24)
        engA.synchronize()

    def decode_on_B(size):   # 24 greedy steps against the 64-slot cache
        _, cache = engB.prefill({"tokens": toks[:, :16]})
        engB.decode_run(toks[:, :1], cache, 16, 24)
        engB.synchronize()

    def slow(fn, n):  # mismatched engine: repeat the real work n times
        return lambda size: [fn(size) for _ in range(n)]

    # At this toy scale dispatch overhead hides most of the real shape
    # penalty, so the off-diagonal mismatch is modelled by repetition (as
    # `serve.engine.request_service_fns` does): prefill on the decode pool
    # or decode on the prefill pool costs 3x.
    return [{0: prefill_on_A, 1: slow(decode_on_A, 3)},
            {0: slow(prefill_on_B, 3), 1: decode_on_B}]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="short trace + fewer measurement reps")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    fns = build_service_fns(dev)
    vc = VirtualTimeCluster(fns)
    print("measuring affinity matrix from real executions ...")
    mu = vc.measure_rates(2, reps=2 if args.smoke else 8)
    print("mu =\n", np.round(mu, 2), "\ncase:", classify_2x2(mu).value)

    times, classes = load_trace(TRACE)
    if args.smoke:
        times, classes = times[:80], classes[:80]
    trace_rate = len(times) / float(times[-1] - times[0])
    # saturation knee: the load where the busiest class fills its best pool,
    # given the trace's class mix
    shares = np.bincount(classes, minlength=2) / len(classes)
    x_knee = 1.0 / max(shares[c] / mu[c].max() for c in range(2))
    qcap = 6
    # FCFS pools: the best interactive p90 is its own service plus one
    # worst-case head-of-line block; the SLO allows 1.5x that block
    slo = (SLOClass(deadline=1.5 / mu[1].min() + 6.0 / mu[0].max(),
                    percentile=0.9, protected=True),
           SLOClass(deadline=60.0 / mu[1].max(), percentile=0.9))

    print(f"replaying {len(times)} requests "
          f"(saturation knee ~{x_knee:.2f} req/s) ...")
    for load in (0.7, 1.3):
        scaled = times * (trace_rate / (load * x_knee))
        core = SchedulerCore(GrInPriorityPolicy((2.0, 1.0)), mu, device=dev)
        adm = AdmissionController(core, slo, class_of_type=[0, 1],
                                  queue_capacity=qcap, window=64,
                                  adapt_every=8)
        m = replay_open(vc, adm, scaled, classes, warmup=len(times) // 10)
        print(f"load={load:.1f}x: goodput {m.throughput:6.2f} req/s | " +
              " | ".join(
                  f"class {c}: p99 {m.class_p99[c]:6.3f}s "
                  f"SLO {m.class_deadline_met[c]:.2f} "
                  f"shed {int(m.class_shed[c])}"
                  for c in range(2)))
    print("class 0 (protected prefill) holds its SLO; class 1 (best-effort "
          "decode) absorbs the overload via shedding.")


if __name__ == "__main__":
    main()
