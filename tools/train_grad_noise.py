#!/usr/bin/env python3
"""How far rounding alone moves a train phase's gradient check, on an
NVIDIA GPU:

    python3 tools/train_grad_noise.py [--arch zamba2-7b --layers 27]
        [--dtypes bfloat16 float32]

Builds `--arch` at full width (cut to `--layers` blocks when given) from
the train phases' seeded initialisation and takes one microbatch's
gradients (1 x 4096 tokens of the phases' data) at each compute dtype by
four routes: the plain scans (`chip_smoke.plain_scans`: autograd of
`linear_scan_chunked`, chunk 256), the same with chunk 64 (the same
recurrence, other rounding), the scan kernels (their forward kernels and
backward kernels), and the kernels with one layer's scan gradient dropped
(the check's control); and the kernels and the control against the kernel
forwards with the scans' plain backward (`chip_smoke.plain_scan_backward`). Prints ||d|| / ||plain|| of the worst leaf groups
(`chip_smoke.group_rel_errs`) for each route against the plain one:
what the check can tell apart at that dtype. Attention takes its plain
route on every side at float32 (the flash kernels take bf16 only).
Writes `chiprun_out/train_grad_noise_<arch>.json`. Imports nothing of JAX.

For the attention families (dense, moe; `--arch granite-moe-3b-a800m`)
the routes are the plain attention at the model's chunk (1024) and at
another (512: the same softmax, other rounding), the flash kernels, and
the kernels with one layer's flash gradient dropped; for the moe family
each routed to the plain route's expert choices call by call
(`chip_smoke.choosing_experts`), and the chunk-512 plain route also by
its own router. At float32 the plain routes only (the flash kernels take
bf16).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    from repro_torch.train.data import DataConfig, batch_for_step
    from repro_torch.train.train_step import compute_copy, loss_and_grads
    if not torch.cuda.is_available():
        print("train_grad_noise: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cs.build_kernels()
    dev = torch.device("cuda")
    cfg = get_arch(args.arch)
    if args.layers:
        cfg = cfg.with_(n_layers=args.layers)
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    params = dict(model.named_parameters())
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=cs.TRAIN_S,
                    global_batch=cs.TRAIN_B)
    mb = {k: torch.from_numpy(v[:cs.TRAIN_B // cs.TRAIN_MICRO]).to(dev)
          for k, v in batch_for_step(dc, 0).items()}
    fn, n_bwd, group = cs.train_control(cfg)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "dropped": group}
    if cfg.family in ("dense", "moe"):
        out.update(attention_noise(cs, cfg, model, params, mb, args.dtypes,
                                   fn, n_bwd))
        args.dtypes = []
    for dtype in args.dtypes:
        model.cfg = cfg.with_(dtype=dtype)
        pc = compute_copy(params, getattr(torch, dtype))
        attn = (contextlib.nullcontext() if dtype == "bfloat16"
                else cs.plain_attention())

        def grads(*ctx, chunk=cfg.ssm_chunk):
            model.cfg = cfg.with_(dtype=dtype, ssm_chunk=chunk)
            t = time.perf_counter()
            with contextlib.ExitStack() as st:
                for c in ctx:
                    st.enter_context(c)
                loss, _, g = loss_and_grads(model, pc, mb)
            torch.cuda.synchronize()
            return float(loss), g, time.perf_counter() - t
        with attn:
            lp, gp, sp = grads(cs.plain_scans())
            rows = {"plain": {"loss": lp, "s": sp}}
            # the same kernel forwards, the scans' plain backward
            lb, gb, sb = grads(cs.plain_scan_backward())
            for name, ctx in (
                    ("kernels against the plain backward", ()),
                    ("kernels, one scan gradient dropped, against the "
                     "plain backward",
                     (cs.dropped_grad(fn, n_bwd // 2, {}),))):
                loss, g, sec = grads(*ctx)
                rel = cs.group_rel_errs(g, gb)
                del g
                worst = sorted(rel.items(), key=lambda kv: -kv[1])
                rows[name] = {"loss": loss, "s": sec, "worst": worst[:6],
                              "median": worst[len(worst) // 2][1]}
                print(f"{cfg.name} ({cfg.n_layers} blocks) {dtype} {name}: "
                      f"loss {loss:.6f} ({lb:.6f}); worst groups "
                      f"{[(k, round(v, 5)) for k, v in worst[:4]]}, median "
                      f"{rows[name]['median']:.2e}; {sec:.1f} s", flush=True)
            del gb
            for name, ctx, chunk in (
                    ("plain chunk 64", (cs.plain_scans(),), 64),
                    ("kernels", (), cfg.ssm_chunk),
                    ("kernels, one scan gradient dropped",
                     (cs.dropped_grad(fn, n_bwd // 2, {}),), cfg.ssm_chunk)):
                loss, g, sec = grads(*ctx, chunk=chunk)
                rel = cs.group_rel_errs(g, gp)
                del g
                worst = sorted(rel.items(), key=lambda kv: -kv[1])
                rows[name] = {"loss": loss, "s": sec, "worst": worst[:6],
                              "median": worst[len(worst) // 2][1]}
                print(f"{cfg.name} ({cfg.n_layers} blocks) {dtype} {name}: "
                      f"loss {loss:.6f} (plain {lp:.6f}); worst groups "
                      f"{[(k, round(v, 5)) for k, v in worst[:4]]}, median "
                      f"{rows[name]['median']:.2e}; {sec:.1f} s", flush=True)
                torch.cuda.empty_cache()
        out[dtype] = rows
        del gp, pc
        torch.cuda.empty_cache()
    path = ROOT / "chiprun_out"
    path.mkdir(exist_ok=True)
    (path / f"train_grad_noise_{cfg.name}.json").write_text(
        json.dumps(out, indent=1))
    return 0


def attention_noise(cs, cfg, model, params, mb, dtypes, fn, n_bwd) -> dict:
    """The attention families' rows (see the module's docstring)."""
    import torch
    from repro_torch.models.layers import top_k
    from repro_torch.train.train_step import compute_copy, loss_and_grads
    out = {}
    for dtype in dtypes:
        pc = compute_copy(params, getattr(torch, dtype))
        choices = []

        def record(i, probs):
            choices.append(top_k(probs, cfg.top_k)[1])

        def pinned():
            return (cs.choosing_experts(cfg, lambda i, probs: choices[i]),
                    ) if cfg.family == "moe" else ()

        def grads(*ctx, chunk=cfg.attn_chunk_q):
            model.cfg = cfg.with_(dtype=dtype, attn_chunk_q=chunk,
                                  attn_chunk_k=chunk)
            t = time.perf_counter()
            with contextlib.ExitStack() as st:
                for c in ctx:
                    st.enter_context(c)
                loss, _, g = loss_and_grads(model, pc, mb)
            torch.cuda.synchronize()
            return float(loss), g, time.perf_counter() - t
        first = ((cs.choosing_experts(cfg, record),) if cfg.family == "moe"
                 else ())
        lp, gp, sp = grads(cs.plain_attention(), *first)
        rows = {"plain": {"loss": lp, "s": sp}}
        routes = [("plain chunk 512", lambda: (cs.plain_attention(),
                                               *pinned()), 512)]
        if cfg.family == "moe":
            routes.append(("plain chunk 512, routed by itself",
                           lambda: (cs.plain_attention(),), 512))
        if dtype == "bfloat16":
            routes += [("kernels", pinned, cfg.attn_chunk_q),
                       ("kernels, one flash gradient dropped", lambda: (
                           *pinned(), cs.dropped_grad(fn, n_bwd // 2, {})),
                        cfg.attn_chunk_q)]
        for name, ctx, chunk in routes:
            loss, g, sec = grads(*ctx(), chunk=chunk)
            rel = cs.group_rel_errs(g, gp)
            del g
            worst = sorted(rel.items(), key=lambda kv: -kv[1])
            rows[name] = {"loss": loss, "s": sec, "worst": worst[:6],
                          "median": worst[len(worst) // 2][1]}
            print(f"{cfg.name} ({cfg.n_layers} blocks) {dtype} {name}: "
                  f"loss {loss:.6f} (plain {lp:.6f}); worst groups "
                  f"{[(k, round(v, 5)) for k, v in worst[:4]]}, median "
                  f"{rows[name]['median']:.2e}; {sec:.1f} s", flush=True)
            torch.cuda.empty_cache()
        out[dtype] = rows
        del gp, pc
        model.cfg = cfg
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(main())
