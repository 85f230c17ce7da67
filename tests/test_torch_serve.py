"""The port's serving path against the reference's, on the CPU: greedy
generation from the bf16 serving copy, the virtual-time cluster, and the
`repro_torch.launch.serve` CLI."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as rget_arch  # noqa: E402
from repro.configs import smoke_config as rsmoke  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.sched import virtual as rvirtual  # noqa: E402
from repro.serve.engine import ServeEngine as RServeEngine  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.convert import model_params_from_reference  # noqa: E402
from repro_torch.sched.virtual import VirtualTimeCluster  # noqa: E402
from repro_torch.serve.engine import (ServeEngine,  # noqa: E402
                                      request_service_fns, with_retries)

STEPS = 8


@pytest.mark.parametrize("arch,prompt", [("zamba2-7b", 100), ("yi-6b", 24),
                                         ("xlstm-1.3b", 70)])
def test_generate_matches_reference_greedy_tokens(arch, prompt):
    """bf16 serving copies of the same weights emit the same greedy tokens.
    A near-tie could flip a token between the two frameworks' bf16
    rounding; the assertion message then carries the reference's top-2
    margin at the first differing step."""
    rc = rsmoke(rget_arch(arch))
    params = build_model(rc).init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, rc.vocab_size,
                                             size=(2, prompt))
    ref_engine = RServeEngine(build_model(rc), params,
                              max_len=prompt + STEPS + 8)
    ref = np.asarray(ref_engine.generate({"tokens": jnp.asarray(toks)},
                                         steps=STEPS))
    model = model_params_from_reference(smoke_config(get_arch(arch)),
                                        jax.tree.map(np.asarray, params),
                                        device="cpu")
    engine = ServeEngine(model, max_len=prompt + STEPS + 8)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    out = engine.generate({"tokens": torch.from_numpy(toks)},
                          steps=STEPS).numpy()
    assert out.shape == (2, STEPS)
    if not np.array_equal(out, ref):
        step = int(np.argmax((out != ref).any(axis=0)))
        lg, _ = ref_engine.prefill({"tokens": jnp.asarray(
            np.concatenate([toks, ref[:, :step]], axis=1))})
        top2 = np.sort(np.asarray(lg[:, -1], np.float32), axis=-1)[:, -2:]
        pytest.fail(f"greedy tokens differ from step {step}: port "
                    f"{out.tolist()} vs reference {ref.tolist()}; reference "
                    f"top-2 margin there {(top2[:, 1] - top2[:, 0]).tolist()}")


def test_decode_run_keeps_the_prefill_cache_consistent():
    """generate == prefill + decode_run fed by hand (same engine)."""
    cfg = smoke_config(get_arch("zamba2-7b"))
    from repro_torch.models.model import Model
    engine = ServeEngine(Model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)), max_len=40)
    toks = torch.randint(0, cfg.vocab_size, (1, 20),
                         generator=torch.Generator().manual_seed(2))
    out = engine.generate({"tokens": toks}, steps=5)
    logits, cache = engine.prefill({"tokens": toks})
    first, feed = engine._greedy_next(logits)
    rest, _ = engine.decode_run(feed, cache, 20, 4)
    assert torch.equal(out, torch.cat([first[:, None], rest], dim=1))


def _det_fns(mu):
    return [{t: (lambda size, r=mu[t, j]: 1.0 / r) for t in range(2)}
            for j in range(2)]


@pytest.mark.parametrize("policy", ["cab", "lb", "grin"])
def test_virtual_cluster_matches_reference_exactly(policy):
    """measure_real=False with deterministic service times: the port's
    cluster reproduces the reference's throughput and counts exactly."""
    from repro.sched import SchedulerCore as RCore
    from repro_torch.sched import SchedulerCore
    mu = np.array([[6.0, 2.0], [1.5, 4.0]])
    types = [0] * 4 + [1] * 4
    rm = rvirtual.VirtualTimeCluster(_det_fns(mu), measure_real=False)
    pm = VirtualTimeCluster(_det_fns(mu), measure_real=False)
    np.testing.assert_array_equal(pm.measure_rates(2, reps=2),
                                  rm.measure_rates(2, reps=2))
    r = rm.run_closed(RCore(policy, mu), types, n_completions=60, warmup=10)
    p = pm.run_closed(SchedulerCore(policy, mu, device="cpu"), types,
                      n_completions=60, warmup=10)
    assert p.throughput == r.throughput
    assert p.mean_response_time == r.mean_response_time
    np.testing.assert_array_equal(p.per_pool_tasks, r.per_pool_tasks)
    q = pm.run_closed(policy, types, n_completions=60, warmup=10, mu=mu,
                      device="cpu")
    assert q.throughput == r.throughput
    with pytest.raises(ValueError, match="mu="):
        pm.run_closed(policy, types)


def test_request_service_fns_and_retries_run_real_tasks():
    cfg = smoke_config(get_arch("yi-6b"))
    from repro_torch.models.model import Model
    engine = ServeEngine(Model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)), max_len=32)
    toks = torch.randint(0, cfg.vocab_size, (1, 8),
                         generator=torch.Generator().manual_seed(1))
    fns = request_service_fns(engine, {"tokens": toks}, toks)
    vc = VirtualTimeCluster(fns)
    mu = vc.measure_rates(2, reps=1)
    assert mu.shape == (2, 2) and (mu > 0).all()
    calls, wasted = [], []

    def flaky(size):
        calls.append(size)
        if len(calls) < 2:
            raise RuntimeError("transient")
        return fns[0][0](size)

    with_retries(flaky, on_wasted=wasted.append)(1.0)
    assert len(calls) == 2 and wasted == [0]
    with pytest.raises(ValueError):
        with_retries(flaky, max_attempts=0)


def test_serve_cli_runs_on_cpu(capsys, tmp_path):
    import json
    from repro_torch.launch import serve
    # --traffic on the first 60 requests of the bundled trace
    with open(serve._TRACE) as f:
        tr = json.load(f)
    short = tmp_path / "trace.json"
    short.write_text(json.dumps({k: v[:60] for k, v in tr.items()}))
    chrome = tmp_path / "decisions.json"
    serve.main(["--arch", "zamba2-7b", "--batch", "1", "--prompt-len", "8",
                "--steps", "4", "--device", "cpu", "--heterogeneous",
                "--traffic", "--trace", str(short), "--trace-out",
                str(chrome)])
    out = capsys.readouterr().out
    assert "generated (1, 4) tokens" in out
    assert "CAB: X=" in out and "LB: X=" in out
    for c, name in enumerate(("prefill", "decode")):
        line = [ln for ln in out.splitlines()
                if f"class {c} ({name}): done" in ln]
        assert len(line) == 1 and " shed " in line[0] \
            and " p99 " in line[0], out
    assert "GrIn-P + admission @ load 1.20: goodput" in out
    events = json.loads(chrome.read_text())["traceEvents"]
    assert events and {e["cat"] for e in events} >= {"sched", "admission"}


def test_serve_cli_serves_the_ssm_family_on_cpu(capsys):
    """xlstm-1.3b (mLSTM + sLSTM blocks) through the CLI's engine."""
    from repro_torch.launch import serve
    serve.main(["--arch", "xlstm-1.3b", "--batch", "2", "--prompt-len", "40",
                "--steps", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "xlstm-1.3b on cpu: generated (2, 4) tokens" in out


def test_serve_cli_defaults_to_cuda(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "yi-6b"])
