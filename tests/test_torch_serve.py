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
NEAR_TIE = 2.0 ** -6
# the families whose greedy tokens may part from the reference's at a bf16
# near-tie (see test_generate_matches_reference_greedy_tokens); every other
# arch must emit the reference's tokens exactly
NEAR_TIE_ARCHS = ("granite-moe-1b-a400m", "musicgen-medium",
                  "phi-3-vision-4.2b")


def _prompts(rc, prompt, seed=1):
    """Prompts as numpy arrays: (2, prompt) token ids, audio (2, K,
    prompt), vlm with (2, n_patches, d) random patch embeddings."""
    rng = np.random.default_rng(seed)
    shape = ((2, rc.n_codebooks, prompt) if rc.family == "audio"
             else (2, prompt))
    batch = {"tokens": rng.integers(0, rc.vocab_size, size=shape)}
    if rc.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (2, rc.n_patches, rc.d_model)).astype(np.float32)
    return batch


def _port_token_is_a_near_tie(ref_engine, batch, ref, step, port):
    """Whether the port's greedy tokens at `step` score within NEAR_TIE of
    the best in the reference's logits there (its prefill of the prompt
    and its own tokens before `step`); with the reference's top-2 margin
    for the message."""
    fed = ref[:, :step]
    if fed.ndim == 3:                          # audio: (B, step, K)
        fed = fed.swapaxes(1, 2)
    lg, _ = ref_engine.prefill(dict(
        {k: jnp.asarray(v) for k, v in batch.items()},
        tokens=jnp.asarray(np.concatenate([batch["tokens"], fed], axis=-1))))
    lg = np.asarray(lg[:, -1], np.float32)     # (B, V) or (B, K, V)
    best = lg.max(-1)
    mine = np.take_along_axis(lg, port[..., None], axis=-1)[..., 0]
    top2 = np.sort(lg, axis=-1)[..., -2:]
    return bool((best - mine <= NEAR_TIE).all()), (top2[..., 1]
                                                   - top2[..., 0]).tolist()


@pytest.mark.parametrize("arch,prompt", [("zamba2-7b", 100), ("yi-6b", 24),
                                         ("xlstm-1.3b", 70),
                                         ("granite-moe-1b-a400m", 40),
                                         ("musicgen-medium", 30),
                                         ("phi-3-vision-4.2b", 24)])
def test_generate_matches_reference_greedy_tokens(arch, prompt):
    """bf16 serving copies of the same weights emit the same greedy tokens
    (audio: one per codebook a step, (2, STEPS, K); vlm: decoding from
    after the patches and the prompt).

    zamba2-7b, yi-6b and xlstm-1.3b must emit the reference's tokens
    exactly. The two frameworks round bf16 products differently (their
    last-position logits differ by up to ~0.02 here), and for the
    NEAR_TIE_ARCHS the reference's best two logits lie closer than that
    (top-2 margins 0.0039 and 0.0), so a token flips and the sequences part
    there. For those archs only, where `generate`'s tokens differ, the
    port's engine is stepped again on the reference's tokens (prefill, then
    decode_step fed the reference's choice): at every step its greedy token
    must equal the reference's, or score within NEAR_TIE (2^-6, four bf16
    ulps of a logit in [0.5, 1)) of the best in the reference's logits
    there."""
    rc = rsmoke(rget_arch(arch))
    params = build_model(rc).init(jax.random.PRNGKey(0))
    batch = _prompts(rc, prompt)
    n_pre = prompt + (rc.n_patches if rc.family == "vlm" else 0)
    ref_engine = RServeEngine(build_model(rc), params,
                              max_len=n_pre + STEPS + 8)
    ref = np.asarray(ref_engine.generate(
        {k: jnp.asarray(v) for k, v in batch.items()}, steps=STEPS))
    model = model_params_from_reference(smoke_config(get_arch(arch)),
                                        jax.tree.map(np.asarray, params),
                                        device="cpu")
    engine = ServeEngine(model, max_len=n_pre + STEPS + 8)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = engine.generate(tb, steps=STEPS).numpy()
    assert out.shape == ((2, STEPS, rc.n_codebooks) if rc.family == "audio"
                         else (2, STEPS))
    if np.array_equal(out, ref):
        return
    if arch not in NEAR_TIE_ARCHS:
        step = int(np.argmax((out != ref).any(axis=0)))
        lg, _ = ref_engine.prefill({"tokens": jnp.asarray(
            np.concatenate([batch["tokens"], ref[:, :step]], axis=1))})
        top2 = np.sort(np.asarray(lg[:, -1], np.float32), axis=-1)[:, -2:]
        pytest.fail(f"greedy tokens differ from step {step}: port "
                    f"{out.tolist()} vs reference {ref.tolist()}; reference "
                    f"top-2 margin there {(top2[:, 1] - top2[:, 0]).tolist()}")
    logits, cache = engine.prefill(tb)
    for step in range(STEPS):
        mine = engine._greedy_next(logits)[0].numpy()
        if not np.array_equal(mine, ref[:, step]):
            tie, margins = _port_token_is_a_near_tie(ref_engine, batch, ref,
                                                     step, mine)
            assert tie, (f"step {step}: port {mine.tolist()} vs reference "
                         f"{ref[:, step].tolist()}, not a near-tie "
                         f"(reference top-2 margins {margins})")
        want = torch.from_numpy(np.array(ref[:, step]))[:, None]
        if rc.family == "audio":
            want = want.transpose(1, 2)            # (B, K, 1)
        logits, cache = model.decode_step(want, cache, n_pre + step)


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


@pytest.mark.parametrize("arch,shape", [("musicgen-medium", "(2, 4, 4)"),
                                        ("phi-3-vision-4.2b", "(2, 4)")])
def test_serve_cli_serves_the_audio_and_vlm_families_on_cpu(capsys, arch,
                                                            shape):
    """musicgen-medium ((B, K, S) prompts, one token per codebook a step)
    and phi-3-vision-4.2b (random patch embeddings before the prompt)
    through the CLI's engine and its two request classes."""
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "12",
                "--steps", "4", "--device", "cpu", "--heterogeneous"])
    out = capsys.readouterr().out
    assert f"{arch} on cpu: generated {shape} tokens" in out
    assert "CAB: X=" in out and "LB: X=" in out


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "musicgen-medium",
                                  "phi-3-vision-4.2b"])
def test_decode_request_decodes_from_the_prefix_length(arch, monkeypatch):
    """`request_service_fns`' decode request prefills the first 4 prompt
    positions (audio along its last axis, vlm with its patches) and
    decodes from their true length: 4, or 4 + n_patches for vlm."""
    from repro_torch.models.model import Model
    cfg = smoke_config(get_arch(arch))
    engine = ServeEngine(Model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)), max_len=48)
    g = torch.Generator().manual_seed(1)
    shape = (1, cfg.n_codebooks, 10) if cfg.family == "audio" else (1, 10)
    toks = torch.randint(0, cfg.vocab_size, shape, generator=g)
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn((1, cfg.n_patches, cfg.d_model),
                                            generator=g)
    seen = []
    real = engine.decode_run

    def spy(first, cache, start, steps):
        seen.append((tuple(first.shape), start,
                     int(cache["attn"][0]["kpos"].max())))
        return real(first, cache, start, steps)
    monkeypatch.setattr(engine, "decode_run", spy)
    request_service_fns(engine, batch, toks)[1][1](1.0)
    n = 4 + (cfg.n_patches if cfg.family == "vlm" else 0)
    feed = (1, cfg.n_codebooks, 1) if cfg.family == "audio" else (1, 1)
    assert seen == [(feed, n, n - 1)]


def test_serve_cli_defaults_to_cuda(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "yi-6b"])
