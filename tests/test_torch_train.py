"""The port's training substrate (`repro_torch.train`, `launch.train`)
against the reference's, on the CPU.

Inputs are made with numpy from a seed and handed to both. What is held,
and how tightly:
  * `lr_at` and `apply_updates` (AdamW, clipping, no decay on 1-D leaves,
    int8 compression with error feedback) on identical gradients, three
    steps: parameters, moments, residual and metrics to 2e-6 relative, and
    2e-6 of each array's largest entry absolute (float32; the two sum the
    gradient norm in another order, so the clip scale differs by an ulp);
  * `_batch_at` bit-equal for dense, audio and vlm data configs;
  * checkpoints: the reference's layout and key paths, round trip, GC,
    async writes of a snapshot; `run_with_recovery` healing an injected
    failure (bit-equal to an uninterrupted run), joining an in-flight
    async write, and, for a fault inside the in-place update, replaying
    only from a checkpoint (bit-equal) and raising without one;
  * the train step of qwen2.5-3b's smoke config (and zamba2-7b's and
    xlstm-1.3b's) at float32 compute from the reference's initial state
    (`convert.train_state_from_reference`), one and two steps,
    microbatches 1 and 2: loss to 1e-5 relative,
    parameters to 5e-5 + 5e-4 relative (the reference's own microbatching
    tolerance). At float32 the gradients agree to ~1e-6, far from Adam's
    first-step sign flip (m / sqrt(v) = g / |g|, 2 lr apart), which a bf16
    comparison would hit.
"""
import os
import tempfile
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import smoke_config as ref_smoke  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.train import data as RD  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402
from repro.train.train_step import init_train_state as ref_init  # noqa: E402
from repro.train.train_step import make_train_step as ref_step  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.convert import train_state_from_reference  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import data as PD  # noqa: E402
from repro_torch.train import optimizer as PO  # noqa: E402
from repro_torch.train.fault_tolerance import (  # noqa: E402
    PartialUpdateError, run_with_recovery)
from repro_torch.train.train_step import (init_train_state,  # noqa: E402
                                          make_train_step)

ARCH = "qwen2.5-3b"


# ------------------------------------------------------------ optimizer

@pytest.mark.parametrize("step", [0, 1, 2, 7, 10, 11, 250, 10_000, 20_000])
def test_lr_at_matches_reference(step):
    for cfg in (PO.OptimizerConfig(), PO.OptimizerConfig(
            lr=1e-3, warmup_steps=1, decay_steps=50, min_lr_ratio=0.0)):
        ref = RO.OptimizerConfig(**vars(cfg))
        np.testing.assert_allclose(PO.lr_at(cfg, step),
                                   float(RO.lr_at(ref, step)), rtol=1e-6)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_apply_updates_matches_reference(compress, clip):
    rng = np.random.default_rng(17)
    shapes = {"w": (12, 7), "b": (7,), "e": (3, 5, 4), "ln": (9,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    cfg = PO.OptimizerConfig(lr=2e-3, warmup_steps=2, decay_steps=10,
                             grad_clip=clip, compress_grads=compress)
    rcfg = RO.OptimizerConfig(**vars(cfg))
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    rs = RO.init_opt_state(rp, rcfg)
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ps = PO.init_opt_state(pp, cfg)
    for _ in range(3):
        grads = {k: (3 * rng.standard_normal(s)).astype(np.float32)
                 for k, s in shapes.items()}
        rp, rs, rmet = RO.apply_updates(
            rp, {k: jnp.asarray(v) for k, v in grads.items()}, rs, rcfg)
        pmet = PO.apply_updates(pp, {k: torch.from_numpy(v) for k, v in
                                     grads.items()}, ps, cfg)
        assert ps["step"] == int(rs["step"])
        np.testing.assert_allclose(pmet["grad_norm"],
                                   float(rmet["grad_norm"]), rtol=2e-6)
        np.testing.assert_allclose(pmet["lr"], float(rmet["lr"]), rtol=2e-6)
        for k in shapes:
            for key in ("p", "m", "v") + (("err",) if compress else ()):
                got = (pp if key == "p" else ps[key])[k].numpy()
                want = np.asarray((rp if key == "p" else rs[key])[k])
                np.testing.assert_allclose(
                    got, want, rtol=2e-6, atol=2e-6 * np.abs(want).max(),
                    err_msg=f"{key}/{k}")


def test_int8_quantization_matches_reference():
    x = np.array([0.1, -0.5, 3.0, 1e-4, -2.99], np.float32)
    q, s = PO.quantize_int8(torch.from_numpy(x))
    rq, rs = RO.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    deq = PO.dequantize_int8(q, s)
    np.testing.assert_allclose(deq.numpy(),
                               np.asarray(RO.dequantize_int8(rq, rs)),
                               rtol=1e-7)
    assert float((deq - torch.from_numpy(x)).abs().max()) <= float(s) * 0.51


# ------------------------------------------------------------ data

@pytest.mark.parametrize("arch", ["qwen2.5-3b", "musicgen-medium",
                                  "phi-3-vision-4.2b"])
def test_batches_are_bit_equal_to_the_reference(arch):
    cfg = smoke_config(get_arch(arch))
    kw = dict(vocab_size=cfg.vocab_size, seq_len=24, global_batch=3,
              n_codebooks=cfg.n_codebooks, n_patches=cfg.n_patches,
              d_model=cfg.d_model)
    for index in (0, 7):
        got = PD._batch_at(PD.DataConfig(**kw), index)
        want = RD._batch_at(RD.DataConfig(**kw), index)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    pipe = PD.DataPipeline(PD.DataConfig(**kw), start_step=7)
    i, streamed = next(pipe)
    pipe.close()
    assert i == 7
    np.testing.assert_array_equal(streamed["tokens"],
                                  RD.batch_for_step(RD.DataConfig(**kw),
                                                    7)["tokens"])


# ------------------------------------------------------------ state

def _port_setup(microbatches=1, **opt_kw):
    cfg = smoke_config(get_arch(ARCH))
    model = Model(cfg, device="cpu")
    opt = PO.OptimizerConfig(warmup_steps=2, decay_steps=20, **opt_kw)
    state = init_train_state(model, torch.Generator().manual_seed(0), opt)
    step = make_train_step(model, opt, microbatches=microbatches)
    dc = PD.DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                       global_batch=4)
    return model, state, step, dc


def _batch(dc, i):
    return {k: torch.from_numpy(v) for k, v in
            PD.batch_for_step(dc, i).items()}


def _leaves(tree):
    return {k: v for k, v in ckpt._leaves(tree)}


def test_checkpoint_layout_roundtrip_and_gc():
    _, state, step, dc = _port_setup()
    state, _ = step(state, _batch(dc, 0))
    before = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
              for k, v in _leaves(state).items()}
    assert {"0/embed", "1/m/embed", "1/v/ln_f", "1/step", "2"} <= set(before)
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4):
            ckpt.save(d, s, state, keep=2)
        assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
        assert sorted(os.listdir(os.path.join(d, "step_00000004"))) == [
            "arrays.npz", "tree.json"]
        for t in state.params.values():
            t.zero_()
        state.step = 0
        restored, at = ckpt.restore(d, state)
        assert at == 4 and ckpt.latest_step(d) == 4
        for k, v in _leaves(restored).items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, before[k]), k
            else:
                assert v == before[k], k
        # the masters are restored in place: still the model's parameters
        assert restored.params["embed"] is state.params["embed"]


def test_async_checkpoint_writes_a_snapshot():
    """The state is updated in place, so an async save copies it to the
    host before returning: a later step does not reach the file."""
    _, state, step, dc = _port_setup()
    with tempfile.TemporaryDirectory() as d:
        t = ckpt.save(d, 1, state, async_=True)
        want = state.params["embed"].clone()
        state.params["embed"].add_(1.0)
        t.join()
        state.params["embed"].zero_()
        restored, _ = ckpt.restore(d, state)
        assert torch.equal(restored.params["embed"], want)


class _Iter:
    def __init__(self, dc):
        self.dc, self.i = dc, 0

    def __iter__(self):
        return self

    def __next__(self):
        i = self.i
        self.i += 1
        return i, _batch(self.dc, i)

    def seek(self, step_):
        self.i = step_


def test_run_with_recovery_heals_injected_failure():
    """Restore from the latest checkpoint and replay by step index: the
    recovered parameters equal an uninterrupted run's bit for bit."""
    _, state, step, dc = _port_setup()
    calls = {"n": 0}

    def flaky_step(s, batch):
        calls["n"] += 1
        if calls["n"] == 5:
            raise RuntimeError("injected node failure")
        return step(s, batch)

    with tempfile.TemporaryDirectory() as d:
        final, steps, restarts = run_with_recovery(
            flaky_step, state, _Iter(dc), ckpt_dir=d, ckpt_every=2,
            max_steps=7, async_ckpt=False)
    assert (steps, restarts, final.step) == (7, 1, 7)
    _, clean, step2, _ = _port_setup()
    with tempfile.TemporaryDirectory() as d:
        clean, _, _ = run_with_recovery(step2, clean, _Iter(dc), ckpt_dir=d,
                                        ckpt_every=100, max_steps=7)
    for name, p in final.params.items():
        assert torch.equal(p, clean.params[name]), name


def test_recovery_joins_inflight_async_checkpoint(monkeypatch):
    """A crash while an async checkpoint is still writing drains the
    writer before restore (the reference's test, on the port)."""
    _, state, step, dc = _port_setup()
    calls, inflight = {"n": 0}, {"n": 0}
    real_save, real_latest = ckpt.save, ckpt.latest_step

    def slow_save(d, step_, tree, keep=3, async_=False):
        if not async_:
            return real_save(d, step_, tree, keep=keep)
        inflight["n"] += 1
        snap = ckpt._flatten(tree)      # what the real save snapshots

        def work():
            time.sleep(0.25)
            real_save(d, step_, tree, keep=keep)
            inflight["n"] -= 1
        assert snap
        t = threading.Thread(target=work)
        t.start()
        return t

    def checked_latest(d):
        assert inflight["n"] == 0, \
            "restore raced an in-flight async checkpoint write"
        return real_latest(d)

    monkeypatch.setattr(ckpt, "save", slow_save)
    monkeypatch.setattr(ckpt, "latest_step", checked_latest)

    def flaky_step(s, batch):
        calls["n"] += 1
        if calls["n"] == 3:  # right after the step-2 checkpoint launches
            raise RuntimeError("injected node failure")
        return step(s, batch)

    with tempfile.TemporaryDirectory() as d:
        _, steps, restarts = run_with_recovery(
            flaky_step, state, _Iter(dc), ckpt_dir=d, ckpt_every=2,
            max_steps=4, async_ckpt=True)
        assert inflight["n"] == 0
    assert (steps, restarts) == (4, 1)


@pytest.mark.parametrize("ckpt_every", [2, 100])
def test_fault_inside_the_update_replays_only_from_a_checkpoint(
        monkeypatch, ckpt_every):
    """A fault on the second leaf of step 3's update leaves the in-place
    state torn: with the step-2 checkpoint the replay restores it and ends
    bit-equal to an uninterrupted run; with no checkpoint it is raised."""
    _, state, step, dc = _port_setup()
    n_leaves = len(state.params)
    calls = {"n": 0}
    real_leaf = PO._adamw_leaf

    def flaky_leaf(*args):
        calls["n"] += 1
        if calls["n"] == 2 * n_leaves + 2:
            raise RuntimeError("injected fault in the update")
        return real_leaf(*args)

    monkeypatch.setattr(PO, "_adamw_leaf", flaky_leaf)
    with tempfile.TemporaryDirectory() as d:
        if ckpt_every > 5:
            with pytest.raises(PartialUpdateError) as err:
                run_with_recovery(step, state, _Iter(dc), ckpt_dir=d,
                                  ckpt_every=ckpt_every, max_steps=5,
                                  async_ckpt=False)
            assert "injected fault" in str(err.value.__cause__)
            return
        final, steps, restarts = run_with_recovery(
            step, state, _Iter(dc), ckpt_dir=d, ckpt_every=ckpt_every,
            max_steps=5, async_ckpt=False)
    assert (steps, restarts, final.step) == (5, 1, 5)
    monkeypatch.setattr(PO, "_adamw_leaf", real_leaf)
    _, clean, step2, _ = _port_setup()
    with tempfile.TemporaryDirectory() as d:
        clean, _, _ = run_with_recovery(step2, clean, _Iter(dc), ckpt_dir=d,
                                        ckpt_every=100, max_steps=5)
    for name, p in final.params.items():
        assert torch.equal(p, clean.params[name]), name
    for k in ("m", "v"):
        for name, x in final.opt[k].items():
            assert torch.equal(x, clean.opt[k][name]), (k, name)


# ------------------------------------------------------------ train step

@pytest.mark.parametrize("arch,microbatches", [
    pytest.param(ARCH, 1, id="1"), pytest.param(ARCH, 2, id="2"),
    pytest.param("zamba2-7b", 1, id="zamba2-7b-1"),
    pytest.param("xlstm-1.3b", 2, id="xlstm-1.3b-2")])
def test_train_step_matches_reference(arch, microbatches):
    """qwen2.5-3b's, zamba2-7b's and xlstm-1.3b's smoke configs at float32
    compute, from the reference's initial state: after one and after two
    steps (the hybrid and ssm families through their scans, whose backward
    on the card is the SSD and mLSTM backward kernels)."""
    rcfg = ref_smoke(REF_ARCHS[arch]).with_(dtype="float32")
    m = build_model(rcfg)
    ropt = RO.OptimizerConfig(warmup_steps=2, decay_steps=20)
    rstate = jax.jit(lambda k: ref_init(m, k, ropt))(jax.random.PRNGKey(0))
    rfn = jax.jit(ref_step(m, ropt, microbatches=microbatches))
    model = Model(smoke_config(get_arch(arch)).with_(dtype="float32"),
                  device="cpu")
    state = train_state_from_reference(jax.tree.map(np.asarray, rstate),
                                       model)
    assert state.step == 0 and state.opt["step"] == 0
    pfn = make_train_step(model, PO.OptimizerConfig(**vars(ropt)),
                          microbatches=microbatches)
    dc = PD.DataConfig(vocab_size=rcfg.vocab_size, seq_len=32,
                       global_batch=4)
    for i in range(2):
        batch = PD.batch_for_step(dc, i)
        rstate, rmet = rfn(rstate, {k: jnp.asarray(v) for k, v in
                                    batch.items()})
        state, met = pfn(state, {k: torch.from_numpy(v) for k, v in
                                 batch.items()})
        np.testing.assert_allclose(met["loss"], float(rmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(met["lr"], float(rmet["lr"]), rtol=1e-6)
        assert state.step == int(rstate.step) == i + 1
        want = train_state_from_reference(
            jax.tree.map(np.asarray, rstate),
            Model(model.cfg, device="cpu"))
        for name, p in state.params.items():
            np.testing.assert_allclose(p.numpy(), want.params[name].numpy(),
                                       rtol=5e-4, atol=5e-5, err_msg=name)


def test_train_step_takes_zero_stage_2_only():
    model = Model(smoke_config(get_arch(ARCH)), device="cpu")
    with pytest.raises(ValueError, match="zero_stage"):
        make_train_step(model, PO.OptimizerConfig(), zero_stage=3)


def test_launcher_trains_on_the_cpu_and_needs_the_card_by_default(capsys):
    from repro_torch.launch import train as T
    with tempfile.TemporaryDirectory() as d:
        out = T.train(ARCH, steps=3, batch=2, seq=16, device="cpu",
                      ckpt_dir=d, ckpt_every=2)
        assert ckpt.latest_step(d) == 2
        T.main(["--arch", ARCH, "--steps", "2", "--batch", "2", "--seq", "8",
                "--device", "cpu", "--ckpt-dir", d, "--microbatches", "2"])
    assert out["steps"] == 3 and out["restarts"] == 0
    assert [h["step"] for h in out["history"]] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert "[train] done: 2 steps" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.train(ARCH, steps=1)


def test_training_modules_import_neither_jax_nor_the_reference():
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    code = ("import sys\n"
            "import repro_torch.train.optimizer, repro_torch.train.data\n"
            "import repro_torch.train.train_step, repro_torch.launch.train\n"
            "import repro_torch.train.checkpoint, repro_torch.convert\n"
            "import repro_torch.train.fault_tolerance\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') "
            "or m.startswith(('jax.', 'jaxlib', 'repro.')))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
