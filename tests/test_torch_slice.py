"""The port's first slice as a whole: self-containment, explicit devices,
the on-card smoke script's refusal to run without a card, and the
scheduling path end to end against the reference at small size."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.sched import api as rapi  # noqa: E402
from repro_torch.obs import kernel_mode, run_meta  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_imports_neither_jax_nor_the_reference_package():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.convert, repro_torch.obs\n"
        "import repro_torch.core, repro_torch.sched, repro_torch.sim\n"
        "import repro_torch.kernels.grin_moves, repro_torch.train\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or\n"
        "             m.startswith(('jax.', 'jaxlib', 'repro.')))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_port_source_names_jax_or_reference_imports():
    files = sorted(PORT.rglob("*.py")) + [SMOKE]
    assert len(files) > 15
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, mod)


def test_kernel_sources_are_in_the_package():
    cu = PORT / "kernels" / "csrc" / "grin_moves.cu"
    text = cu.read_text()
    assert "extern \"C\" int grin_block_move_scores" in text
    assert "block_move_gains_pallas" in text       # names what it replaces
    from repro_torch.kernels import build, grin_moves
    assert grin_moves.SOURCES == ("grin_moves.cu",)
    assert "--fmad=false" in build.NVCC_FLAGS
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert any("sm_90a" in f for f in build.NVCC_FLAGS)


def test_smoke_refuses_to_run_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the smoke would run")
    out = subprocess.run([sys.executable, str(SMOKE)], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_smoke_refuses_to_run_alone(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(SMOKE.read_text())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _entry_points():
    from repro_torch.core import grin_solve_batch_torch, grin_solve_torch
    from repro_torch.sched import (BaselineClusterScheduler, SchedulerCore,
                                   solve_targets_grid_torch,
                                   solve_targets_torch)
    from repro_torch.sim import (SimConfig, compare_policies,
                                 make_distribution, simulate_batch,
                                 simulate_policy, sweep)
    mu = np.random.default_rng(0).uniform(1, 30, size=(3, 3))
    mixes = np.array([[4, 4, 4]])
    cfg = SimConfig(mu=mu, n_programs_per_type=mixes[0],
                    distribution=make_distribution("exponential"),
                    n_completions=20, warmup_completions=5)
    return {
        "SchedulerCore": lambda: SchedulerCore("grin", mu),
        "BaselineClusterScheduler": lambda: BaselineClusterScheduler(mu,
                                                                     "lb"),
        "solve_targets_torch": lambda: solve_targets_torch(mu, mixes),
        "solve_targets_grid_torch": lambda: solve_targets_grid_torch(
            mu[None], mixes),
        "grin_solve_batch_torch": lambda: grin_solve_batch_torch(mu, mixes),
        "grin_solve_torch": lambda: grin_solve_torch(mu, mixes[0]),
        "simulate_batch": lambda: simulate_batch(
            mu, np.zeros((1, 3, 3)), np.zeros((1, 3), np.int64), [0],
            distribution=cfg.distribution, n_completions=20,
            warmup_completions=5),
        "simulate_policy": lambda: simulate_policy(cfg, "grin"),
        "sweep": lambda: sweep(cfg, "lb"),
        "compare_policies": lambda: compare_policies(cfg, ["grin", "lb"]),
    }


@pytest.mark.parametrize("name", [
    "SchedulerCore", "BaselineClusterScheduler", "solve_targets_torch",
    "solve_targets_grid_torch", "grin_solve_batch_torch", "grin_solve_torch",
    "simulate_batch", "simulate_policy", "sweep", "compare_policies"])
def test_entry_point_without_device_raises_where_there_is_no_cuda(
        name, monkeypatch):
    call = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_resolve_device_and_meta():
    from repro_torch import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    assert kernel_mode("cpu") == "torch-reference"
    assert kernel_mode("cuda") == "cuda"
    meta = run_meta("cpu")
    assert meta["kernel_mode"] == "torch-reference"
    assert meta["torch_version"] == torch.__version__


def test_slice_end_to_end_against_reference():
    """Grid-solve, warm a core, route a burst and what-if on the port
    (CPU) and on the reference: identical targets and decisions."""
    from repro_torch.sched import SchedulerCore
    rng = np.random.default_rng(21)
    mu = rng.uniform(1, 30, size=(4, 6))
    mixes = np.array([rng.multinomial(400, p)
                      for p in rng.dirichlet([0.3] * 4, size=6)])
    port = SchedulerCore("grin-e", mu, device="cpu")
    ref = rapi.SchedulerCore("grin-e", mu)
    assert port.warm_targets(mixes) == ref.warm_targets(mixes) == 6
    for key, target in ref._targets.items():
        np.testing.assert_array_equal(port._targets[key], target)
    types = rng.integers(0, 4, size=300)
    for core in (port, ref):
        core.notify_type_counts(mixes[2])
    assert port.route_many(types).tolist() == ref.route_many(types).tolist()
    wp = port.elastic_what_if(mixes[:3])
    wr = ref.elastic_what_if(mixes[:3])
    np.testing.assert_allclose(wp["pool_lost"], wr["pool_lost"], rtol=1e-5)
    np.testing.assert_allclose(wp["base_energy"], wr["base_energy"],
                               rtol=1e-5)
