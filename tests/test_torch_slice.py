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
        "import repro_torch.configs, repro_torch.kernels.ops\n"
        "import repro_torch.kernels.ref, repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.ssd_scan, repro_torch.kernels.rmsnorm\n"
        "import repro_torch.models.attention, repro_torch.models.linear_scan\n"
        "import repro_torch.models.layers, repro_torch.models.model\n"
        "import repro_torch.serve.engine, repro_torch.sched.virtual\n"
        "import repro_torch.launch.serve, repro_torch.faults.hazard\n"
        "import repro_torch.traffic.replay, repro_torch.traffic.loadgen\n"
        "import repro_torch.sched.autoscale, repro_torch.sched.cluster\n"
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


def test_fused_solve_source_is_in_the_package():
    """The fused GrIn solve is a second entry point of the scorer's source,
    built with the same flags, and names the loop it replaces."""
    text = (PORT / "kernels" / "csrc" / "grin_moves.cu").read_text()
    assert 'extern "C" int grin_block_solve' in text
    assert "_grin_block_core" in text and "lax.while_loop" in text
    assert "cudaGetLastError" in text
    from repro_torch.kernels import grin_moves
    assert set(grin_moves.launches) == {"block_move_gains", "grin_solve"}
    assert callable(grin_moves.grin_block_solve_cuda)


def test_smoke_solve_bound_counts_the_steps_taken():
    """The fused solve's bound counts operations over the steps these
    inputs took, and bytes read and written once."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    b1 = smoke.solve_bound(4096, 4, 6, 14, 0, 1_000_000)
    b2 = smoke.solve_bound(4096, 4, 6, 14, 0, 2_000_000)
    assert b2[3] == 2 * b1[3] and b1[2] == b2[2]
    assert b1[3] == 1_000_000 * ((4 * 36 + 14) * 11 + 3 * 24 * 2)
    assert b1[2] == 4 * (4096 * 24 * 2 + 14) + 4 * 4096 * 24 + 8 * 4096
    assert b2[1] == "operations" and b2[0] > b1[0]
    energy = smoke.solve_bound(4096, 4, 6, 14, 1, 1_000_000)
    assert energy[3] > b1[3] and energy[2] > b1[2]


@pytest.mark.parametrize("dv", [64, 1])
def test_smoke_wide_check_sees_a_cut_carry_at_slow_decay(dv):
    """The smoke's wide-kernel check, run here with the plain version as
    the scan (chunk 32, 8 chunks). It passes the plain version at both
    forget biases. The plain version with its carry over chunks cut to one
    chunk (a carry that drops its exp(lt) * S_in term) passes at fast
    decay, where that term is e^-26 of the state, and fails at slow decay,
    where the check reports it as a fault."""
    import importlib.util
    from repro_torch.models.linear_scan import linear_scan_chunked
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    slow = smoke.SLOW_FORGET_BIAS
    shape = (torch.device("cpu"), 5, 1, 256, 2, 64, dv, 32)
    sound = smoke.check_wide_ssd(*shape, linear_scan_chunked)
    assert all(r["ok"] for r in sound.values())
    assert smoke.wide_ssd_faults(sound) == []
    assert sound[0.0]["cut_carry_ok"] and not sound[slow]["cut_carry_ok"]
    cut = smoke.check_wide_ssd(*shape, smoke.scan_cut_carry)
    assert cut[0.0]["ok"] and not cut[slow]["ok"]
    assert smoke.wide_ssd_faults(cut)


@pytest.mark.parametrize("name,entry,replaces,counters", [
    ("flash_attention", "flash_attention_fwd", "flash_attention_pallas",
     {"flash_attention", "flash_attention_bwd"}),
    ("ssd_scan", "ssd_scan_fwd", "ssd_scan_pallas", {"ssd_scan"}),
    ("ssd_scan_wide", "ssd_scan_wide_fwd", "ssd_scan_pallas",
     {"ssd_scan_wide", "mlstm_scan"}),
    ("rmsnorm", "rmsnorm_fwd", "rmsnorm_pallas", {"rmsnorm"})])
def test_model_kernel_sources_are_in_the_package(name, entry, replaces,
                                                 counters):
    import importlib
    text = (PORT / "kernels" / "csrc" / f"{name}.cu").read_text()
    assert f'extern "C" int {entry}' in text
    assert replaces in text                         # names what it replaces
    assert "cudaGetLastError" in text
    mod = importlib.import_module(f"repro_torch.kernels.{name}")
    from repro_torch.kernels import build
    assert mod.SOURCES == (f"{name}.cu",)
    assert set(mod.launches) == counters       # one per wrapper
    assert any("sm_90a" in f for f in build.MODEL_NVCC_FLAGS)
    assert "--use_fast_math" not in build.MODEL_NVCC_FLAGS


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
    from repro_torch.faults import (completion_forecast_torch,
                                    expected_completion_exp_torch)
    from repro_torch.sched import (AutoscaleGovernor,
                                   BaselineClusterScheduler,
                                   ClusterScheduler, SchedulerCore,
                                   price_frequency_grid,
                                   solve_targets_grid_torch,
                                   solve_targets_torch)
    from repro_torch.core import DVFSModel
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.convert import model_params_from_reference
    from repro_torch.models.model import Model
    from repro_torch.sched.virtual import VirtualTimeCluster
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
        "Model": lambda: Model(smoke_config(get_arch("yi-6b"))),
        "model_params_from_reference": lambda: model_params_from_reference(
            smoke_config(get_arch("zamba2-7b")), {}),
        "VirtualTimeCluster.run_closed": lambda: VirtualTimeCluster(
            [{0: lambda s: 1.0}], measure_real=False).run_closed(
                "lb", [0], n_completions=2, warmup=1, mu=np.ones((1, 1))),
        "ClusterScheduler": lambda: ClusterScheduler(mu, "grin"),
        "AutoscaleGovernor": lambda: AutoscaleGovernor(mu),
        "price_frequency_grid": lambda: price_frequency_grid(
            mu, mu, np.ones((1, 3)), mixes, DVFSModel()),
        "completion_forecast_torch": lambda: completion_forecast_torch(
            [0.0], 1.0, 2.0, 1.5, 0.1),
        "expected_completion_exp_torch": lambda:
            expected_completion_exp_torch([1.0], 0.5, 0.1),
    }


@pytest.mark.parametrize("name", [
    "SchedulerCore", "BaselineClusterScheduler", "solve_targets_torch",
    "solve_targets_grid_torch", "grin_solve_batch_torch", "grin_solve_torch",
    "simulate_batch", "simulate_policy", "sweep", "compare_policies",
    "Model", "model_params_from_reference", "VirtualTimeCluster.run_closed",
    "ClusterScheduler", "AutoscaleGovernor", "price_frequency_grid",
    "completion_forecast_torch", "expected_completion_exp_torch"])
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
