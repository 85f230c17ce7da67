"""The examples' counterparts on the PyTorch port (`examples/*_torch.py`),
run with `--device cpu` in a subprocess: each prints what the reference
example computes (quickstart: the affinity case, the CAB solution and the
GrIn gap; schedule_cluster: the roofline affinity matrix, the GrIn
placement and the batched targets' X per mix), computed here by the
reference package in-process. Without a card, each raises on its default
device."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]


def _run(name, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, str(ROOT / "examples" / name),
                           *args], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=300)


def test_quickstart_counterpart_prints_the_reference_solution():
    from repro.core import cab_solve, classify_2x2, exhaustive_solve, grin_solve
    out = _run("quickstart_torch.py", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    mu = np.array([[20.0, 15.0], [3.0, 8.0]])
    sol = cab_solve(mu, 10, 10)
    assert f"affinity case: {classify_2x2(mu).value}" in out.stdout
    assert (f"CAB policy={sol.policy}  S_max=(N11={sol.s_max[0]}, "
            f"N22={sol.s_max[1]})  X_max={sol.x_max:.2f} tasks/s"
            in out.stdout)
    mu3 = np.random.default_rng(0).uniform(1, 30, size=(3, 3))
    g = grin_solve(mu3, np.array([7, 6, 7]))
    _, xopt = exhaustive_solve(mu3, np.array([7, 6, 7]))
    assert f"GrIn on random 3x3: X={g.x_sys:.2f} vs exhaustive {xopt:.2f}" \
        in out.stdout
    rows = [ln.split() for ln in out.stdout.splitlines()
            if ln.split()[:1] in (["CAB"], ["RD"], ["BF"], ["LB"], ["JSQ"])
            and len(ln.split()) == 4]
    x = {r[0]: float(r[1]) for r in rows}
    assert len(x) == 5 and x["CAB"] == max(x.values())


def test_schedule_cluster_counterpart_prints_the_reference_placement():
    from repro.core import grin_solve
    from repro.sched import (ChipSpec, StepCost, affinity_from_roofline,
                             serving_step_costs, solve_targets_jax)
    out = _run("schedule_cluster_torch.py", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    pools = [(ChipSpec("tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
                       link_bw=50e9), 64),
             (ChipSpec("tpu-v5p-like", peak_flops=459e12, hbm_bw=2765e9,
                       link_bw=100e9), 16),
             (ChipSpec("tpu-v4-like", peak_flops=275e12, hbm_bw=1228e9,
                       link_bw=50e9), 32)]
    costs = serving_step_costs(n_params=7e9, seq_len=32768, batch=8)
    costs.append(StepCost("train_micro", flops=6 * 7e9 * 0.5e6,
                          hbm_bytes=6 * 7e9 * 4, collective_bytes=7e9 * 4))
    mu = affinity_from_roofline(costs, pools)
    for c, row in zip(costs, mu):
        assert f"  {c.name:12s} {np.round(row, 2)}" in out.stdout
    g = grin_solve(mu, np.array([12, 30, 6]))
    assert f"GrIn placement (rows=classes, cols=pools):\n{g.N}" in out.stdout
    mixes = np.array([[12, 30, 6], [8, 34, 6], [16, 26, 6], [12, 24, 12]])
    _, xs = solve_targets_jax(mu, mixes)
    line = next(ln for ln in out.stdout.splitlines()
                if ln.startswith("batched GrIn targets"))
    got = np.array(line.split("[")[1].rstrip("]").split(), dtype=float)
    np.testing.assert_allclose(got, np.round(np.asarray(xs), 1), atol=0.1)


@pytest.mark.parametrize("name", ["quickstart_torch.py",
                                  "schedule_cluster_torch.py",
                                  "serve_heterogeneous_torch.py",
                                  "train_lm_torch.py"])
def test_examples_need_the_card_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the example would run")
    out = _run(name)
    assert out.returncode != 0 and "device='cpu'" in out.stderr
