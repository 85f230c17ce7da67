"""Port parity: time-resolved telemetry (`repro_torch.obs.telemetry`).

`TelemetryAccumulator` and `telemetry_series` are the reference's op for
op; the host open loop's telemetry series (`run_open(...,
telemetry=n_bins)`) equals the reference's bit for bit; the open engine's
four binned integrals follow the same start-bin convention, so they agree
with the host series statistically, add up to the engine's own window
integrals, and leave every other result of the run unchanged."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.sched  # noqa: E402,F401  (import order: sched before sim)
from repro.obs.telemetry import TelemetryAccumulator as RAcc  # noqa: E402
from repro.obs.telemetry import telemetry_series as rseries  # noqa: E402
from repro.sched import get_policy as rget  # noqa: E402
from repro.sim import ClosedNetworkSimulator as RSim  # noqa: E402
from repro.sim import make_distribution as rdist  # noqa: E402
from repro.traffic import PoissonArrivals as RPA  # noqa: E402
from repro.traffic import TrafficSpec as RTS  # noqa: E402
from repro.traffic.config import open_sim_config as ropen  # noqa: E402
from repro.traffic.host import run_open as rrun_open  # noqa: E402
from repro_torch.obs import TelemetryAccumulator, telemetry_series  # noqa
from repro_torch.sched import as_core  # noqa: E402
from repro_torch.sim import ClosedNetworkSimulator  # noqa: E402
from repro_torch.sim import make_distribution  # noqa: E402
from repro_torch.traffic import (PoissonArrivals, TrafficSpec,  # noqa: E402
                                 open_sim_config, run_open,
                                 simulate_open_batch, simulate_open_policy)

MU = np.array([[8.0, 2.0, 3.0], [2.0, 6.0, 4.0]])
KEYS = ("occupancy", "backlog", "power", "hedges")


def test_accumulator_and_series_match_the_reference():
    rng = np.random.default_rng(2)
    r, p = RAcc(12, 30.0, 3), TelemetryAccumulator(12, 30.0, 3)
    t = 0.0
    for _ in range(200):
        dt = float(rng.exponential(0.2))
        args = (t, dt, rng.integers(0, 5, 3), rng.uniform(0, 3, 3),
                float(rng.uniform()), float(rng.integers(0, 2)))
        r.add(*args)
        p.add(*args)
        t += dt
    rs, ps = r.series(), p.series()
    for k in KEYS:
        np.testing.assert_array_equal(rs[k], ps[k])
    rt, pt = rseries(rs), telemetry_series(ps)
    for k in KEYS:
        np.testing.assert_array_equal(rt[k], pt[k])
    batched = {k: np.stack([ps[k], 2 * ps[k]]) for k in KEYS}
    batched.update(bin_width=np.array([2.5, 2.5]), horizon=np.array([30.0,
                                                                      30.0]))
    np.testing.assert_array_equal(telemetry_series(batched)["power"][1],
                                  2 * pt["power"])
    with pytest.raises(ValueError):
        TelemetryAccumulator(0, 1.0, 2)


def _cfgs(order, n=1200, seed=4):
    kw = dict(n_arrivals=n, warmup_arrivals=n // 10, queue_capacity=5,
              class_of_type=[0, 1], target_mix=np.array([5, 10]),
              order=order, seed=seed)
    rc = ropen(MU, RTS((RPA(3.0), RPA(8.0)), np.eye(2)),
               distribution=rdist("exponential"), **kw)
    pc = open_sim_config(MU, TrafficSpec(
        (PoissonArrivals(3.0), PoissonArrivals(8.0)), np.eye(2)),
        distribution=make_distribution("exponential"), **kw)
    return rc, pc


@pytest.mark.parametrize("policy,order", [("grin", "PS"), ("lb", "FCFS"),
                                          ("jsq", "PRIO")])
def test_host_open_loop_telemetry_is_bit_equal(policy, order):
    rc, pc = _cfgs(order)
    rsim, psim = RSim(rc), ClosedNetworkSimulator(pc, device="cpu")
    r = rrun_open(rsim, repro.sched.as_core(rget(policy), rsim.mu),
                  telemetry=20)
    p = run_open(psim, as_core(policy, psim.mu, device="cpu"), telemetry=20)
    for k in (*KEYS, "bin_width", "horizon"):
        np.testing.assert_array_equal(np.asarray(r.telemetry[k]),
                                      np.asarray(p.telemetry[k]), err_msg=k)
    assert p.throughput == r.throughput


def test_engine_telemetry_follows_the_host_convention():
    rc, pc = _cfgs("PS", n=1000)
    nb = 8
    host = run_open(ClosedNetworkSimulator(pc, device="cpu"),
                    as_core("grin", MU, device="cpu"), telemetry=nb)
    dev = simulate_open_policy(pc, "grin", device="cpu", telemetry_bins=nb)
    plain = simulate_open_policy(pc, "grin", device="cpu")
    # telemetry changes nothing else in the run
    for f in ("throughput", "mean_response_time", "dropped",
              "class_quantiles", "state_occupancy", "mean_power"):
        np.testing.assert_array_equal(np.asarray(getattr(dev, f)),
                                      np.asarray(getattr(plain, f)))
    tel = dev.telemetry
    assert tel["occupancy"].shape == (nb, 3) and tel["power"].shape == (nb,)
    assert tel["horizon"] == host.telemetry["horizon"]
    assert not tel["hedges"].any()
    # binned time averages agree with the host series (different size
    # streams: statistical, per-bin populations of a few tasks)
    ds, hs = telemetry_series(tel), telemetry_series(host.telemetry)
    for k in ("occupancy", "power"):
        d, h = ds[k].sum(axis=-1) if ds[k].ndim > 1 else ds[k], \
            hs[k].sum(axis=-1) if hs[k].ndim > 1 else hs[k]
        assert abs(d.mean() - h.mean()) < 0.15 * h.mean(), k
    # the bins add up to the engine's window integrals (after warmup)
    t_warm = pc.traffic.spec.sample(pc.seed, 1000)[0][99]
    w = tel["bin_width"]
    b0 = int(t_warm // w)
    occ_tail = tel["occupancy"][b0 + 1:].sum()
    occ_window = dev.state_occupancy.sum() * dev.elapsed
    assert occ_tail <= occ_window * (1 + 1e-5)
    assert occ_window <= (occ_tail + tel["occupancy"][b0].sum()) * (1 + 1e-5)


def test_engine_telemetry_counts_hedged_copies():
    from repro_torch.faults import FaultScenario, build_fault_batch
    spec = TrafficSpec((PoissonArrivals(3.0), PoissonArrivals(8.0)),
                       np.eye(2))
    times, tys = spec.sample(1, 400)
    tgt = np.zeros((1, 2, 3), np.int64)
    fb = build_fault_batch([FaultScenario(hedge_classes=(0,))], MU, tgt,
                           seeds=[1], mode="open", n_arrivals=400,
                           n_classes=2, device="cpu")
    out = simulate_open_batch(
        MU, tgt, times[None], tys[None], [1],
        distribution=make_distribution("exponential"), queue_capacity=5,
        modes=[1], class_of_type=[0, 1], faults=fb, telemetry_bins=4,
        device="cpu")
    assert (out["telemetry"]["hedges"] > 0).all()
    assert out["telemetry"]["hedges"].shape == (1, 4)
