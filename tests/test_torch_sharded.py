"""Training sharded over a mesh of ranks (the dense and moe families) on the
CPU: gloo ranks started by `tests/torch_sharded_ranks.py` in a child
process (a file:// store under the test's directory, one thread a rank),
held to the port's one-device runs, computed here, and through them to
the reference (`tests/test_torch_train.py` holds the port's one-device
step to the reference's `make_train_step`).

  * the reference's own mesh check (`tests/test_sharding.py`, which cannot
    run under jax 0.9.0): qwen2.5-3b's smoke config at float32 on a 2 x 4
    mesh of 8 ranks, one step, against the one-device step at its
    tolerances (loss rel 1e-4, max parameter difference 5e-4); two
    sharded runs bit-equal; checkpoints both ways;
  * the moe family on a 2 x 2 mesh of 4 ranks: the sharded `apply_moe`
    against the reference's `_apply_moe_local` on each data shard (the
    auxes averaged), its one-token global path, the whole step against
    the one-rank per-shard emulation (each data shard's rows of each
    microbatch a microbatch of their own), and the masters' and moments'
    bytes a rank against the dry-run's;
  * `launch.train.train` on the mesh with an injected failure, and the
    elastic re-mesh of the survivors of a lost rank.

The other four families on a mesh: `tests/test_torch_sharded_families.py`.

Two rank launches, each with a timeout of 120 s.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as rget_arch  # noqa: E402
from repro.configs import smoke_config as rsmoke  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch.configs import ShapeConfig, get_arch, smoke_config  # noqa
from repro_torch.convert import _load  # noqa: E402
from repro_torch.launch.dryrun import lower_cell  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.train_step import (init_train_state,  # noqa: E402
                                          make_train_step)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import torch_sharded_ranks as R  # noqa: E402

LAUNCH_TIMEOUT_S = 120
MOE_TOL = dict(atol=2e-4, rtol=2e-3)     # the model kernels' float32 one
LOSS_REL, PARAM_DIFF = 1e-4, 5e-4        # tests/test_sharding.py:113-114


def _launch(scenarios: str, out: Path, n: int) -> None:
    """Run the ranks in a child process; fail with its stderr's tail."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    try:
        r = subprocess.run([sys.executable, str(ROOT / "tests" /
                                                "torch_sharded_ranks.py"),
                            scenarios, str(out), str(n)], env=env, cwd=ROOT,
                           capture_output=True, text=True,
                           timeout=LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        pytest.fail(f"{scenarios} on {n} ranks: over {LAUNCH_TIMEOUT_S} s; "
                    f"stderr {str(e.stderr)[-3000:]}")
    assert r.returncode == 0, f"{scenarios}: {r.stderr[-4000:]}"


def _one_thread(fn):
    """fn() at one thread (the CPU's index backward adds in a
    thread-dependent order)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


def _one_device_steps(cfg, batches, microbatches=1):
    """Steps on one device from the seed-0 initial state."""
    def run():
        model = Model(cfg, device="cpu")
        state = init_train_state(model, torch.Generator().manual_seed(0),
                                 R.OPT)
        step = make_train_step(model, R.OPT, microbatches=microbatches)
        for b in batches:
            state, met = step(state, b)
        return state, met
    return _one_thread(run)


def _max_diff(a: dict, b: dict) -> float:
    return max(float((a[n] - b[n]).abs().max()) for n in a)


@pytest.fixture(scope="module")
def dense_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dense")
    cfg = R.config("qwen2.5-3b")
    state, met = _one_device_steps(cfg, [R.batch(cfg, 8)])
    ckpt.save(str(out / "ckpt_one"), 1, state)
    _launch("dense", out, 8)
    return {"out": out, "cfg": cfg, "state": state, "loss": met["loss"],
            "runs": torch.load(out / "dense.pt")}


def test_sharded_step_on_2x4_matches_one_device(dense_run):
    """The reference's `test_sharded_train_step_matches_single_device`,
    on ranks: loss rel 1e-4, max parameter difference 5e-4."""
    got = dense_run["runs"][0]
    assert got["loss"] == pytest.approx(dense_run["loss"], rel=LOSS_REL)
    assert _max_diff(got["params"], dense_run["state"].params) < PARAM_DIFF


def test_two_sharded_runs_are_bit_equal(dense_run):
    a, b = dense_run["runs"]
    assert a["loss"] == b["loss"]
    for key in ("params", "m", "v"):
        for n in a[key]:
            assert torch.equal(a[key][n], b[key][n]), (key, n)


def test_sharded_checkpoint_restores_on_one_device(dense_run):
    """The sharded save (gathered to rank 0) restored into a one-device
    state: bit-equal to the run's gathered state."""
    cfg, got = dense_run["cfg"], dense_run["runs"][1]
    model = Model(cfg, device="cpu")
    tmpl = init_train_state(model, torch.Generator().manual_seed(5), R.OPT)
    state, step = ckpt.restore(str(dense_run["out"] / "ckpt_sharded"), tmpl)
    assert step == 1 and state.step == 1 and state.opt["step"] == 1
    for n, p in state.params.items():
        assert torch.equal(p, got["params"][n]), n
        assert torch.equal(state.opt["m"][n], got["m"][n]), n
        assert torch.equal(state.opt["v"][n], got["v"][n]), n


def _piece(whole: torch.Tensor, spec, coords: dict, sizes: dict):
    """The piece of `whole` at `coords`, cut by hand: along each dimension
    named in `spec`, the index of the coordinates (row-major over a
    tuple of axes) times the piece's length."""
    for dim, ax in enumerate(spec):
        axes = () if ax is None else ax if isinstance(ax, tuple) else (ax,)
        idx, count = 0, 1
        for a in axes:
            idx, count = idx * sizes[a] + coords[a], count * sizes[a]
        n = whole.shape[dim] // count
        whole = whole[(slice(None),) * dim + (slice(idx * n, idx * n + n),)]
    return whole


def test_one_device_checkpoint_restores_into_each_ranks_pieces(dense_run):
    state, out = dense_run["state"], dense_run["out"]
    sizes = {"data": 2, "model": 4}
    mesh = S.Mesh(("data", "model"), (2, 4))
    with S.use_mesh(mesh):
        specs = S.param_pspec_tree(state.params)
    assert {tuple(s) for s in specs.values()} >= {("model", "data"),
                                                  ("data", "model")}
    covered = {n: 0 for n in state.params}
    for rank in range(8):
        got = torch.load(out / f"restored_{rank}.pt")
        assert got["step"] == 1 and got["opt_step"] == 1
        for n, p in state.params.items():
            want = _piece(p, specs[n], got["coords"], sizes)
            assert torch.equal(got["params"][n], want), (rank, n)
            assert torch.equal(got["m"][n], _piece(state.opt["m"][n],
                                                   specs[n], got["coords"],
                                                   sizes)), (rank, n)
            covered[n] += want.numel()
    for n, p in state.params.items():        # the pieces tile the whole
        assert covered[n] == p.numel() * 8 // S.shard_count(specs[n], mesh)


@pytest.fixture(scope="module")
def moe_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe")
    rc = rsmoke(rget_arch("granite-moe-3b-a800m")).with_(dtype="float32")
    cfg = R.config("granite-moe-3b-a800m")
    rp = RL.init_moe(jax.random.PRNGKey(3), rc)
    pp = L.MoE(cfg, "cpu")
    assert _load(pp, jax.tree.map(np.asarray, rp)) == 3
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    xd = rng.standard_normal((4, 1, cfg.d_model)).astype(np.float32)
    torch.save({"x": torch.from_numpy(x), "x_decode": torch.from_numpy(xd),
                "weights": {n: p.detach().clone()
                            for n, p in pp.named_parameters()}},
               out / "moe_in.pt")
    # the one-rank references; the elastic run's batches divide by 2 and 3.
    # The mesh's 2 microbatches over 2 data shards, per-shard routing
    # included: 4 microbatches, each one shard's rows routed alone
    step_state, step_met = _one_device_steps(cfg, [R.batch(cfg, 8)],
                                             microbatches=4)
    qcfg = R.config("qwen2.5-3b")
    el_state, el_met = _one_device_steps(qcfg, [R.batch(qcfg, 6, 0),
                                                R.batch(qcfg, 6, 1)])
    _launch("moe,recovery,elastic", out, 4)
    return {"out": out, "cfg": cfg, "rc": rc, "rp": rp, "pp": pp, "x": x,
            "xd": xd, "step": (step_state, step_met),
            "elastic_ref": (el_state, el_met),
            "res": torch.load(out / "moe.pt")}


def test_sharded_apply_moe_matches_reference_per_shard(moe_run):
    """Each data shard routed alone: the reference's `_apply_moe_local` on
    each shard of x in JAX, the auxes averaged."""
    rc, rp, x = moe_run["rc"], moe_run["rp"], moe_run["x"]
    ys, auxes = [], []
    for xs in np.split(x, 2):
        y, aux = RL._apply_moe_local(rp, jnp.asarray(xs), rc)
        ys.append(np.asarray(y))
        auxes.append(float(aux))
    y, aux = moe_run["res"]["x"]
    np.testing.assert_allclose(y.numpy(), np.concatenate(ys), **MOE_TOL)
    np.testing.assert_allclose(float(aux), np.mean(auxes), **MOE_TOL)
    # the global dispatch differs: capacity over every shard's tokens
    yg, _ = RL._apply_moe_local(rp, jnp.asarray(x), rc)
    assert not np.allclose(np.asarray(yg), y.numpy(), **MOE_TOL)


def test_sharded_moe_decode_takes_the_global_path(moe_run):
    """A one-token step with the experts dividing over "model": every data
    shard's tokens routed together, as on one device."""
    y, aux = moe_run["res"]["x_decode"]
    with torch.no_grad():
        want, want_aux = L.apply_moe(moe_run["pp"],
                                     torch.from_numpy(moe_run["xd"]),
                                     moe_run["cfg"])
    np.testing.assert_allclose(y.numpy(), want.numpy(), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **MOE_TOL)


def test_sharded_moe_step_matches_per_shard_emulation(moe_run):
    got = moe_run["res"]["step"]
    state, met = moe_run["step"]
    assert got["loss"] == pytest.approx(met["loss"], rel=LOSS_REL)
    assert _max_diff(got["params"], state.params) < PARAM_DIFF
    # against the global dispatch on one device the step differs
    glob, gmet = _one_device_steps(moe_run["cfg"],
                                   [R.batch(moe_run["cfg"], 8)],
                                   microbatches=2)
    assert gmet["loss"] != pytest.approx(got["loss"], rel=LOSS_REL)


def test_dryrun_bytes_match_the_ranks_masters_and_moments(moe_run):
    """`lower_cell` on the same (2, 2) mesh, 2-D sharding and ZeRO-2 (as
    the launcher runs): its per-device parameter and moment bytes are
    each rank's float32 masters' and moments', exactly."""
    cfg = moe_run["cfg"]
    mesh = S.Mesh(("data", "model"), (2, 2))
    shape = ShapeConfig("sharded", R.SEQ, 8, "train", microbatches=2)
    _, info = lower_cell(cfg.name, shape.name, mesh, cfg=cfg, shape=shape,
                         sharding_mode="2d", zero_stage=2, trace=False)
    mem = info["per_device_bytes"]
    for got in moe_run["res"]["bytes_by_rank"]:
        assert got == {"params": mem["params"],
                       "opt_moments": mem["opt_moments"]}


def test_recovery_under_the_mesh_is_bit_equal(moe_run):
    clean, healed = torch.load(moe_run["out"] / "recovery.pt")
    assert (clean["restarts"], healed["restarts"]) == (0, 1)
    assert clean["steps"] == healed["steps"] == 4
    for n, p in clean["params"].items():
        assert torch.equal(p, healed["params"][n]), n


def test_elastic_reshard_of_the_survivors_matches_one_device(moe_run):
    """4 ranks on (2, 2), one step; rank 3 lost; the survivors on (3, 1),
    re-sharded from the checkpoint, take the next step: the one-device
    run's second step."""
    got = torch.load(moe_run["out"] / "elastic.pt")
    state, met = moe_run["elastic_ref"]
    assert got["mesh"] == {"data": 3, "model": 1}
    assert got["loss"] == pytest.approx(met["loss"], rel=LOSS_REL)
    assert _max_diff(got["params"], state.params) < PARAM_DIFF


def test_local_slices_and_constrain_without_collectives():
    """`local_slice` against the pieces cut by hand, `constrain` slicing
    rows to "dp" on a mesh of ranks (no collective), and the heads and
    columns a model rank computes."""
    mesh = S.Mesh(("data", "model"), (2, 2), ranks=(0, 1, 2, 3), rank=2)
    assert mesh.coords == {"data": 1, "model": 0}
    w = torch.arange(8 * 6.).reshape(8, 6)
    for spec in (S.Spec("data", "model"), S.Spec(None, "model"),
                 S.Spec("model", None)):
        assert torch.equal(S.local_slice(w, spec, mesh),
                           _piece(w, spec, mesh.coords, mesh.shape))
    with S.use_mesh(mesh):
        assert torch.equal(S.constrain(w, "dp", None, src=(None, None)),
                           w[4:])
        assert S.constrain(w, "dp", None) is w
        with pytest.raises(ValueError, match="does not divide"):
            S.constrain(w[:1], "dp", None, src=(None, None))   # 1 row, 2
    cfg = smoke_config(get_arch("qwen2.5-3b"))        # 4 q, 2 kv heads
    assert [L.attention_heads(cfg, 4, m) for m in range(4)] == [
        (0, 1, 0, 1), (1, 1, 0, 1), (2, 1, 1, 1), (3, 1, 1, 1)]
    assert [L.attention_heads(cfg, 2, m) for m in range(2)] == [
        (0, 2, 0, 1), (2, 2, 1, 1)]
    hd = cfg.resolved_head_dim
    cols = L.qkv_columns(cfg, 4, 3)
    assert cols.tolist() == (list(range(3 * hd, 4 * hd))
                             + list(range(5 * hd, 6 * hd))
                             + list(range(7 * hd, 8 * hd)))


def test_named_sharding_tree_and_the_transport(monkeypatch):
    """Each parameter's entry on a mesh is its spec by the mesh's rules,
    even on it, and the transport follows the layout: gloo on the CPU,
    NCCL where each rank of the host has a card, gloo with staging where
    ranks share one."""
    from repro_torch.parallel import collectives as C
    cfg = smoke_config(get_arch("qwen2.5-3b"))
    model = Model(cfg, device="meta")
    mesh = S.Mesh(("data", "model"), (2, 2))
    with S.use_mesh(mesh):
        specs = S.param_pspec_tree(model)
    tree = S.named_sharding_tree(mesh, model)
    assert tree["embed"] == S.Spec("model", "data")
    assert tree["layers.0.attn.wqkv"] == S.Spec("data", "model")
    assert tree["ln_f"] == S.Spec(None)
    assert tree == specs
    odd = S.Mesh(("data", "model"), (3, 2))       # 3 does not divide 128
    assert S.named_sharding_tree(odd, model)["embed"] == S.Spec("model",
                                                                None)
    assert C.transport_for(torch.device("cpu"), 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert C.transport_for(torch.device("cuda", 0), 4) == "nccl"
    assert C.transport_for(torch.device("cuda", 0), 8) == "gloo+staging"
