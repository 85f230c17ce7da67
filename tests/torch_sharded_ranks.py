"""Rank programs of `tests/test_torch_sharded.py` and
`tests/test_torch_sharded_families.py`.

    python tests/torch_sharded_ranks.py SCENARIO OUT N

starts N ranks (forked processes, one thread each, gloo over a file://
store under OUT) that each run SCENARIO on the CPU and write what the test
reads under OUT (rank 0 writes the whole tensors, gathered; each rank its
own pieces where a test reads them). Exits non-zero if a rank fails. The
test computes the one-device references itself and writes their inputs
under OUT first. Imports nothing of JAX.
"""
from __future__ import annotations

import sys
import traceback
import types
from pathlib import Path

import torch
import torch.multiprocessing as mp
from torch import nn

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh, mesh_over_ranks  # noqa
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import Model, compute_views  # noqa: E402
from repro_torch.parallel import collectives as C  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.data import DataConfig, batch_for_step  # noqa: E402
from repro_torch.train.fault_tolerance import ElasticMeshManager  # noqa
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         init_opt_state)
from repro_torch.train.train_step import (TrainState,  # noqa: E402
                                          init_train_state, make_train_step)

SEQ = 32
OPT = OptimizerConfig(warmup_steps=1, decay_steps=10)


def config(arch: str):
    """The arch's smoke config at float32 (the reference test's)."""
    return smoke_config(get_arch(arch)).with_(dtype="float32")


def batch(cfg, rows: int, index: int = 0) -> dict:
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                    global_batch=rows, n_codebooks=cfg.n_codebooks,
                    n_patches=cfg.n_patches, d_model=cfg.d_model)
    return {k: torch.from_numpy(v) for k, v in
            batch_for_step(dc, index).items()}


def sharded_steps(cfg, mesh, batches, microbatches=1) -> TrainState:
    """Steps on `mesh` from the seed-0 initial state, one a batch."""
    model = Model(cfg, device="meta")
    state = init_train_state(model, torch.Generator().manual_seed(0), OPT,
                             mesh=mesh)
    step = make_train_step(model, OPT, microbatches=microbatches)
    for b in batches:
        state, met = step(state, b)
    state.metrics = met
    return state


def whole(state: TrainState) -> dict:
    """{"params", "m", "v", "loss"} gathered whole (a collective)."""
    sh, mesh = state.shapes, state.mesh
    return {"params": S.gather_params(state.params, sh, mesh),
            "m": S.gather_params(state.opt["m"], sh, mesh),
            "v": S.gather_params(state.opt["v"], sh, mesh),
            "loss": state.metrics["loss"]}


def dense(rank: int, out: Path) -> None:
    """qwen2.5-3b's smoke config at float32 on a 2 x 4 mesh: one step
    twice from the same seed (the second for bit-equality), a sharded
    checkpoint of it, and the restore of the test's one-device
    checkpoint into this rank's pieces."""
    cfg = config("qwen2.5-3b")
    mesh = mesh_over_ranks(range(8), ("data", "model"), (2, 4))
    b = batch(cfg, 8)
    runs = []
    with S.use_mesh(mesh):
        for _ in range(2):
            state = sharded_steps(cfg, mesh, [b])
            runs.append(whole(state))
        ckpt.save(str(out / "ckpt_sharded"), 1, state)
        template = init_train_state(Model(cfg, device="meta"),
                                    torch.Generator().manual_seed(1), OPT,
                                    mesh=mesh)
        restored, step = ckpt.restore(str(out / "ckpt_one"), template)
    torch.save({"coords": mesh.coords, "step": step,
                "params": restored.params, "m": restored.opt["m"],
                "opt_step": restored.opt["step"]},
               out / f"restored_{rank}.pt")
    if rank == 0:
        torch.save(runs, out / "dense.pt")


def moe(rank: int, out: Path) -> None:
    """granite-moe-3b-a800m's smoke config at float32 on a 2 x 2 mesh: the
    sharded `apply_moe` (per-shard dispatch; and a one-token step, the
    global path) on the test's x and weights; a sharded step against the
    per-shard emulation; the masters' and moments' bytes a rank."""
    cfg = config("granite-moe-3b-a800m")
    mesh = make_debug_mesh()
    assert mesh.shape == {"data": 2, "model": 2}, mesh.shape
    inp = torch.load(out / "moe_in.pt")
    p = L.MoE(cfg, "cpu")
    with torch.no_grad():
        for n, t in inp["weights"].items():
            getattr(p, n).copy_(t)
    res = {}
    with S.use_mesh(mesh):
        for key in ("x", "x_decode"):
            x = S.constrain(inp[key], "dp", None, None,
                            src=(None, None, None))
            y, aux = L.apply_moe(p, x, cfg)
            res[key] = (C.all_gather(y, mesh, "data", 0), aux)
        state = sharded_steps(cfg, mesh, [batch(cfg, 8)], microbatches=2)
        res["step"] = whole(state)
    res["bytes"] = {
        "params": sum(t.numel() * t.element_size()
                      for t in state.params.values()),
        "opt_moments": sum(t.numel() * t.element_size()
                           for k in ("m", "v")
                           for t in state.opt[k].values())}
    by_rank = C.all_gather_object(res.pop("bytes"), mesh)
    if rank == 0:
        res["bytes_by_rank"] = by_rank
        torch.save(res, out / "moe.pt")


def recovery(rank: int, out: Path) -> None:
    """`launch.train.train` on a 2 x 2 mesh: an uninterrupted run and one
    with a failure injected at the same call on every rank."""
    kw = dict(steps=4, batch=4, seq=SEQ, microbatches=2, smoke=True,
              ckpt_every=2, device="cpu", log=lambda *a: None,
              opt=OptimizerConfig(warmup_steps=1, decay_steps=4))
    calls = {"n": 0}

    def flaky(step_fn):
        def run(s, b):
            calls["n"] += 1
            if calls["n"] == 3:
                raise RuntimeError("injected node failure")
            return step_fn(s, b)
        return run
    runs = []
    for i, wrap in enumerate((None, flaky)):
        r = T.train("qwen2.5-3b", ckpt_dir=str(out / f"rec_{i}"),
                    step_wrapper=wrap, **kw)
        st = r["state"]
        runs.append({"params": S.gather_params(st.params, st.shapes,
                                               st.mesh),
                     "restarts": r["restarts"], "steps": r["steps"]})
    if rank == 0:
        torch.save(runs, out / "recovery.pt")


def elastic(rank: int, out: Path) -> None:
    """qwen2.5-3b's smoke config at float32: a step on a 2 x 2 mesh of 4
    ranks and its checkpoint; then rank 3 is lost, and the survivors
    (the provider's live ranks) re-mesh to (3, 1), re-shard the
    checkpointed state onto it and take the next step."""
    cfg = config("qwen2.5-3b")
    mesh = make_debug_mesh()
    b1, b2 = batch(cfg, 6, 0), batch(cfg, 6, 1)
    with S.use_mesh(mesh):
        state = sharded_steps(cfg, mesh, [b1])
        ckpt.save(str(out / "ckpt_elastic"), 1, state)
        ckpt.barrier(state)
    if rank == 3:
        return                          # lost: takes no further part
    mgr = ElasticMeshManager(("data", "model"),
                             device_provider=lambda: [0, 1, 2])
    new = mgr.current_mesh()
    shapes = state.shapes
    whole_tmpl = TrainState(
        {n: torch.zeros(s) for n, s in shapes.items()},
        {"m": {n: torch.zeros(s) for n, s in shapes.items()},
         "v": {n: torch.zeros(s) for n, s in shapes.items()}, "step": 0}, 0)
    loaded, _ = ckpt.restore(str(out / "ckpt_elastic"), whole_tmpl)
    with S.use_mesh(new):
        specs = S.param_pspec_tree(shapes)
        tree = {"params": loaded.params, "m": loaded.opt["m"],
                "v": loaded.opt["v"]}
        placed = mgr.reshard(tree, {k: specs for k in tree}, new)
        state = TrainState(placed["params"],
                           {"m": placed["m"], "v": placed["v"],
                            "step": loaded.opt["step"]}, loaded.step,
                           new, shapes)
        model = Model(cfg, device="meta")
        state, met = make_train_step(model, OPT)(state, b2)
        params = S.gather_params(state.params, shapes, new)
    if rank == 0:
        torch.save({"mesh": new.shape, "params": params,
                    "loss": met["loss"]}, out / "elastic.pt")


# the four families of `tests/test_torch_sharded_families.py`, and the
# blocks each holds to the reference's layer function
FAMILY_ARCHS = ("musicgen-medium", "phi-3-vision-4.2b", "zamba2-7b",
                "xlstm-1.3b")
FAMILY_BLOCKS = {"zamba2-7b": ("mamba",), "xlstm-1.3b": ("mlstm", "slstm")}
FAMILY_MICRO = 2


def rank_pieces(cfg, whole: dict, mesh) -> dict:
    """This rank's compute-copy pieces of the `whole` tensors (named as
    the model's parameters), cut from them directly: the TP-only pieces of
    `compute_param_specs`, or the `compute_views` columns."""
    shapes = {n: tuple(t.shape) for n, t in whole.items()}
    with S.use_mesh(mesh):
        cspecs = S.compute_param_specs(shapes)
    views = compute_views(cfg, shapes, mesh)
    out = {}
    for n, t in whole.items():
        kind, dim, idx = views.get(n, (None, None, None))
        out[n] = (t.index_select(dim, idx) if kind == "columns"
                  else t if kind == "whole"
                  else S.local_slice(t, cspecs[n], mesh).clone())
    return out


def install(model, tensors: dict):
    """`model` holding `tensors` (its parameters' names) as its parameters,
    whatever their shapes."""
    for n, t in tensors.items():
        owner, _, leaf = n.rpartition(".")
        setattr(model.get_submodule(owner) if owner else model, leaf,
                nn.Parameter(t, requires_grad=False))
    return model


def state_from_whole(whole: dict, mesh) -> TrainState:
    """A fresh train state on `mesh` whose masters are this rank's pieces
    of the `whole` parameters."""
    shapes = {n: tuple(t.shape) for n, t in whole.items()}
    with S.use_mesh(mesh):
        specs = S.param_pspec_tree(shapes)
    params = {n: S.local_slice(t, specs[n], mesh).clone()
              for n, t in whole.items()}
    return TrainState(params, init_opt_state(params, OPT), 0, mesh, shapes)


def _shard_rows(x, mesh):
    """This data rank's rows of x (the whole batch on every rank)."""
    return S.constrain(x, "dp", *[None] * (x.dim() - 1),
                       src=(None,) * x.dim())


def _rows_whole(y, mesh):
    return C.all_gather(y, mesh, "data", 0)


def families(rank: int, out: Path) -> None:
    """The audio, vlm, hybrid and ssm families' smoke configs at float32 on
    a 2 x 2 mesh, from the test's inputs (`families_in.pt`: the
    reference's parameters carried across, a batch, layer inputs): for
    each, one sharded step (its loss, the masters' gradients gathered,
    the masters after it), its masters' and moments' bytes a rank; each
    Mamba2, mLSTM and sLSTM block on this rank's heads or channels (and
    Mamba2's with its norm's sum over "model" left out: the control); the
    audio and vlm embedding and head on this rank's pieces; zamba2's
    state checkpointed (gathered)."""
    mesh = make_debug_mesh()
    assert mesh.shape == {"data": 2, "model": 2}, mesh.shape
    inp = torch.load(out / "families_in.pt")
    res = {}
    for arch in FAMILY_ARCHS:
        cfg, got = config(arch), {}
        case = inp[arch]
        with S.use_mesh(mesh):
            state = state_from_whole(case["params"], mesh)
            grads = {}
            model = Model(cfg, device="meta")
            state, met = make_train_step(
                model, OPT, microbatches=FAMILY_MICRO,
                grad_hook=grads.update)(state, case["batch"])
            got["loss"] = met["loss"]
            got["grads"] = S.gather_params(grads, state.shapes, mesh)
            got["params"] = S.gather_params(state.params, state.shapes, mesh)
            if arch == "zamba2-7b":
                ckpt.save(str(out / "ckpt_hybrid"), 1, state)
                got["m"] = S.gather_params(state.opt["m"], state.shapes,
                                           mesh)
            for blk in FAMILY_BLOCKS.get(arch, ()):
                w = rank_pieces(cfg, {f"{blk}.0.{blk}.{n}": t for n, t in
                                      case[blk]["weights"].items()}, mesh)
                p = types.SimpleNamespace(**{n.rsplit(".", 1)[1]: t
                                             for n, t in w.items()})
                fn = getattr(L, f"apply_{blk}")
                x = _shard_rows(case[blk]["x"], mesh)
                with torch.no_grad():
                    got[blk] = _rows_whole(fn(p, x, cfg)[0], mesh)
                    if blk == "mamba":
                        real = L.norm_sum_over_model
                        L.norm_sum_over_model = lambda ss: ss
                        try:
                            got["mamba_control"] = _rows_whole(
                                fn(p, x, cfg)[0], mesh)
                        finally:
                            L.norm_sum_over_model = real
            if cfg.family in ("audio", "vlm"):
                pm = install(Model(cfg, device="cpu"),
                             rank_pieces(cfg, case["params"], mesh))
                with torch.no_grad():
                    got["embed"] = _rows_whole(pm._embed(
                        {k: _shard_rows(v, mesh) for k, v in
                         case["batch"].items() if k != "targets"}), mesh)
                    got["head"] = _rows_whole(pm._head(
                        _shard_rows(case["head_x"], mesh)), mesh)
        mine = {"params": sum(t.numel() * t.element_size()
                              for t in state.params.values()),
                "opt_moments": sum(t.numel() * t.element_size()
                                   for k in ("m", "v")
                                   for t in state.opt[k].values())}
        got["bytes_by_rank"] = C.all_gather_object(mine, mesh)
        res[arch] = got
    if rank == 0:
        torch.save(res, out / "families.pt")


def recovery_hybrid(rank: int, out: Path) -> None:
    """`launch.train.train` of zamba2-7b's smoke config on a 2 x 2 mesh,
    uninterrupted and with a failure injected at the same call on every
    rank: the recovery scenario for the hybrid family."""
    kw = dict(steps=3, batch=4, seq=SEQ, microbatches=2, smoke=True,
              ckpt_every=2, device="cpu", log=lambda *a: None,
              opt=OptimizerConfig(warmup_steps=1, decay_steps=3))
    calls = {"n": 0}

    def flaky(step_fn):
        def run(s, b):
            calls["n"] += 1
            if calls["n"] == 3:
                raise RuntimeError("injected node failure")
            return step_fn(s, b)
        return run
    runs = []
    for i, wrap in enumerate((None, flaky)):
        r = T.train("zamba2-7b", ckpt_dir=str(out / f"rec_hybrid_{i}"),
                    step_wrapper=wrap, **kw)
        st = r["state"]
        runs.append({"params": S.gather_params(st.params, st.shapes,
                                               st.mesh),
                     "restarts": r["restarts"], "steps": r["steps"],
                     "mesh": st.mesh.shape})
    if rank == 0:
        torch.save(runs, out / "recovery_hybrid.pt")


SCENARIOS = {"dense": dense, "moe": moe, "recovery": recovery,
             "elastic": elastic, "families": families,
             "recovery_hybrid": recovery_hybrid}


def _rank(rank: int, scenarios: list, out: str, n: int) -> None:
    torch.set_num_threads(1)
    C.init_world("cpu", init_method=f"file://{out}/store", rank=rank,
                 world_size=n, log=lambda *a: None)
    try:
        for name in scenarios:
            SCENARIOS[name](rank, Path(out))
    except Exception:
        traceback.print_exc()
        raise
    finally:
        C.leave_world()


def main() -> int:
    scenarios, out, n = sys.argv[1].split(","), sys.argv[2], int(sys.argv[3])
    mp.start_processes(_rank, args=(scenarios, out, n), nprocs=n,
                       start_method="fork")
    return 0


if __name__ == "__main__":
    sys.exit(main())
