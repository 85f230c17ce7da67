"""The port's sharding layer (`repro_torch.parallel.sharding`), meshes
(`launch.mesh`), per-cell knobs (`launch.shapes`) and `ElasticMeshManager`
against the reference's, on the CPU with no devices: the reference is
called on fake mesh objects that carry `shape` and `axis_names`, as
`tests/test_sharding.py` does, and with `jax.make_mesh` stubbed to return
its shape where a mesh would be built.

Specs are compared as tuples, the reference's with its leading stack
(layer) axes stripped: the port's layers are a module list, not a stacked
leading axis. Parameters pair through `convert.reference_arrays`' naming.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as RC  # noqa: E402
from repro.launch import mesh as RM  # noqa: E402
from repro.launch import shapes as RS  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.parallel import sharding as RSH  # noqa: E402
from repro.train import fault_tolerance as RFT  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.convert import reference_arrays  # noqa: E402
from repro_torch.launch import mesh as PM  # noqa: E402
from repro_torch.launch import shapes as PS  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.parallel import sharding as PSH  # noqa: E402
from repro_torch.train import fault_tolerance as PFT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


class _FakeMesh:
    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16))}
RULES = {"single": ("RULES_SINGLE_POD", "RULES_PURE_DP_SINGLE",
                    "RULES_PREFILL_SINGLE"),
         "multi": ("RULES_MULTI_POD", "RULES_PURE_DP_MULTI",
                   "RULES_PREFILL_MULTI")}


def _fake(kind):
    return _FakeMesh(*MESHES[kind])


def _port_mesh(kind):
    return PSH.Mesh(*MESHES[kind])


@functools.lru_cache(maxsize=None)
def _ref_param_shapes(arch):
    m = build_model(RC.get_arch(arch))
    return jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0)))


def _paired(arch, ref_tree):
    """{port parameter name: (reference leaf's spec, rank)}: each port
    parameter paired with the reference leaf it is cut from, found by
    feeding `reference_arrays` zero-stride arrays that carry their leaf's
    number."""
    leaves, treedef = jax.tree_util.tree_flatten(
        ref_tree, is_leaf=lambda x: isinstance(x, P))
    shapes = jax.tree_util.tree_leaves(_ref_param_shapes(arch))
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.broadcast_to(np.int64(i), s.shape)
                  for i, s in enumerate(shapes)])
    model = Model(PC.get_arch(arch), device="meta")
    out = {}
    for name, arr in reference_arrays(model, tagged).items():
        i = int(np.asarray(arr).flat[0])
        out[name] = (leaves[i], len(shapes[i].shape))
    return model, out


def _strip(spec, ref_ndim, ndim):
    """The reference's spec without its leading stack axes (which must be
    unsharded)."""
    t = tuple(spec) + (None,) * (ref_ndim - len(tuple(spec)))
    lead = ref_ndim - ndim
    assert all(a is None for a in t[:lead]), t
    return t[lead:]


@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("arch", sorted(RC.ARCHS))
def test_param_specs_match_reference(arch, kind):
    """Every parameter's spec, under each of the mesh kind's three rule
    tables, by `param_pspec_tree` and `compute_param_specs`, with
    non-dividing axes dropped on the production shape."""
    shapes = _ref_param_shapes(arch)
    fake, mesh = _fake(kind), _port_mesh(kind)
    for rules in RULES[kind]:
        for fn in ("param_pspec_tree", "compute_param_specs"):
            with RSH.use_mesh(None, getattr(RSH, rules)):
                ref = getattr(RSH, fn)(shapes, fake)
            model, pairs = _paired(arch, ref)
            with PSH.use_mesh(None, getattr(PSH, rules)):
                port = getattr(PSH, fn)(model, mesh)
            assert sorted(port) == sorted(pairs)
            for name, spec in port.items():
                rspec, rdim = pairs[name]
                ndim = len(model.get_parameter(name).shape)
                assert tuple(spec) == _strip(rspec, rdim, ndim), (
                    rules, fn, name, spec, rspec)


def test_even_spec_drops_nondividing_axes():
    """The cases of `tests/test_sharding.py`."""
    m = _port_mesh("single")
    assert PSH.even_spec(PSH.Spec("model", "data"), (49155, 1024), m) \
        == PSH.Spec(None, "data")
    assert PSH.even_spec(PSH.Spec("data", "model"), (1024, 40), m) \
        == PSH.Spec("data", None)
    m = _port_mesh("multi")
    assert PSH.even_spec(PSH.Spec(("pod", "data"), None), (64, 7), m) \
        == PSH.Spec(("pod", "data"), None)
    assert PSH.even_spec(PSH.Spec(("pod", "data"), None), (40, 7), m) \
        == PSH.Spec(None, None)
    for spec, shape in ((P("model", "data"), (49155, 1024)),
                        (P(("pod", "data"), None), (40, 7))):
        kind = "multi" if "pod" in str(spec) else "single"
        assert tuple(PSH.even_spec(PSH.Spec(*spec), shape, _port_mesh(kind))) \
            == tuple(RSH.even_spec(spec, shape, _fake(kind)))


def test_logical_axes_and_constrain():
    """`param_logical_axes` against the reference's on stacked and unstacked
    ranks, `logical_to_spec` under each rule table, and `constrain`: x as
    it is without a mesh, on one device, on a mesh of devices with no
    ranks (the dry-run's, which only sizes) and where x is laid out as
    asked already; on a mesh of ranks a re-layout from `src`, here the
    rows of this rank's data shard (a slice: no collective)."""
    for name in ("embed", "lm_head", "heads", "router", "w_in", "w_out",
                 "wqkv", "wo", "conv_w", "A_log", "ln_inner", "ln1"):
        for ndim in (1, 2, 3, 4):
            assert PSH.param_logical_axes(f"layers.0.x.{name}", ndim) \
                == RSH.param_logical_axes(("stack", "x", name), ndim)
    for kind in MESHES:
        for rules in RULES[kind]:
            with RSH.use_mesh(None, getattr(RSH, rules)):
                ref = RSH.logical_to_spec(("dp", None, "tp", "fsdp", "sp"))
            with PSH.use_mesh(None, getattr(PSH, rules)):
                assert tuple(PSH.logical_to_spec(
                    ("dp", None, "tp", "fsdp", "sp"))) == tuple(ref)
    x = torch.arange(8.0)
    assert PSH.constrain(x, "dp") is x
    with PSH.use_mesh(PM.make_debug_mesh(1)):
        assert PSH.current_mesh().size == 1
        assert PSH.constrain(x, "dp") is x
        assert PSH.constrain(x, "dp", src=(None,)) is x
    with PSH.use_mesh(PM.make_debug_mesh(4)):
        assert PSH.current_mesh().ranks == ()
        assert PSH.constrain(x, "dp", src=(None,)) is x
    ranks = PSH.Mesh(("data", "model"), (2, 2), ranks=(0, 1, 2, 3), rank=3)
    with PSH.use_mesh(ranks):
        assert PSH.live(PSH.current_mesh())
        assert PSH.constrain(x, "dp") is x
        assert torch.equal(PSH.constrain(x, "dp", src=(None,)), x[4:])
        assert torch.equal(PSH.constrain(x, "tp", src=(None,)), x[4:])
        assert PSH.constrain(x, None, src=(None,)) is x
    assert PSH.current_mesh() is None


def _stub_make_mesh(monkeypatch):
    monkeypatch.setattr(jax, "make_mesh",
                        lambda shape, names, *a, **k: (tuple(shape),
                                                       tuple(names)))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_meshes_match_reference(monkeypatch, multi_pod):
    _stub_make_mesh(monkeypatch)
    prod = PM.make_production_mesh(multi_pod=multi_pod)
    assert (prod.axis_sizes, prod.axis_names) == RM.make_production_mesh(
        multi_pod=multi_pod)
    assert prod.devices == ()
    for n in (1, 2, 3, 4, 6, 8, 12, 16):
        m = PM.make_debug_mesh(n, multi_pod=multi_pod)
        assert (m.axis_sizes, m.axis_names) == RM.make_debug_mesh(
            n, multi_pod=multi_pod)
        assert PM.dp_axes(m) == RM.dp_axes(_FakeMesh(m.axis_names,
                                                     m.axis_sizes))
    m = PM.make_debug_mesh(devices=["cpu"])
    assert m.shape == {"data": 1, "model": 1}
    assert m.devices == (torch.device("cpu"),)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PM.make_debug_mesh()


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_microbatches_and_batch_specs_match_reference(kind):
    """Every cell of `all_cells()`, with the default dp axes and with the
    pure-DP and prefill rules' dp (as the dry-run takes them)."""
    fake, mesh = _fake(kind), _port_mesh(kind)
    for (rcfg, rshape), (pcfg, pshape) in zip(RC.all_cells(),
                                              PC.all_cells()):
        assert (rcfg.name, vars(rshape)) == (pcfg.name, vars(pshape))
        for rules in (None, *RULES[kind][1:]):
            dp = getattr(RSH, rules)["dp"] if rules else None
            assert PS.resolve_microbatches(pcfg, pshape, mesh, dp=dp) \
                == RS.resolve_microbatches(rcfg, rshape, fake, dp=dp)
            ref = RS.batch_pspec(rcfg, rshape, fake, dp=dp)
            port = PS.batch_pspec(pcfg, pshape, mesh, dp=dp)
            assert {k: tuple(v) for k, v in port.items()} \
                == {k: tuple(v) for k, v in ref.items()}


def _ref_cache_specs(arch, fake, b, s):
    """{(block, leaf): {stripped spec}} of the reference's cache specs."""
    m = build_model(RC.get_arch(arch))
    shapes = jax.eval_shape(lambda: m.init_cache(b, s))
    specs = RS.cache_pspec_tree(RC.get_arch(arch), fake, shapes)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    sflat = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    out = {}
    for path, spec in flat:
        keys = [str(getattr(k, "key", k)) for k in path]
        lead = sum(1 for k in keys if k in ("stack", "groups", "tail"))
        if "groups" in keys and keys[-2] in ("mamba", "mlstm"):
            lead += 1                           # (groups, per group, ...)
        ndim = len(sflat[path].shape)
        out.setdefault((keys[-2], keys[-1]), set()).add(
            _strip(spec, ndim, ndim - lead))
    return out


@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-moe-3b-a800m",
                                  "musicgen-medium", "zamba2-7b",
                                  "xlstm-1.3b"])
def test_cache_specs_match_reference(arch, kind):
    """Each cache leaf's spec (k, v, kpos, idx; state, conv; C, n; c, n)
    against the reference's, per block kind."""
    b, s = 32, 64
    ref = _ref_cache_specs(arch, _fake(kind), b, s)
    cache = Model(PC.get_arch(arch), device="meta").init_cache(b, s)
    port = PS.cache_pspec_tree(PC.get_arch(arch), _port_mesh(kind), cache)
    seen = set()
    for block, entries in port.items():
        for entry in entries:
            for leaf, spec in entry.items():
                want = ref[(block, leaf)]
                assert len(want) == 1 and tuple(spec) in want, (block, leaf,
                                                                 spec, want)
                seen.add((block, leaf))
    assert seen == set(ref)


def test_attach_carries_even_specs():
    mesh = _port_mesh("single")
    tree = {"a": torch.zeros(32, 40), "b": [torch.zeros(48, 16)], "i": 0}
    out = PS.attach(mesh, tree, {"a": PSH.Spec("data", "model"),
                                 "b": [PSH.Spec("model", None)],
                                 "i": PSH.Spec()})
    assert out["a"].device.type == "meta" and out["a"].shape == (32, 40)
    assert tuple(out["a"].spec) == ("data", None)
    assert tuple(out["b"][0].spec) == ("model", None)
    assert out["i"] == 0


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 24, 256, 512])
def test_elastic_mesh_factorisation_matches_reference(monkeypatch, n):
    _stub_make_mesh(monkeypatch)
    ref = RFT.ElasticMeshManager(("pod", "data", "model"),
                                 device_provider=lambda: list(range(n)))
    port = PFT.ElasticMeshManager(("pod", "data", "model"),
                                  device_provider=lambda: ["cpu"] * n)
    m = port.current_mesh()
    assert (m.axis_sizes, m.axis_names) == ref.current_mesh()
    assert len(m.devices) == n


def test_elastic_reshard_on_one_device():
    """On a mesh of one device each tensor is moved there; on a mesh of
    ranks (here, this process as rank 1 of a (2, 1) mesh) each rank keeps
    its pieces of the whole tensors; a process outside a mesh of ranks
    gets None; a mesh of devices with no ranks holds no state."""
    mgr = PFT.ElasticMeshManager(("data", "model"),
                                 device_provider=lambda: ["cpu"])
    mesh = mgr.current_mesh()
    tree = {"w": torch.arange(8.0).reshape(4, 2),
            "opt": {"m": [torch.zeros(3)]}, "step": 7}
    specs = {"w": PSH.Spec("data", None), "opt": {"m": [PSH.Spec(None)]},
             "step": PSH.Spec()}
    out = mgr.reshard(tree, specs, mesh)
    assert torch.equal(out["w"], tree["w"]) and out["step"] == 7
    assert out["opt"]["m"][0].device == torch.device("cpu")
    ranks = PSH.Mesh(("data", "model"), (2, 1), ranks=(0, 1), rank=1)
    out = mgr.reshard(tree, specs, ranks)
    assert torch.equal(out["w"], tree["w"][2:]) and out["step"] == 7
    assert torch.equal(out["opt"]["m"][0], tree["opt"]["m"][0])
    outside = PSH.Mesh(("data", "model"), (2, 1), ranks=(4, 5))
    assert mgr.reshard(tree, specs, outside) is None
    two = PFT.ElasticMeshManager(("data", "model"),
                                 device_provider=lambda: ["cpu", "cpu"])
    with pytest.raises(ValueError, match="no ranks"):
        two.reshard(tree, specs, two.current_mesh())
    if not torch.cuda.is_available():
        assert PFT.ElasticMeshManager(("data", "model")).device_provider() \
            == []


def test_train_step_under_a_mesh_is_bit_equal():
    """The counterpart of `tests/test_sharding.py`'s check (which fails in
    the reference under jax 0.9.0): qwen2.5-3b's smoke config at float32,
    one step under `use_mesh(make_debug_mesh(1))` and one without, from
    the same initial state, bit-equal. One thread: on several, the CPU's
    index backward of the embedding gather (`index_put_` with accumulate)
    adds in another order in every run, mesh or none."""
    from repro_torch.train.data import DataConfig, batch_for_step
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import init_train_state, make_train_step
    cfg = PC.smoke_config(PC.get_arch("qwen2.5-3b")).with_(dtype="float32")
    opt = OptimizerConfig(warmup_steps=1, decay_steps=10)
    batch = {k: torch.from_numpy(v) for k, v in batch_for_step(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8),
        0).items()}
    runs, threads = [], torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for mesh in (None, PM.make_debug_mesh(1)):
            model = Model(cfg, device="cpu")
            state = init_train_state(model, torch.Generator().manual_seed(0),
                                     opt)
            with PSH.use_mesh(mesh):
                state, met = make_train_step(model, opt)(state, batch)
            runs.append((met["loss"], state.params))
    finally:
        torch.set_num_threads(threads)
    assert runs[0][0] == runs[1][0]
    for name, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][name]), name


def test_new_modules_and_examples_import_neither_jax_nor_the_reference():
    code = ("import sys\n"
            "import repro_torch.parallel, repro_torch.parallel.sharding\n"
            "import repro_torch.parallel.collectives\n"
            "import repro_torch.launch.train\n"
            "import repro_torch.launch.mesh, repro_torch.launch.shapes\n"
            "import repro_torch.launch.dryrun\n"
            "import repro_torch.train.fault_tolerance\n"
            "import runpy\n"
            "runpy.run_path('tests/torch_sharded_ranks.py',\n"
            "               run_name='not_main')\n"
            "for name in ('quickstart', 'schedule_cluster',\n"
            "             'serve_heterogeneous', 'train_lm'):\n"
            "    runpy.run_path(f'examples/{name}_torch.py',\n"
            "                   run_name='not_main')\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') "
            "or m.startswith(('jax.', 'jaxlib', 'repro.')))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
