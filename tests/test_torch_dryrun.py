"""The port's dry-run (`repro_torch.launch.dryrun`) on the CPU: each train
cell's per-device parameter bytes against the reference's parameter shapes
and specs (each leaf divided by its spec's shard count on a fake
production mesh, under the rules the reference's `lower_cell` picks), one
cell of each kind run on the meta device through `run_cell`, the CLI's
records, and the kernel wrappers' meta path (the plain versions' shapes,
nothing computed, nothing launched)."""
import json
import math

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as RC  # noqa: E402
from repro.launch import shapes as RS  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.parallel import sharding as RSH  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402


class _FakeMesh:
    def __init__(self, mesh):
        self.axis_names = mesh.axis_names
        self.shape = mesh.shape


def _ref_bytes(shapes, specs, mesh, size):
    leaves = jax.tree_util.tree_leaves(shapes)
    specs = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    total = 0
    for leaf, spec in zip(leaves, specs):
        n = math.prod(mesh.shape[a] for ax in spec if ax is not None
                      for a in (ax if isinstance(ax, tuple) else (ax,)))
        total += math.prod(leaf.shape) * size // n
    return total


@pytest.mark.parametrize("arch", sorted(RC.ARCHS))
def test_train_cell_parameter_bytes_match_reference(arch):
    """train_4k on both production meshes: the sharding mode, microbatch
    count and per-device bytes of the float32 parameters and of the bf16
    compute copy equal the reference's (pure ZeRO-3 on one pod, 2-D dp x
    tp with a TP-only compute copy on two)."""
    m = build_model(RC.get_arch(arch))
    shapes = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0)))
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        fake = _FakeMesh(mesh)
        rules = RSH.RULES_MULTI_POD if multi else RSH.RULES_PURE_DP_SINGLE
        with RSH.use_mesh(None, rules):
            pspecs = RSH.param_pspec_tree(shapes, fake)
            cspecs = (RSH.compute_param_specs(shapes, fake) if multi
                      else pspecs)
        _, info = D.lower_cell(arch, "train_4k", mesh, trace=False)
        assert info["sharding_mode"] == ("2d" if multi else "pure_dp")
        assert info["zero_stage"] == (2 if multi else 3)
        assert info["microbatches"] == RS.resolve_microbatches(
            RC.get_arch(arch), RC.get_shape("train_4k"), fake,
            dp=None if multi else rules["dp"])
        mem = info["per_device_bytes"]
        assert mem["params"] == _ref_bytes(shapes, pspecs, fake, 4)
        assert mem["compute_copy"] == _ref_bytes(shapes, cspecs, fake, 2)
        assert mem["opt_moments"] == 2 * mem["params"] == 2 * mem["grads"]
        assert info["collectives"] == info["cost"] == D.NOT_APPLICABLE


def _launches():
    from repro_torch.kernels import (flash_attention, rmsnorm, ssd_scan,
                                     ssd_scan_bwd, ssd_scan_wide)
    return [dict(m.launches) for m in (flash_attention, rmsnorm, ssd_scan,
                                       ssd_scan_bwd, ssd_scan_wide)]


@pytest.mark.parametrize("arch,shape,multi", [
    ("granite-moe-1b-a400m", "train_4k", False),
    ("xlstm-1.3b", "prefill_32k", True),
    ("zamba2-7b", "long_500k", False)])
def test_one_cell_of_each_kind_runs_on_meta(arch, shape, multi):
    """The cell's function runs at the full shape on the meta device: its
    outputs are meta tensors, no kernel launches, and the record holds
    its bytes (a train cell's activation stash, a serving cell's
    caches)."""
    mesh = make_production_mesh(multi_pod=multi)
    before = _launches()
    info = D.run_cell(arch, shape, mesh, verbose=False)
    assert _launches() == before
    mem = info["per_device_bytes"]
    assert mem["params"] > 0 and mem["total"] == sum(
        v for k, v in mem.items() if k != "total")
    assert info["collectives"] == D.NOT_APPLICABLE
    out, _ = D.lower_cell(arch, shape, mesh)
    if info["kind"] == "train":
        loss, _, grads = out
        assert loss.device.type == "meta" and mem["activation_stash"] > 0
        assert info["microbatches"] >= 1
        assert all(g.device.type == "meta" for g in grads.values())
    else:
        logits, cache = out
        assert logits.device.type == "meta" and mem["caches"] > 0
        b = RC.get_shape(shape).global_batch
        assert logits.shape[0] == b


def test_main_writes_one_record_per_cell_and_mesh(tmp_path):
    D.main(["--arch", "granite-moe-3b-a800m", "--shape", "decode_32k",
            "--mesh", "both", "--out", str(tmp_path)])
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["granite-moe-3b-a800m__decode_32k__multi.json",
                     "granite-moe-3b-a800m__decode_32k__single.json"]
    for name in files:
        rec = json.loads((tmp_path / name).read_text())
        assert rec["status"] == "ok" and rec["kind"] == "decode"
        assert rec["collectives"] == rec["cost"] == D.NOT_APPLICABLE
        assert rec["per_device_bytes"]["caches"] > 0


def test_kernel_wrappers_give_the_plain_shapes_on_meta():
    """Each wrapper on meta tensors: the plain version's output shapes and
    dtypes (checked against the plain version on small CPU inputs), and a
    backward of the inputs' shapes."""
    g = torch.Generator().manual_seed(0)

    def pair(*shape, dtype=torch.float32):
        x = torch.randn(*shape, generator=g).to(dtype)
        return x, torch.empty(shape, dtype=dtype, device="meta",
                              requires_grad=True)
    (q, mq), (k, mk), (v, mv) = (pair(2, 16, 4, 8), pair(2, 16, 2, 8),
                                 pair(2, 16, 2, 8))
    got = ops.flash_attention(mq, mk, mv)
    want = ops.flash_attention(q, k, v)
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    got.sum().backward()
    assert mq.grad.shape == mq.shape and mk.grad.shape == mk.shape
    (q, mq), (k, mk), (v, mv) = (pair(2, 16, 3, 8), pair(2, 16, 3, 8),
                                 pair(2, 16, 3, 5))
    (la, mla), (be, mbe) = pair(2, 16, 3), pair(2, 16, 3)
    for fn in (ops.ssd_scan, ops.mlstm_scan):
        got = fn(mq, mk, mv, mla, mbe, chunk=8)
        want = fn(q, k, v, -la.abs(), be, chunk=8)
        assert [(t.shape, t.dtype) for t in got] == [
            (t.shape, t.dtype) for t in want]
        assert all(t.device.type == "meta" for t in got)
    x, mx = pair(4, 8)
    w, mw = pair(8)
    assert ops.rmsnorm(mx, mw).shape == ops.rmsnorm(x, w).shape
