"""Logical-axis sharding (the reference's `parallel/sharding.py`): models
are annotated with logical names ("dp", "fsdp", "tp", "sp"), and a launcher
binds them to mesh axes. Outside a mesh all constraints are no-ops.

Bindings:
  single-pod (16, 16)   ("data", "model"):          dp/fsdp -> data, tp/sp -> model
  multi-pod (2, 16, 16) ("pod", "data", "model"):   dp/fsdp -> (pod, data), tp/sp -> model

`Spec` stands in for `PartitionSpec`, and `Mesh` for a device mesh: axis
names and sizes, and, for a mesh that runs, its ranks (`torch.distributed`
processes, row-major over the axes) and this process's rank. A mesh
without ranks only sizes things (the dry-run's production meshes). On a
mesh of ranks each process holds its own piece of every sharded tensor
(the local view): a spec is itself the placement, each dimension cut over
the mesh axes it names and whole on the others; `local_slice` cuts a
whole tensor to this rank's piece, `gather_whole` puts the pieces back
together, and `constrain(x, *axes, src=...)` re-lays a tensor held as
`src` to `axes` (gathering the mesh axes it leaves, slicing those it
takes). The collectives are `parallel.collectives`'. Autograd sees the
re-layouts as the Megatron-style pairs: a gather's backward takes this
rank's slice, a slice's backward gathers; `copy_to` (identity, summed in
the backward) and `reduce_from` (summed, identity in the backward) open
and close a tensor-parallel region.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re

import torch

from repro_torch.parallel import collectives as C

_CTX: dict = {"mesh": None, "rules": {}}

RULES_SINGLE_POD = {"dp": ("data",), "fsdp": ("data",), "tp": ("model",),
                    "sp": ("model",)}
RULES_MULTI_POD = {"dp": ("pod", "data"), "fsdp": ("pod", "data"),
                   "tp": ("model",), "sp": ("model",)}
# Pure ZeRO-3 data parallelism: batch + parameter shards over every chip,
# no tensor parallelism (the reference's train_4k default on one pod).
RULES_PURE_DP_SINGLE = {"dp": ("data", "model"), "fsdp": ("data", "model"),
                        "tp": None, "sp": None}
RULES_PURE_DP_MULTI = {"dp": ("pod", "data", "model"),
                       "fsdp": ("pod", "data", "model"), "tp": None, "sp": None}
# Prefill: batch over the data axis only, parameters FSDP over the whole
# fleet, no TP.
RULES_PREFILL_SINGLE = {"dp": ("data",), "fsdp": ("data", "model"),
                        "tp": None, "sp": None}
RULES_PREFILL_MULTI = {"dp": ("pod", "data"),
                       "fsdp": ("pod", "data", "model"), "tp": None, "sp": None}


class Spec(tuple):
    """A partition spec: per dimension an axis name, a tuple of names, or
    None (replicated). As `PartitionSpec` does, a one-name tuple is held
    as the name."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple)
                                     and len(p) == 1 else p for p in parts))

    def __repr__(self) -> str:
        return f"Spec{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh stand-in: axis names and sizes, the devices (in
    row-major order over the axes) where the mesh has any, and for a mesh
    that runs its ranks (row-major over the axes) and this process's
    `rank` (None where it is none of them)."""
    axis_names: tuple
    axis_sizes: tuple
    devices: tuple = ()
    ranks: tuple = ()
    rank: int | None = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} vs {self.axis_sizes}")
        if self.devices and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")
        if self.ranks and len(self.ranks) != self.size:
            raise ValueError(f"{len(self.ranks)} ranks for a mesh of "
                             f"{self.size}")
        if self.rank is not None and self.rank not in self.ranks:
            raise ValueError(f"rank {self.rank} is not in {self.ranks}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def coords_of(self, rank: int) -> dict:
        """{axis: index} of `rank` on the mesh."""
        idx, out = self.ranks.index(rank), {}
        for name, n in reversed(tuple(zip(self.axis_names,
                                          self.axis_sizes))):
            idx, out[name] = divmod(idx, n)
        return {a: out[a] for a in self.axis_names}

    def rank_at(self, coords: dict) -> int:
        idx = 0
        for name, n in zip(self.axis_names, self.axis_sizes):
            idx = idx * n + coords[name]
        return self.ranks[idx]

    @property
    def coords(self) -> dict:
        """This process's {axis: index}."""
        return self.coords_of(self.rank)


def live(mesh) -> bool:
    """Whether `mesh` is a mesh of several ranks this process is one of:
    where tensors are held in pieces and collectives run."""
    return (mesh is not None and mesh.size > 1
            and getattr(mesh, "rank", None) is not None)


def _names(ax) -> tuple:
    return () if ax is None else ax if isinstance(ax, tuple) else (ax,)


def spec_axes(spec) -> set:
    """The mesh axes a spec shards over."""
    return {a for ax in spec for a in _names(ax)}


def rules_for_mesh(mesh) -> dict:
    return RULES_MULTI_POD if "pod" in mesh.axis_names else RULES_SINGLE_POD


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None, rules: dict | None = None):
    """Bind the ambient mesh and logical-axis rules."""
    old = dict(_CTX)
    _CTX.update(mesh=mesh, rules=rules or (rules_for_mesh(mesh) if mesh
                                           else {}))
    try:
        yield
    finally:
        _CTX.update(old)


def current_mesh() -> Mesh | None:
    return _CTX["mesh"]


def logical_to_spec(axes) -> Spec:
    rules = _CTX["rules"]
    return Spec(*(None if a is None else (rules.get(a) or None)
                  for a in axes))


def _index_on(mesh, ax) -> tuple[int, int]:
    """(this rank's index, count) along the axes `ax`, row-major."""
    idx, count = 0, 1
    for a in _names(ax):
        idx = idx * mesh.shape[a] + mesh.coords[a]
        count *= mesh.shape[a]
    return idx, count


def local_slice(x, spec, mesh):
    """This rank's piece of the whole tensor x laid out by `spec` on
    `mesh` (a view; every named dimension must divide)."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        idx, count = _index_on(mesh, ax)
        if x.shape[dim] % count:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"divide over {ax} ({count})")
        n = x.shape[dim] // count
        x = x.narrow(dim, idx * n, n)
    return x


def gather_whole(x, spec, mesh):
    """The whole tensor from this rank's piece x laid out by `spec` (every
    rank of the mesh takes part)."""
    for dim, ax in enumerate(spec):
        if ax is not None:
            x = C.all_gather(x, mesh, _names(ax), dim)
    return x


class _Gather(torch.autograd.Function):
    """All-gather along `dim` over `axes`; backward: this rank's slice."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return C.all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        idx, count = _index_on(ctx.mesh, ctx.axes)
        n = g.shape[ctx.dim] // count
        return g.narrow(ctx.dim, idx * n, n), None, None, None


class _Slice(torch.autograd.Function):
    """This rank's slice along `dim` over `axes`; backward: all-gather."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        idx, count = _index_on(mesh, axes)
        if x.shape[dim] % count:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"divide over {axes} ({count})")
        n = x.shape[dim] // count
        return x.narrow(dim, idx * n, n)

    @staticmethod
    def backward(ctx, g):
        return C.all_gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _CopyTo(torch.autograd.Function):
    """Identity; backward: the sum over `axes` (a replicated tensor enters
    a region where each rank computes a part)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x

    @staticmethod
    def backward(ctx, g):
        return C.all_reduce(g, ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    """The sum over `axes`; backward: identity (the parts' sum leaves the
    region replicated)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return C.all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def mesh_axes(axis, mesh=None):
    """(the live mesh, its axes bound to the logical `axis`) or (None,
    ())."""
    mesh = mesh or _CTX["mesh"]
    if not live(mesh):
        return None, ()
    rule = _CTX["rules"].get(axis) if axis in _CTX["rules"] else axis
    return mesh, tuple(a for a in _names(rule) if mesh.shape[a] > 1)


def logical_size(axis: str, mesh=None) -> int:
    """How many ranks of the live mesh the logical `axis` spans (1 off
    one)."""
    mesh, axes = mesh_axes(axis, mesh)
    return math.prod(mesh.shape[a] for a in axes) if axes else 1


def copy_to(x, axis: str):
    """x on entering a region split over the logical `axis` ("tp": the
    model axis): itself, with its gradient summed over the axis."""
    mesh, axes = mesh_axes(axis)
    return _CopyTo.apply(x, mesh, axes) if axes else x


def reduce_from(x, axis: str):
    """The sum of the ranks' x over the logical `axis` (fixed order,
    float32), with an identity backward: a row-parallel product's partial
    sums, a data shard's share of a loss."""
    mesh, axes = mesh_axes(axis)
    return _ReduceFrom.apply(x, mesh, axes) if axes else x


def constrain(x, *axes, src=None):
    """The reference's sharding constraint by logical axis names. Without a
    mesh, or on a mesh of one device or of no ranks, x as it is. On a mesh
    of ranks x is this rank's piece: with `src` (the logical axes x is
    laid out by now) it is re-laid to `axes`, each dimension's mesh axes
    that `axes` drops gathered and those it adds sliced (under autograd,
    a gather's backward slices and a slice's gathers); without `src` x is
    taken to be laid out by `axes` already and is returned as it is (the
    reference's annotations at the layers' outputs)."""
    mesh = _CTX["mesh"]
    if src is None or not live(mesh):
        return x
    if len(src) != x.dim() or len(axes) != x.dim():
        raise ValueError(f"constrain: {x.dim()}-d tensor, src {src}, "
                         f"axes {axes}")
    have, want = logical_to_spec(src), logical_to_spec(axes)
    for dim in range(x.dim()):
        old, new = set(_names(have[dim])), set(_names(want[dim]))
        if old - new:
            x = _Gather.apply(x, mesh, tuple(a for a in _names(have[dim])
                                             if a not in new), dim)
        if new - old:
            x = _Slice.apply(x, mesh, tuple(a for a in _names(want[dim])
                                            if a not in old), dim)
    return x


# Parameter partition rules: name -> logical axes per dimension, matched
# against the last component of a parameter's name. Leaves of lower rank
# keep the rule's last dimensions, of higher rank get leading Nones.
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed$", ("tp", "fsdp")),            # (V, D); (K, V, D) handled by rank
    (r"lm_head$", ("fsdp", "tp")),
    (r"heads$", (None, "fsdp", "tp")),      # musicgen codebook heads (K, D, V)
    (r"patch_proj$", ("fsdp", "tp")),
    (r"router$", ("fsdp", None)),
    (r"w_in$", ("tp", "fsdp", None)),       # experts (E, D, 2F)
    (r"w_out$", ("tp", None, "fsdp")),      # experts (E, F, D)
    (r"(wqkv|wg|wu|wif|w_ogate|in_proj|w_gates)$", ("fsdp", "tp")),
    (r"(wo|wd|out_proj)$", ("tp", "fsdp")),
    (r"conv_w$", (None, "tp")),
    (r"(conv_b|bqkv|A_log|Dskip|dt_bias)$", ("tp",)),
    (r"ln_inner$", (None, None)),
    (r".*", (None,)),                        # norms, scalars, leftovers
]


def param_logical_axes(path, ndim: int) -> tuple:
    """Logical axes of a parameter of rank `ndim` named `path` (a port
    parameter name "layers.3.attn.wqkv", or its components)."""
    name = (path.split(".") if isinstance(path, str) else path)[-1]
    for pat, axes in _PARAM_RULES:
        if re.search(pat, name):
            if len(axes) < ndim:
                axes = (None,) * (ndim - len(axes)) + axes
            elif len(axes) > ndim:
                axes = axes[len(axes) - ndim:]
            return tuple(axes)
    return (None,) * ndim


def shard_count(spec, mesh) -> int:
    """How many shards `spec` cuts a tensor into on `mesh`."""
    n = 1
    for ax in spec:
        for a in (() if ax is None else ax if isinstance(ax, tuple)
                  else (ax,)):
            n *= mesh.shape[a]
    return n


def even_spec(spec, shape, mesh) -> Spec:
    """Drop spec axes that do not evenly divide the dimension (uneven cases
    fall back to replication on that dim)."""
    parts = []
    for i, ax in enumerate(spec):
        if ax is None:
            parts.append(None)
            continue
        size = shard_count(Spec(ax), mesh)
        parts.append(ax if shape[i] % size == 0 else None)
    return Spec(*parts)


def _named_shapes(params) -> dict:
    """{name: shape} of a Model's (or any module's) named parameters, or of
    a dict of tensors or shapes."""
    items = (params.named_parameters() if hasattr(params, "named_parameters")
             else params.items())
    return {n: tuple(getattr(p, "shape", p)) for n, p in items}


def param_pspec_tree(params, mesh: Mesh | None = None) -> dict:
    """{parameter name: Spec} by the rules, for a `Model`'s named
    parameters (or a dict of tensors or shapes). With `mesh` (or an
    ambient one) axes that do not divide are dropped."""
    mesh = mesh or _CTX["mesh"]
    out = {}
    for name, shape in _named_shapes(params).items():
        s = logical_to_spec(param_logical_axes(name, len(shape)))
        out[name] = even_spec(s, shape, mesh) if mesh is not None else s
    return out


def compute_param_specs(params, mesh: Mesh | None = None) -> dict:
    """TP-only specs for the bf16 compute copy of the weights (ZeRO-2): the
    fsdp axis dropped, so each weight is gathered once a step."""
    mesh = mesh or _CTX["mesh"]
    out = {}
    for name, shape in _named_shapes(params).items():
        axes = tuple(None if a == "fsdp" else a
                     for a in param_logical_axes(name, len(shape)))
        s = logical_to_spec(axes)
        out[name] = even_spec(s, shape, mesh) if mesh is not None else s
    return out


def named_sharding_tree(mesh: Mesh, params) -> dict:
    """{parameter name: spec} of `params` (a `Model`, or a dict of whole
    tensors or shapes) on `mesh` by its rules, each spec even on it (the
    reference's tree of `NamedSharding`s; `local_slice` places by it)."""
    with use_mesh(mesh):
        return param_pspec_tree(params)


def gather_params(local: dict, shapes: dict, mesh: Mesh) -> dict:
    """The whole tensors of `local` (this rank's pieces, laid out by
    `param_pspec_tree` of the whole `shapes`); every rank takes part."""
    with use_mesh(mesh):
        specs = param_pspec_tree(shapes)
    return {n: gather_whole(t, specs[n], mesh) for n, t in local.items()}


def _fsdp_dims(shapes: dict, mesh: Mesh) -> dict:
    """{name: [(dim, mesh axes)]}: where a master is sharded beyond its
    compute copy (the fsdp axes that divide)."""
    with use_mesh(mesh):
        ps, cs = param_pspec_tree(shapes), compute_param_specs(shapes)
    out = {}
    for n in shapes:
        out[n] = [(d, tuple(a for a in _names(ps[n][d])
                            if a not in _names(cs[n][d])))
                  for d in range(len(shapes[n]))
                  if set(_names(ps[n][d])) - set(_names(cs[n][d]))]
    return out


def cast_and_reshard_compute_params(params: dict, shapes: dict,
                                    dtype=torch.bfloat16,
                                    mesh: Mesh | None = None) -> dict:
    """The compute copy of the masters (ZeRO-2): each cast to `dtype`,
    then on a mesh of ranks gathered over its fsdp axes, so each rank
    holds the TP-only piece of `compute_param_specs` (the reference's
    cast plus TP-only resharding constraint). `params` are this rank's
    pieces of masters of whole `shapes`. Without a mesh of ranks the cast
    alone."""
    mesh = mesh or _CTX["mesh"]
    out = {n: p.detach().to(dtype) for n, p in params.items()}
    if not live(mesh):
        return out
    for n, dims in _fsdp_dims(shapes, mesh).items():
        for d, axes in dims:
            out[n] = C.all_gather(out[n], mesh, axes, d)
    return out


def reduce_grads_to_masters(grads: dict, shapes: dict,
                            mesh: Mesh | None = None, dp=None) -> dict:
    """The transpose of `cast_and_reshard_compute_params` for gradients:
    each rank's gradients of its compute copy (partial sums of its data
    shard, float32), summed over the data-parallel axes `dp` (the rules'
    "dp") in the ranks' order: reduce-scattered along the fsdp dimension
    into the master's piece where the master is sharded there, all-reduced
    where it is not."""
    mesh = mesh or _CTX["mesh"]
    if not live(mesh):
        return grads
    if dp is None:
        dp = _names(_CTX["rules"].get("dp") or rules_for_mesh(mesh)["dp"])
    dp = tuple(a for a in dp if mesh.shape[a] > 1)
    out = {}
    for n, dims in _fsdp_dims(shapes, mesh).items():
        g, done = grads[n], set()
        for d, axes in dims:
            g = C.reduce_scatter(g, mesh, axes, d)
            done |= set(axes)
        rest = tuple(a for a in dp if a not in done)
        out[n] = C.all_reduce(g, mesh, rest) if rest else g
    return out
