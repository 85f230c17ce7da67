"""Logical-axis sharding (the reference's `parallel/sharding.py`): models
are annotated with logical names ("dp", "fsdp", "tp", "sp"), and a launcher
binds them to mesh axes. Outside a mesh all constraints are no-ops.

Bindings:
  single-pod (16, 16)   ("data", "model"):          dp/fsdp -> data, tp/sp -> model
  multi-pod (2, 16, 16) ("pod", "data", "model"):   dp/fsdp -> (pod, data), tp/sp -> model

The port runs on one card. `Spec` stands in for `PartitionSpec` and `Mesh`
for a device mesh (axis names and sizes, and the devices where there are
any); the specs are computed as the reference computes them, for the
dry-run (`launch.dryrun`) to size each cell's per-device bytes. Executing
a model sharded over several cards is not ported: `constrain` passes x
through on a mesh of one device and raises on a larger one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re

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
    """A device mesh stand-in: axis names and sizes, and the devices (in
    row-major order over the axes) where the mesh has any."""
    axis_names: tuple
    axis_sizes: tuple
    devices: tuple = ()

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} vs {self.axis_sizes}")
        if self.devices and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


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


def constrain(x, *axes):
    """The reference's sharding constraint by logical axis names: x as it
    is without a mesh or on a mesh of one device. On a mesh of several it
    raises: running a model sharded over cards is not ported."""
    mesh = _CTX["mesh"]
    if mesh is None or mesh.size == 1:
        return x
    raise NotImplementedError(
        f"constrain{logical_to_spec(axes)} on a mesh of {mesh.size} devices: "
        f"the port runs on one card")


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
