"""Collectives over a mesh of ranks: the only module of the port that calls
`torch.distributed`.

A mesh of ranks (`parallel.sharding.Mesh` with `ranks` and this process's
`rank`) names its axes; a collective runs over one axis, a tuple of axes
(row-major over them), or the whole mesh (`axis=None`), among the ranks
of the line through this rank. Each line has a process group of its own,
made by the ranks of that line only (`bind` makes a mesh's up front).

Every sum is taken here, in float32 (float64 for float64 inputs), in the
ranks' order along the axis: `all_reduce` gathers every rank's tensor and
adds them first to last, and `reduce_scatter` exchanges the chunks
(all-to-all) and adds what it received the same way. So every rank of a
line gets the same bits, and two runs give the same bits. Nothing uses the
transport's own reductions, whose order is its own.

Transport. The world's backend is chosen from its layout when the world is
joined (`init_world`), and printed: NCCL where every rank of the host has a
card of its own; gloo on the CPU and where ranks share a card (NCCL refuses
two ranks on one device), and then a CUDA tensor is staged explicitly
through a pinned host buffer both ways. A failed collective raises; nothing
falls back to another transport.

`traffic` counts, per collective, the calls, the bytes this rank received
from the others and the host seconds spent in it, staging included
(`reset_traffic()` sets it to 0).
"""
from __future__ import annotations

import contextlib
import math
import os
import time

import torch
import torch.distributed as dist

_WORLD: dict = {"rank": None, "size": 1, "transport": None, "device": None}
_GROUPS: dict = {}      # ranks of a line, in order -> its process group
traffic: dict = {}


def reset_traffic() -> None:
    traffic.clear()


def _count(op: str, nbytes: int, t0: float) -> None:
    t = traffic.setdefault(op, {"calls": 0, "bytes": 0, "s": 0.0})
    t["calls"] += 1
    t["bytes"] += int(nbytes)
    t["s"] += time.perf_counter() - t0


def transport_for(device: torch.device, local_ranks: int) -> str:
    """The transport of a world whose ranks run on `device`'s kind, with
    `local_ranks` ranks on this host: "nccl" when each has a card of its
    own, "gloo+staging" when ranks share a card, "gloo" on the CPU."""
    if device.type != "cuda":
        return "gloo"
    if local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo+staging"


def rank_device(device=None) -> torch.device:
    """This rank's device: `device` when given, else
    cuda:(LOCAL_RANK % the cards there are)."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                               % torch.cuda.device_count())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for this rank; pass device='cpu'")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                        % torch.cuda.device_count())


def init_world(device=None, *, init_method: str | None = None,
               rank: int | None = None, world_size: int | None = None,
               log=print) -> dict:
    """Join the world of ranks: `rank` and `world_size`, else RANK and
    WORLD_SIZE as `python -m torch.distributed.run` sets them; rendezvous
    through `init_method` (a file:// store, say), else env:// (MASTER_ADDR,
    MASTER_PORT). Picks this rank's device (`rank_device`) and the
    transport (`transport_for`, from LOCAL_WORLD_SIZE ranks on the host)
    and prints them. Returns the world: {"rank", "size", "transport",
    "device"}."""
    if _WORLD["rank"] is not None:
        return dict(_WORLD)
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    size = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
            else world_size)
    dev = rank_device(device)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    transport = transport_for(dev, local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if transport == "nccl" else "gloo"
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=size, **kw)
    _WORLD.update(rank=rank, size=size, transport=transport, device=dev)
    if rank == 0:
        log(f"[world] {size} ranks, {local} on this host, on {dev.type}: "
            f"transport {transport}")
    return dict(_WORLD)


def world() -> dict:
    """{"rank", "size", "transport", "device"}; rank None outside a world."""
    return dict(_WORLD)


def leave_world() -> None:
    """Destroy the process groups and leave the world."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _GROUPS.clear()
    _WORLD.update(rank=None, size=1, transport=None, device=None)


def _axes(mesh, axis) -> tuple:
    if axis is None:
        return tuple(mesh.axis_names)
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def line(mesh, axis, rank=None) -> tuple:
    """The ranks of `mesh` along `axis` through `rank` (this process's by
    default), row-major over the axes."""
    axes = _axes(mesh, axis)
    coords = mesh.coords_of(mesh.rank if rank is None else rank)
    out = []
    for idx in range(math.prod(mesh.shape[a] for a in axes)):
        c = dict(coords)
        for a in reversed(axes):
            idx, c[a] = divmod(idx, mesh.shape[a])
        out.append(mesh.rank_at(c))
    return tuple(out)


def _group(mesh, axis):
    """(process group, ranks along `axis` through this rank, this rank's
    index among them). A group is made the first time its ranks need it,
    by those ranks only (every one of them is entering the same
    collective), so ranks outside it, a lost one among them, take no
    part."""
    if mesh.rank is None or not dist.is_initialized():
        raise RuntimeError(f"a collective over {mesh.shape}: this process "
                           f"is no rank of the mesh (join the world first: "
                           f"init_world)")
    members = line(mesh, axis)
    if len(members) == 1:
        return None, members, 0
    group = _GROUPS.get(members)
    if group is None:
        group = (dist.group.WORLD
                 if members == tuple(range(dist.get_world_size()))
                 else dist.new_group(list(members),
                                     use_local_synchronization=True))
        _GROUPS[members] = group
    return group, members, members.index(mesh.rank)


def bind(mesh) -> None:
    """Make the process groups of the whole mesh and of each of its axes
    that hold this rank, up front (each by its own ranks, together)."""
    for axis in (None, *mesh.axis_names):
        _group(mesh, axis)


def _staged(x: torch.Tensor) -> bool:
    return x.is_cuda and _WORLD["transport"] != "nccl"


def _to_wire(x: torch.Tensor) -> torch.Tensor:
    """x's bytes as a flat uint8 tensor where the transport reads them: a
    pinned host copy when staging."""
    flat = x.contiguous().reshape(-1).view(torch.uint8)
    if _staged(x):
        host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(flat)
        return host
    return flat


def _wire_buffer(nbytes: int, like: torch.Tensor) -> torch.Tensor:
    if _staged(like):
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    return torch.empty(nbytes, dtype=torch.uint8, device=like.device)


def _from_wire(buf: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
    return buf.to(like.device).view(like.dtype).reshape(shape)


def _gathered(x: torch.Tensor, mesh, axis) -> list[torch.Tensor]:
    """Every rank's x along `axis`, in the ranks' order."""
    group, members, _ = _group(mesh, axis)
    n = len(members)
    if n == 1:
        return [x]
    with _on(x):
        wire = _to_wire(x)
        out = _wire_buffer(wire.numel() * n, x)
        parts = list(out.chunk(n))
        dist.all_gather(parts, wire, group=group)
        full = _from_wire(out, x, (n, *x.shape))
    return list(full.unbind(0))


def _on(x: torch.Tensor):
    """The rank's device current while a collective runs (autograd runs a
    backward on a thread of its own)."""
    return (torch.cuda.device(x.device) if x.is_cuda
            else contextlib.nullcontext())


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _ordered_sum(parts) -> torch.Tensor:
    acc = parts[0].to(_acc_dtype(parts[0].dtype), copy=True)
    for p in parts[1:]:
        acc += p
    return acc


def all_gather(x: torch.Tensor, mesh, axis, dim: int = 0) -> torch.Tensor:
    """The ranks' x along `axis` concatenated along `dim`, in their
    order."""
    t0 = time.perf_counter()
    parts = _gathered(x, mesh, axis)
    if len(parts) == 1:
        return x
    out = torch.cat(parts, dim=dim)
    _count("all_gather", (len(parts) - 1) * x.numel() * x.element_size(), t0)
    return out


def all_reduce(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The sum of the ranks' x along `axis`, added in their order in
    float32 (or wider), cast back to x's dtype: the same bits on every
    rank."""
    t0 = time.perf_counter()
    parts = _gathered(x, mesh, axis)
    if len(parts) == 1:
        return x
    out = _ordered_sum(parts).to(x.dtype)
    _count("all_reduce", (len(parts) - 1) * x.numel() * x.element_size(), t0)
    return out


def all_reduce_max(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The elementwise max of the ranks' x along `axis`."""
    t0 = time.perf_counter()
    parts = _gathered(x, mesh, axis)
    if len(parts) == 1:
        return x
    out = torch.stack(parts).amax(0)
    _count("all_reduce", (len(parts) - 1) * x.numel() * x.element_size(), t0)
    return out


def reduce_scatter(x: torch.Tensor, mesh, axis, dim: int = 0
                   ) -> torch.Tensor:
    """This rank's chunk (along `dim`, n equal chunks in the ranks' order)
    of the sum of the ranks' x along `axis`: the chunks exchanged
    all-to-all, then added in the ranks' order in float32 (or wider), cast
    back to x's dtype."""
    t0 = time.perf_counter()
    group, members, me = _group(mesh, axis)
    n = len(members)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not divide by {n}")
    chunks = [c.contiguous() for c in x.chunk(n, dim)]
    shape = chunks[0].shape
    with _on(x):
        wire = _to_wire(torch.stack(chunks))
        out = _wire_buffer(wire.numel(), x)
        dist.all_to_all_single(out, wire, group=group)
        recv = _from_wire(out, x, (n, *shape))
    out = _ordered_sum(list(recv.unbind(0))).to(x.dtype)
    _count("reduce_scatter", (n - 1) * chunks[0].numel() * x.element_size(),
           t0)
    return out


def scatter(parts, like: torch.Tensor, mesh, src_rank: int) -> torch.Tensor:
    """This rank's tensor of `parts`: on rank `src_rank` a list of one
    tensor per rank of the mesh (in its rank order), each of `like`'s
    shape and dtype; None on the others."""
    t0 = time.perf_counter()
    group, members, me = _group(mesh, None)
    if len(members) == 1:
        return parts[0]
    with _on(like):
        nbytes = like.numel() * like.element_size()
        out = _wire_buffer(nbytes, like)
        src = ([_to_wire(p) for p in parts] if mesh.rank == src_rank
               else None)
        dist.scatter(out, src, src=src_rank, group=group)
        res = _from_wire(out, like, like.shape)
    _count("scatter", 0 if mesh.rank == src_rank else nbytes, t0)
    return res


def all_gather_object(obj, mesh) -> list:
    """Every rank's `obj` (a picklable Python object), in the mesh's rank
    order."""
    group, members, _ = _group(mesh, None)
    if len(members) == 1:
        return [obj]
    out = [None] * len(members)
    dist.all_gather_object(out, obj, group=group)
    return out


def barrier(mesh) -> None:
    """Wait for every rank of the mesh."""
    group, members, _ = _group(mesh, None)
    if len(members) > 1:
        dist.barrier(group=group)
