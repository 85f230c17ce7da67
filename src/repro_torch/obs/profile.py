"""Wall-clock profiling spans for the hot solver paths.

CUDA launches are asynchronous: a naive `time.perf_counter` pair around a
device call times the *enqueue*, not the work. The profiler's `span`
context therefore waits on whatever the caller hands to `span.ready(...)`
before closing the span — `torch.cuda.synchronize` on the device of every
CUDA tensor in it — but ONLY when profiling is enabled, so the production
path keeps its asynchronous launches.

Off by default. `enable_profiling()` flips a module-level flag checked
once per instrumented call; the disabled cost is one attribute read. The
instrumented entry points: `solve_targets_torch`,
`solve_targets_grid_torch`, `grin_solve_batch_torch`,
`SchedulerCore.route_many`, and the scorer's host entry
(`kernels.grin_moves.block_move_scores`).

    >>> from repro_torch.obs import enable_profiling, get_profiler
    >>> enable_profiling()
    >>> ...  # run solves
    >>> get_profiler().summary()            # name -> count/total/mean/max
    >>> get_profiler().top_spans(5)         # slowest individual spans
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque

import torch

_MAX_SPANS = 16384


@dataclasses.dataclass(frozen=True)
class ProfileSpan:
    """One completed span: label, start (perf_counter seconds), duration."""

    name: str
    t0: float
    dur: float


def _cuda_devices(x, out: set) -> set:
    """The CUDA devices of every tensor in x (nested tuples, lists and
    dicts walked)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    return out


class _ActiveSpan:
    """Context manager for one live span; `ready(x)` waits until the
    device work behind x has run (and returns x), so the span covers
    execution, not just the launches."""

    __slots__ = ("_profiler", "name", "_t0")

    def __init__(self, profiler: "Profiler", name: str):
        self._profiler = profiler
        self.name = name

    def ready(self, x):
        for dev in _cuda_devices(x, set()):
            torch.cuda.synchronize(dev)
        return x

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._profiler._push(ProfileSpan(
            name=self.name, t0=self._t0,
            dur=time.perf_counter() - self._t0))
        return False


class _NullSpan:
    """Disabled-path span: no timing, `ready` is the identity."""

    __slots__ = ()

    def ready(self, x):
        return x

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Profiler:
    """Span collector: bounded deque of completed `ProfileSpan`s."""

    def __init__(self, enabled: bool = False, max_spans: int = _MAX_SPANS):
        self.enabled = bool(enabled)
        self._spans: deque[ProfileSpan] = deque(maxlen=int(max_spans))

    def _push(self, span: ProfileSpan) -> None:
        self._spans.append(span)

    def span(self, name: str):
        """`with profiler.span("solve"): ...` — a no-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _ActiveSpan(self, name)

    @property
    def spans(self) -> list[ProfileSpan]:
        return list(self._spans)

    def clear(self) -> None:
        self._spans.clear()

    def summary(self) -> dict[str, dict]:
        """{name: {count, total_s, mean_s, max_s}} over retained spans."""
        agg: dict[str, dict] = {}
        for s in self._spans:
            row = agg.setdefault(s.name, {"count": 0, "total_s": 0.0,
                                          "max_s": 0.0})
            row["count"] += 1
            row["total_s"] += s.dur
            row["max_s"] = max(row["max_s"], s.dur)
        for row in agg.values():
            row["mean_s"] = row["total_s"] / row["count"]
        return agg

    def top_spans(self, k: int = 10) -> list[ProfileSpan]:
        """The k slowest individual spans, slowest first."""
        return sorted(self._spans, key=lambda s: -s.dur)[:k]


_PROFILER = Profiler(enabled=False)


def get_profiler() -> Profiler:
    return _PROFILER


def enable_profiling(on: bool = True) -> Profiler:
    """Turn the module-level profiler on (or off); returns it."""
    _PROFILER.enabled = bool(on)
    return _PROFILER


def span(name: str):
    """Module-level span against the default profiler (the instrumented
    library call sites use this)."""
    if not _PROFILER.enabled:
        return _NULL_SPAN
    return _ActiveSpan(_PROFILER, name)


@contextlib.contextmanager
def profile_block(name: str):
    """Enable profiling for a `with` block, restoring the prior state."""
    prev = _PROFILER.enabled
    _PROFILER.enabled = True
    try:
        yield _PROFILER
    finally:
        _PROFILER.enabled = prev


__all__ = ["Profiler", "ProfileSpan", "get_profiler", "enable_profiling",
           "span", "profile_block"]
