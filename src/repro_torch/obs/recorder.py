"""Bounded ring-buffer flight recorder for structured decision events.

One `TraceRecorder` can be shared by every layer of a run (scheduler core,
admission controller, autoscale governor, fault loops): each layer records
`(t, layer, kind, data)` tuples and the recorder keeps the most recent
`capacity` of them, counting what it had to drop. Export is Chrome
trace-event JSON — loadable in chrome://tracing / Perfetto.

Determinism: export is byte-deterministic for a deterministic event stream
(sorted JSON keys, no wall-clock stamps — event times are SIMULATION times
supplied by the caller, or a monotone sequence number when the caller has
no clock). The trace-determinism tests pin this.
"""
from __future__ import annotations

import dataclasses
import json
from collections import Counter, deque

# Stable tid assignment per layer in the Chrome export (unknown layers get
# the next free id in first-seen order — still deterministic per stream).
_LAYER_TIDS = {"sched": 1, "admission": 2, "governor": 3, "faults": 4,
               "profile": 5, "host": 6}


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One recorded decision: time, producing layer, event kind, payload."""

    t: float
    layer: str
    kind: str
    data: dict


class TraceRecorder:
    """Bounded ring buffer of `TraceEvent`s with Chrome-trace export.

    capacity bounds memory: the buffer keeps the most recent `capacity`
    events and `dropped` counts the overwritten ones. `record` is the
    single hot-path entry — callers guard it behind an
    `if recorder is not None` so an unattached run pays nothing.
    """

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.capacity = int(capacity)
        self._events: deque[TraceEvent] = deque(maxlen=self.capacity)
        self._seq = 0
        self.dropped = 0

    # ---------------- recording ----------------
    def record(self, layer: str, kind: str, t: float | None = None,
               **data) -> None:
        """Append one event. `t` is the caller's (simulation) clock; when
        the caller has no clock the monotone record sequence number stands
        in, so event order is still total."""
        if len(self._events) == self._events.maxlen:
            self.dropped += 1
        self._events.append(TraceEvent(
            t=float(self._seq if t is None else t), layer=layer, kind=kind,
            data=data))
        self._seq += 1

    def clear(self) -> None:
        self._events.clear()
        self._seq = 0
        self.dropped = 0

    # ---------------- inspection ----------------
    @property
    def events(self) -> list[TraceEvent]:
        return list(self._events)

    def __len__(self) -> int:
        return len(self._events)

    def counts(self) -> dict[tuple[str, str], int]:
        """{(layer, kind): count} over the retained events."""
        return dict(Counter((e.layer, e.kind) for e in self._events))

    def layer_counts(self) -> dict[str, int]:
        """{layer: count} over the retained events."""
        return dict(Counter(e.layer for e in self._events))

    # ---------------- export ----------------
    def to_chrome_trace(self, spans=None) -> list[dict]:
        """Chrome trace-event list: every recorded event as an instant
        (`ph: "i"`) event, plus optional profiling `spans`
        (`repro_torch.obs.profile.ProfileSpan`) as complete (`ph: "X"`) events.
        Timestamps are microseconds per the format; simulation seconds map
        1 s -> 1e6 us."""
        tids = dict(_LAYER_TIDS)
        out = []
        for e in self._events:
            tid = tids.setdefault(e.layer, max(tids.values()) + 1)
            out.append({"name": e.kind, "cat": e.layer, "ph": "i",
                        "ts": e.t * 1e6, "pid": 1, "tid": tid, "s": "t",
                        "args": _jsonable(e.data)})
        for s in spans or ():
            out.append({"name": s.name, "cat": "profile", "ph": "X",
                        "ts": s.t0 * 1e6, "dur": s.dur * 1e6, "pid": 1,
                        "tid": tids["profile"], "args": {}})
        return out

    def export(self, path: str, spans=None) -> int:
        """Write Chrome trace JSON; returns the number of events written.
        Byte-deterministic for a deterministic event stream."""
        events = self.to_chrome_trace(spans=spans)
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "metadata": {"dropped": self.dropped,
                            "capacity": self.capacity}}
        with open(path, "w") as f:
            json.dump(doc, f, sort_keys=True, separators=(",", ":"))
        return len(events)


def _jsonable(data: dict) -> dict:
    """Coerce event payloads (numpy scalars/arrays sneak in) to JSON types."""
    out = {}
    for key, v in data.items():
        if hasattr(v, "tolist"):
            v = v.tolist()
        elif hasattr(v, "item"):
            v = v.item()
        out[key] = v
    return out


__all__ = ["TraceRecorder", "TraceEvent"]
