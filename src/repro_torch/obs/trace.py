"""Per-step structured trace: a bounded ring buffer of Chrome-trace events
(PyTorch port of ``repro/obs/trace.py``; no JAX in it, so the port keeps its
own copy).

Engines, scheduler and pool emit events here -- step
boundaries, admissions, evictions, fork/copy-on-write copies, per-bank
traffic counters, recompiles -- and the buffer exports them as

  * **Chrome-trace JSON** (``{"traceEvents": [...]}``) loadable in
    Perfetto / ``chrome://tracing`` (``save("out.json")``), or
  * **JSONL**, one event per line, for ad-hoc grepping
    (``save("out.jsonl")``).

Event vocabulary (Trace Event Format phase codes):

  * ``X`` complete events -- decode steps (``cat="step"``), with duration;
  * ``b``/``e`` async pairs -- request lifecycle phase spans
    (``cat="request"``, ``id=rid``): queued / prefill / decode / spilled;
    and host-tier prefetches (``cat="prefetch"``, ``id=rid``): dispatch of
    a spilled blob's device copy (issued on the pool's copy stream on the
    card) through its commit/cancel.  Prefetch pairs
    are emitted *closed* at commit time with the recorded dispatch
    timestamp (``async_span``), so an uncommitted prefetch can never leave
    a dangling ``b`` in the trace;
  * ``i`` instants -- admissions, evictions, forks, recompiles; tier
    movement (``cat="tier"``): promote / demote / prefix_hit / evict;
  * ``C`` counters -- per-bank traffic + ``conflict_factor`` each step.

Tracks (Perfetto rows) are logical: engine, scheduler, pool, requests.
The buffer is a ``deque(maxlen=capacity)`` -- a long serve run keeps the
most recent window; ``dropped`` counts what aged out.  Timestamps are
host microseconds since the buffer's construction (``perf_counter``-based):
a step's X event spans the host's view of it, which ends at the step's
device-to-host sync.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["TraceBuffer"]

#: stable track (Chrome "tid") assignment for the logical emitters
_TRACKS = ("engine", "requests", "scheduler", "pool", "counters", "jit")


class TraceBuffer:
    """Bounded ring of trace events with Chrome-trace / JSONL export."""

    def __init__(self, capacity: int = 65536, pid: int = 1):
        self.capacity = capacity
        self.pid = pid
        self._events: deque = deque(maxlen=capacity)
        self._emitted = 0
        self._t0 = time.perf_counter()
        self._tids: Dict[str, int] = {}
        self._meta: List[dict] = []     # thread_name events survive eviction
        for track in _TRACKS:
            self._tid(track)

    # ------------- time & tracks -------------

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def ts_of(self, t_abs: float) -> float:
        """Convert an absolute ``perf_counter()`` stamp to buffer time."""
        return (t_abs - self._t0) * 1e6

    def _tid(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is None:
            tid = len(self._tids)
            self._tids[track] = tid
            self._meta.append({
                "ph": "M", "name": "thread_name", "pid": self.pid,
                "tid": tid, "args": {"name": track},
            })
        return tid

    # ------------- emission -------------

    @property
    def dropped(self) -> int:
        """Events that aged out of the ring."""
        return self._emitted - len(self._events)

    def _push(self, ev: dict) -> None:
        self._events.append(ev)
        self._emitted += 1

    def instant(self, name: str, cat: str = "event", track: str = "engine",
                ts: Optional[float] = None, **args) -> None:
        self._push({"ph": "i", "name": name, "cat": cat,
                    "ts": self.now_us() if ts is None else ts, "s": "t",
                    "pid": self.pid, "tid": self._tid(track),
                    "args": args})

    def complete(self, name: str, cat: str, ts: float, dur: float,
                 track: str = "engine", **args) -> None:
        """One ``X`` event: ``ts``/``dur`` in buffer microseconds."""
        self._push({"ph": "X", "name": name, "cat": cat, "ts": ts,
                    "dur": max(dur, 0.0), "pid": self.pid,
                    "tid": self._tid(track), "args": args})

    def counter(self, name: str, values: Dict[str, float],
                cat: str = "counter", track: str = "counters",
                ts: Optional[float] = None) -> None:
        self._push({"ph": "C", "name": name, "cat": cat,
                    "ts": self.now_us() if ts is None else ts,
                    "pid": self.pid, "tid": self._tid(track),
                    "args": {k: float(v) for k, v in values.items()}})

    def async_span(self, name: str, span_id, cat: str, ts0: float,
                   ts1: float, track: str = "requests", **args) -> None:
        """A closed async span as a ``b``/``e`` pair (Perfetto groups pairs
        of one ``cat`` + ``id`` onto one async track)."""
        tid = self._tid(track)
        sid = str(span_id)
        self._push({"ph": "b", "name": name, "cat": cat, "id": sid,
                    "ts": ts0, "pid": self.pid, "tid": tid, "args": args})
        self._push({"ph": "e", "name": name, "cat": cat, "id": sid,
                    "ts": max(ts1, ts0), "pid": self.pid, "tid": tid,
                    "args": {}})

    # ------------- export -------------

    def events(self) -> List[dict]:
        """Metadata + ring contents, oldest first."""
        return self._meta + list(self._events)

    def to_chrome(self) -> dict:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def save(self, path: str) -> None:
        """Write the trace: ``*.jsonl`` gets one event per line, anything
        else gets Chrome-trace JSON (open in https://ui.perfetto.dev)."""
        if str(path).endswith(".jsonl"):
            with open(path, "w") as f:
                for ev in self.events():
                    f.write(json.dumps(ev) + "\n")
        else:
            with open(path, "w") as f:
                json.dump(self.to_chrome(), f)
