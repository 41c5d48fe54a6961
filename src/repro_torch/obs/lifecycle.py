"""Request-lifecycle spans: queued -> prefill -> decode -> spilled -> terminal.

Every ``Request`` the engines touch gets a ``RequestRecord`` here: an
ordered chain of phase spans with engine-supplied timestamps (the same
``perf_counter`` stamps the engines put on ``t_submit``/``t_first``/
``t_done``, so derived metrics agree with ``stats()`` exactly).  The
tracker answers the questions the flat percentile stats cannot:

  * **queue delay** -- how long did *this* request wait before admission;
  * **TTFT / TPOT** -- exact per-request first-token and per-token times;
  * **preemption cost** -- total time spent spilled to host.

Phases:

  ``queued``   submitted, waiting for admission (or re-queued post-spill)
  ``prefill``  full-sequence prompt ingestion
  ``decode``   resident in the decode batch (chunked prompt tails, fork
               continuations, and steady-state generation all decode)
  ``spilled``  preempted: pages on host, waiting to resume

A terminal request has a **complete chain**: starts at ``queued``, every
span closed, terminal status recorded.  ``run(max_steps)`` surfacing a
still-active request closes its open span with an explicit
``interrupted`` marker instead -- traces never contain dangling spans;
if stepping later resumes, a fresh span opens.

Closed spans are mirrored to the trace buffer as async ``b``/``e`` pairs
(``cat="request"``, ``id=rid``) so Perfetto shows one row per request.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

__all__ = ["PhaseSpan", "RequestRecord", "LifecycleTracker", "PHASES"]

PHASES = ("queued", "prefill", "decode", "spilled")


@dataclasses.dataclass
class PhaseSpan:
    phase: str
    t0: float                      # perf_counter stamps
    t1: Optional[float] = None
    interrupted: bool = False

    @property
    def closed(self) -> bool:
        return self.t1 is not None

    @property
    def duration(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0


@dataclasses.dataclass
class RequestRecord:
    rid: int
    spans: List[PhaseSpan] = dataclasses.field(default_factory=list)
    status: Optional[str] = None   # done|aborted|truncated once terminal
    n_tokens: int = 0
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    interrupted: bool = False      # ever closed by run(max_steps) surfacing

    # ------------- chain queries -------------

    @property
    def terminal(self) -> bool:
        return self.status is not None

    @property
    def open_span(self) -> Optional[PhaseSpan]:
        if self.spans and not self.spans[-1].closed:
            return self.spans[-1]
        return None

    def complete_chain(self) -> bool:
        """Terminal + every span closed + the chain starts at ``queued``."""
        return (self.terminal and bool(self.spans)
                and self.spans[0].phase == "queued"
                and all(s.closed for s in self.spans))

    def phase_sequence(self) -> List[str]:
        return [s.phase for s in self.spans]

    # ------------- derived metrics -------------

    @property
    def queue_delay_s(self) -> float:
        """Time waiting before *first* admission (the initial queued span)."""
        for s in self.spans:
            if s.phase == "queued":
                return s.duration
        return 0.0

    @property
    def ttft_s(self) -> float:
        return (self.t_first - self.t_submit) if self.t_first > 0 else 0.0

    @property
    def tpot_s(self) -> float:
        """Per-output-token time after the first token."""
        if self.t_done > 0 and self.t_first > 0 and self.n_tokens > 1:
            return (self.t_done - self.t_first) / (self.n_tokens - 1)
        return 0.0

    @property
    def preemption_cost_s(self) -> float:
        """Total time spent spilled (plus re-queued) after preemption."""
        return sum(s.duration for s in self.spans
                   if s.phase in ("spilled",))


class LifecycleTracker:
    """Owns every request's span chain; engines drive the transitions."""

    def __init__(self, tracer=None, metrics=None):
        self.tracer = tracer
        self.metrics = metrics
        self.records: Dict[int, RequestRecord] = {}

    # ------------- internals -------------

    def _now(self) -> float:
        return time.perf_counter()

    def _close_open(self, rec: RequestRecord, t: float,
                    interrupted: bool = False) -> None:
        span = rec.open_span
        if span is None:
            return
        span.t1 = max(t, span.t0)
        span.interrupted = interrupted
        if self.tracer is not None:
            self.tracer.async_span(
                span.phase, rec.rid, "request",
                self.tracer.ts_of(span.t0), self.tracer.ts_of(span.t1),
                rid=rec.rid, interrupted=interrupted)

    # ------------- engine-driven transitions -------------

    def enqueued(self, rid: int, t: Optional[float] = None) -> None:
        t = self._now() if t is None else t
        rec = self.records.get(rid)
        if rec is None:
            rec = RequestRecord(rid, t_submit=t)
            self.records[rid] = rec
        self._close_open(rec, t)
        rec.spans.append(PhaseSpan("queued", t))

    def phase(self, rid: int, phase: str, t: Optional[float] = None) -> None:
        assert phase in PHASES, phase
        t = self._now() if t is None else t
        rec = self.records.setdefault(rid, RequestRecord(rid, t_submit=t))
        if rec.open_span is not None and rec.open_span.phase == phase:
            return                      # already in this phase
        self._close_open(rec, t)
        rec.spans.append(PhaseSpan(phase, t))

    def first_token(self, rid: int, t: Optional[float] = None) -> None:
        rec = self.records.get(rid)
        if rec is None or rec.t_first > 0:
            return
        rec.t_first = self._now() if t is None else t
        if self.metrics is not None:
            self.metrics.histogram("ttft_s").observe(
                rec.t_first - rec.t_submit)
        if self.tracer is not None:
            self.tracer.instant("first_token", cat="request",
                                track="requests",
                                ts=self.tracer.ts_of(rec.t_first), rid=rid)

    def finish(self, rid: int, status: str, n_tokens: int = 0,
               t: Optional[float] = None) -> None:
        t = self._now() if t is None else t
        rec = self.records.setdefault(rid, RequestRecord(rid, t_submit=t))
        self._close_open(rec, t)
        rec.status = status
        rec.n_tokens = n_tokens
        rec.t_done = t
        if self.metrics is not None:
            self.metrics.histogram("queue_delay_s").observe(
                rec.queue_delay_s)
            if rec.tpot_s > 0:
                self.metrics.histogram("tok_latency_s").observe(rec.tpot_s)
        if self.tracer is not None:
            self.tracer.instant("terminal", cat="request", track="requests",
                                ts=self.tracer.ts_of(t), rid=rid,
                                status=status, n_tokens=n_tokens)
            if status == "failed":
                # an explicit failure marker on the fault track: chaos-run
                # triage filters cat="fault" and sees quarantines inline
                # with the injections that caused them
                self.tracer.instant("failure", cat="fault",
                                    track="requests",
                                    ts=self.tracer.ts_of(t), rid=rid)

    def interrupt(self, rid: int, t: Optional[float] = None) -> None:
        """Close a surfaced-but-not-terminal request's open span with an
        explicit ``interrupted`` marker (the ``run(max_steps)`` contract:
        no dangling spans, no fake terminal status)."""
        rec = self.records.get(rid)
        if rec is None or rec.terminal:
            return
        t = self._now() if t is None else t
        if rec.open_span is not None:
            self._close_open(rec, t, interrupted=True)
            rec.interrupted = True

    def reopen(self, rid: int, t: Optional[float] = None) -> None:
        """Resume an interrupted request: open a fresh span in the phase
        the interrupt closed (``run()`` calls this on entry for every
        pending request; a no-op unless the request was interrupted)."""
        rec = self.records.get(rid)
        if (rec is None or rec.terminal or rec.open_span is not None
                or not rec.spans):
            return
        t = self._now() if t is None else t
        rec.spans.append(PhaseSpan(rec.spans[-1].phase, t))

    # ------------- read side -------------

    def record(self, rid: int) -> Optional[RequestRecord]:
        return self.records.get(rid)

    def terminal_records(self) -> List[RequestRecord]:
        return [r for r in self.records.values() if r.terminal]

    def open_spans(self) -> List[PhaseSpan]:
        """Spans still open across all records (should be empty whenever
        the engine has surfaced or finished everything)."""
        return [r.open_span for r in self.records.values()
                if r.open_span is not None]
