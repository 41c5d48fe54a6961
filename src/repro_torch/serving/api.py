"""Request-lifecycle serving API (PyTorch port of ``repro/serving/api.py``).

One ``ServeConfig`` selects the backend -- ``"paged"`` (the default: the
paged, bank-aware state/KV pool with a preempting scheduler, chunked
prefill and copy-on-write forks) or ``"slots"`` (a fixed
``batch x cache_capacity`` cache pool) -- and builds one ``Engine``:

    eng = Engine(params, cfg, ServeConfig())
    h = eng.submit(prompt, max_new_tokens=32)
    for tok in h:                      # drives eng.step() under the hood
        print(tok)

    chat = eng.session()
    first = chat.send(user_turn_1).result()
    reply = chat.send(user_turn_2)     # forks -- no re-prefill of turn 1

``Engine.submit()`` returns a :class:`RequestHandle` that streams tokens as
they are sampled each ``step()``, exposes the terminal status and can
``abort()`` mid-decode.  ``Engine.fork()`` continues a finished, retained
parent through copy-on-write prefix sharing; :class:`Session` wraps that
into multi-turn chat.  ``spec="ngram"`` or ``spec="model:<arch>"`` (paged
backend) decodes speculatively: up to ``spec_k`` drafted tokens per row
verified in one pass, greedy output the non-speculative stream.
``prefix_cache=True`` (paged backend) adopts stored prompt pages across
requests (the radix prefix store, pages demoted to pinned host memory under
pressure); ``fault_plan`` (or ``REPRO_FAULTS``), ``nan_guard``,
``max_queued``, ``request_timeout_s`` and ``step_budget_s`` drive the
resilience layer of the paged engine.  ``save_trace(path)`` writes the
structured trace (Chrome-trace JSON, or JSONL for ``*.jsonl``; check it
with ``python -m repro_torch.obs.schema``), ``lifecycle(handle)`` returns
one request's phase spans.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.models.config import ModelConfig
from repro_torch.obs import Observability, RequestRecord
from repro_torch.serving.engine import (EngineConfig, PagedEngineConfig,
                                        PagedServingEngine, Request,
                                        ServingEngine, TERMINAL_STATUSES)
from repro_torch.serving.sampler import SamplingConfig
from repro_torch.serving.scheduler import SchedulerConfig

__all__ = ["ServeConfig", "Engine", "RequestHandle", "Session", "Request"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """One config for both serving backends (defaults as in the JAX
    package)."""
    backend: str = "paged"             # "paged" | "slots"
    batch: int = 4                     # decode rows (slots / decode batch)
    cache_capacity: int = 256          # slots backend: max context per slot
    n_pages: Optional[int] = 33        # paged: pool pages (incl. 1 scratch)
    n_slabs: Optional[int] = None      # paged: state slabs (default 2B+1)
    byte_budget: Optional[int] = None  # paged: alternative to n_pages
    prefill_chunk: int = 128           # paged: longest full-seq prefill
    prefill_buckets: Optional[Tuple[int, ...]] = None
                                       # paged: snap prefill lengths down to
                                       # this bucket set; tail streams
                                       # through decode
    sampling: SamplingConfig = SamplingConfig()
    scheduler: SchedulerConfig = SchedulerConfig()
    seed: int = 0
    # --- tiered memory hierarchy (paged backend only) ---
    prefix_cache: bool = False         # radix prefix store: requests that
                                       # share a prompt prefix with earlier
                                       # requests adopt its pages, no fork()
    prefix_store_pages: int = 64       # store capacity in pages (LRU)
    host_tier_bytes: Optional[int] = None  # host budget (None = unmetered)
    prefetch_window: int = 2           # lookahead prefetch depth
    # --- resilience / fault injection (paged backend only) ---
    fault_plan: Optional[str] = None   # fault spec string (see
                                       # serving/faults); REPRO_FAULTS env
                                       # applies when unset
    nan_guard: Optional[bool] = None   # post-step non-finite-logits guard
                                       # (None = on iff faults active)
    max_queued: Optional[int] = None   # admission control: queue-depth cap,
                                       # excess submits end ``rejected``
    request_timeout_s: Optional[float] = None  # max queue wait -> rejected
    step_budget_s: Optional[float] = None      # watchdog wall-clock budget
    # --- speculative decoding (paged backend only) ---
    spec: Optional[str] = None         # draft source: "ngram" (self-draft)
                                       # or "model:<arch>" (small model)
    spec_k: int = 3                    # max drafts verified per step
    spec_window: int = 8               # k-controller acceptance window

    def __post_init__(self):
        if self.backend not in ("paged", "slots"):
            raise ValueError(f"backend must be 'paged' or 'slots', "
                             f"got {self.backend!r}")
        if self.backend == "slots" and self.prefix_cache:
            raise ValueError("prefix_cache needs the paged backend "
                             "(page refcounts / block tables)")
        if self.backend == "slots" and self.spec is not None:
            raise ValueError("speculative decoding needs the paged backend "
                             "(the spec_verify step walks block tables and "
                             "rolls state slabs back)")
        if self.backend == "slots":
            for f in ("fault_plan", "nan_guard", "max_queued",
                      "request_timeout_s", "step_budget_s"):
                if getattr(self, f) is not None:
                    raise ValueError(
                        f"{f} needs the paged backend (the resilience "
                        "layer lives in the paged engine / pool)")

    def engine_config(self):
        """The backend-specific config this ServeConfig lowers to."""
        if self.backend == "slots":
            return EngineConfig(slots=self.batch,
                                cache_capacity=self.cache_capacity,
                                sampling=self.sampling, seed=self.seed)
        return PagedEngineConfig(
            max_decode_batch=self.batch,
            n_pages=None if self.byte_budget is not None else self.n_pages,
            n_slabs=(self.n_slabs if self.n_slabs is not None
                     else 2 * self.batch + 1),
            byte_budget=self.byte_budget,
            prefill_chunk=self.prefill_chunk,
            prefill_buckets=self.prefill_buckets,
            sampling=self.sampling,
            scheduler=self.scheduler,
            seed=self.seed,
            prefix_cache=self.prefix_cache,
            prefix_store_pages=self.prefix_store_pages,
            host_tier_bytes=self.host_tier_bytes,
            prefetch_window=self.prefetch_window,
            fault_plan=self.fault_plan,
            nan_guard=self.nan_guard,
            max_queued=self.max_queued,
            request_timeout_s=self.request_timeout_s,
            step_budget_s=self.step_budget_s,
            spec=self.spec,
            spec_k=self.spec_k,
            spec_window=self.spec_window)


class RequestHandle:
    """A live view of one submitted request."""

    def __init__(self, engine: "Engine", req: Request):
        self._engine = engine
        self._req = req
        self._cursor = 0

    @property
    def rid(self) -> int:
        return self._req.rid

    @property
    def request(self) -> Request:
        return self._req

    @property
    def status(self) -> str:
        """queued | running | done | aborted | truncated | failed |
        rejected."""
        return self._req.status

    @property
    def finished(self) -> bool:
        return self._req.status in TERMINAL_STATUSES

    @property
    def output(self) -> List[int]:
        return list(self._req.output)

    def new_tokens(self) -> List[int]:
        """Tokens sampled since the last call (empty if none yet)."""
        out = self._req.output[self._cursor:]
        self._cursor += len(out)
        return out

    def __iter__(self) -> Iterator[int]:
        """Stream tokens, driving ``Engine.step()`` while none are pending."""
        while True:
            for tok in self.new_tokens():
                yield tok
            if self.finished:
                break
            if not self._engine.step():
                break
        for tok in self.new_tokens():
            yield tok

    def result(self) -> Request:
        """Drive the engine until this request is terminal; returns it."""
        while not self.finished and self._engine.step():
            pass
        return self._req

    def abort(self) -> bool:
        return self._engine.abort(self)


def _rid_of(handle) -> int:
    return handle.rid if isinstance(handle, RequestHandle) else int(handle)


class Engine:
    """The one serving facade over both backends; runs where ``params``
    live (the card unless they were made on the CPU).

    ``par`` (a ``dist.sharding.Parallel``, JAX's ``mesh_axes``) serves
    over a mesh: every rank builds an Engine from the same whole
    ``params`` and submits the same requests.  The model axis splits the
    heads (GQA and MLA attention, Mamba-2, the GLA family, mLSTM, the
    dense FFNs); the data axes split the decode rows
    (``dist.rows.DataRows``), the logits put together after each step.
    Every rank's host side -- scheduler, block tables, prefix store,
    tiers, drafts, sampler -- takes the same decisions, since every rank
    holds the same logits bits."""

    def __init__(self, params, cfg: ModelConfig,
                 scfg: ServeConfig = ServeConfig(),
                 obs: Optional[Observability] = None, par=None):
        self.scfg = scfg
        ecfg = scfg.engine_config()
        if scfg.backend == "slots":
            self._eng = ServingEngine(params, cfg, ecfg, obs=obs, par=par)
        else:
            self._eng = PagedServingEngine(params, cfg, ecfg, obs=obs,
                                           par=par)
        self._rids = itertools.count()

    @property
    def backend(self) -> str:
        return self._eng.backend

    @property
    def engine(self):
        """The backing engine (escape hatch: pool, scheduler, bank_report)."""
        return self._eng

    @property
    def obs(self) -> Observability:
        """The observability bundle: metrics registry, trace buffer,
        lifecycle tracker, recompile watcher."""
        return self._eng.obs

    # ------------- observability -------------

    def save_trace(self, path: str) -> None:
        """Write the structured trace: Chrome-trace JSON (Perfetto) or
        JSONL for ``*.jsonl`` paths."""
        self.obs.save_trace(path)

    def prometheus_text(self) -> str:
        """The metrics registry in Prometheus text exposition format."""
        return self.obs.prometheus_text()

    def lifecycle(self, handle) -> Optional[RequestRecord]:
        """Per-request span record (queue delay, TTFT, preemption cost)."""
        return self.obs.lifecycle.record(_rid_of(handle))

    # ------------- request lifecycle -------------

    def submit(self, prompt, *, max_new_tokens: int = 16,
               eos_id: Optional[int] = None, priority: int = 0,
               deadline: Optional[float] = None,
               retain: bool = False) -> RequestHandle:
        """Queue a new request; returns its streaming handle.  ``retain``
        (paged backend) keeps the finished request's pages pinned as a
        ``fork()`` parent until ``release()``."""
        req = Request(rid=next(self._rids),
                      prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      priority=priority, deadline=deadline, retain=retain)
        self._eng.submit(req)
        return RequestHandle(self, req)

    def fork(self, parent: RequestHandle, tokens: Sequence[int] = (), *,
             max_new_tokens: int = 16, eos_id: Optional[int] = None,
             priority: int = 0, deadline: Optional[float] = None,
             retain: bool = False) -> RequestHandle:
        """Continue a finished, retained parent without re-prefilling: the
        child shares the parent's full prefix pages copy-on-write and feeds
        only ``tokens`` after the parent's final sampled token.  Its context
        is exactly ``parent.prompt + parent.output + tokens``."""
        if self.backend != "paged":
            raise ValueError("fork() needs the paged backend "
                             "(copy-on-write prefix sharing)")
        if not parent.finished or parent.status != "done":
            raise ValueError(f"fork parent {parent.rid} is not done "
                             f"(status={parent.status}); drive it with "
                             "result() first")
        req = Request(rid=next(self._rids),
                      prompt=np.asarray(list(tokens), np.int32),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      priority=priority, deadline=deadline, retain=retain,
                      parent_rid=parent.rid)
        self._eng.submit(req)
        return RequestHandle(self, req)

    def abort(self, handle) -> bool:
        return self._eng.abort(_rid_of(handle))

    def release(self, handle) -> None:
        """Free a retained parent's pages (shared pages stay alive until the
        last fork drops its reference)."""
        self._eng.release_retained(_rid_of(handle))

    # ------------- event loop -------------

    def step(self) -> bool:
        """One event-loop iteration (admit + one batched decode step).
        True while any request is queued or running."""
        return self._eng.step()

    def has_work(self) -> bool:
        return self._eng.has_work()

    def run(self, max_steps: int = 10_000) -> List[Request]:
        return self._eng.run(max_steps=max_steps)

    def stats(self) -> Dict[str, float]:
        return self._eng.stats()

    def session(self) -> "Session":
        if self.backend != "paged":
            raise ValueError("sessions need the paged backend "
                             "(copy-on-write prefix sharing)")
        return Session(self)


class Session:
    """Multi-turn chat on copy-on-write prefix sharing: each ``send()``
    forks the previous turn instead of re-prefilling the conversation, and
    the previous turn's pages are released once the fork holds its own
    references."""

    def __init__(self, engine: Engine):
        self._engine = engine
        self._prev: Optional[RequestHandle] = None

    @property
    def turns(self) -> Optional[RequestHandle]:
        """Handle of the latest turn (None before the first send)."""
        return self._prev

    def send(self, tokens, *, max_new_tokens: int = 16,
             eos_id: Optional[int] = None) -> RequestHandle:
        """Feed the next user turn; returns the reply's streaming handle."""
        if self._prev is None:
            self._prev = self._engine.submit(
                tokens, max_new_tokens=max_new_tokens, eos_id=eos_id,
                retain=True)
            return self._prev
        prev = self._prev
        prev.result()                        # finish the previous turn
        if prev.status != "done":
            raise RuntimeError(f"previous turn ended {prev.status}; "
                               "session context is gone")
        h = self._engine.fork(prev, tokens, max_new_tokens=max_new_tokens,
                              eos_id=eos_id, retain=True)
        # the fork takes its page references at admission: drive until the
        # child is running, then the old turn's pages can drop
        while h.status == "queued" and self._engine.step():
            pass
        if h.status != "queued":
            self._engine.release(prev)
        self._prev = h
        return h

    def close(self) -> None:
        """Release the last retained turn's pages."""
        if self._prev is not None:
            if self._prev.status == "done":
                self._engine.release(self._prev)
            self._prev = None
