"""Batched serving engines (PyTorch port of ``repro/serving/engine.py``).

Two engines share the request-lifecycle machinery (``_EngineCore``): an
explicit ``step()`` event loop (admit + one batched decode step),
``submit`` / ``abort`` with terminal statuses and a ``run()`` drain wrapper,
and one ``stats()`` schema.  The streaming facade over them lives in
:mod:`repro_torch.serving.api`.

``ServingEngine`` -- the fixed slot pool: continuous batching over
``slots x cache_capacity`` preallocated caches.  Prefill runs at batch 1
per admitted request and writes its caches straight into the slot's row.

``PagedServingEngine`` -- the paged pool (``serving/memory``): state / KV
memory is page granular with a block table per request, admission follows
a priority / deadline scheduler (``serving/scheduler``), prefill is
chunked (the tail of a long prompt streams through the decode batch), the
pool preempts by page eviction (victim pages spill to host bit-exactly,
resume re-pins them), and finished requests can be **retained** as
copy-on-write ``fork`` parents.  With ``spec`` set it decodes
speculatively (``serving/spec``): a draft source proposes up to ``spec_k``
tokens per row, one verify pass scores them all, and the pool rolls state
back to the accepted prefix.  The JAX package's host tier, prefix store and
fault hooks follow in later slices (ROADMAP.md).

On the card every decode step of the paged engine launches the state-update
kernel (slab mode) once per Mamba-2 layer and the paged attention and append
kernels once per attention layer, and synchronizes with the host once, to
read the sampled tokens.  A speculative step at ``n = spec_k + 1``
positions launches the state update n times per Mamba-2 layer, the append n
times and the paged verify kernel once per attention layer.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import ops as OPS
from repro_torch.core import pimsim
from repro_torch.core.paged import PAGE_TOKENS, pages_for
from repro_torch.kernels import _build
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.obs import Observability
from repro_torch.serving.memory import PagedStatePool, SpilledRequest
from repro_torch.serving.resilience import retry_transient
from repro_torch.serving.sampler import SamplingConfig, filtered_probs, sample
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
from repro_torch.serving.spec import KController, ModelDraft, NGramDraft

#: terminal request statuses -- a request in one of these will never
#: produce another token.  ``rejected``: the paged engine shed it before it
#: ever decoded; ``failed`` is kept for the JAX schema (fault handling is a
#: later slice).
TERMINAL_STATUSES = ("done", "aborted", "truncated", "failed", "rejected")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    priority: int = 0                  # lower = more urgent (paged engine)
    deadline: Optional[float] = None   # absolute time (paged engine, EDF)
    retain: bool = False               # keep pages pinned after finish
                                       # (paged engine: enables fork())
    parent_rid: Optional[int] = None   # copy-on-write fork parent
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    status: str = "new"                # new|queued|running|<terminal>
    detail: Optional[str] = None       # why a request was rejected
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    truncated: bool = False

    @property
    def finished(self) -> bool:
        return self.status in TERMINAL_STATUSES


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    slots: int = 4                    # decode batch size
    cache_capacity: int = 256         # max context per slot (tile-aligned)
    sampling: SamplingConfig = SamplingConfig()
    seed: int = 0                     # sampling generator seed


class _OpTrafficMeter:
    """Accumulates per-op-kind SPU traffic over decode steps, from the
    registered ops' own ``traffic(plan)``.  Dense traffic is affine in the
    context length, paged traffic in the page count (whole pages stream,
    appends write one slot); either way the descriptors are probed once at
    two operating points."""

    def __init__(self, cfg: ModelConfig, layout: str = "dense",
                 metrics=None):
        self.cfg = cfg
        self.layout = layout
        self.metrics = metrics
        self.by_kind: Dict[str, float] = {}
        self._affine = None

    def _coeffs(self) -> Dict[str, tuple]:
        if self._affine is None:
            u1, u2 = ((PAGE_TOKENS, 2 * PAGE_TOKENS) if self.layout == "paged"
                      else (1, 2))
            t1 = OPS.decode_traffic_by_kind(self.cfg, 1, u1, self.layout)
            t2 = OPS.decode_traffic_by_kind(self.cfg, 1, u2, self.layout)
            self._affine = {k: (t1[k].total, t2[k].total - t1[k].total)
                            for k in t1}
        return self._affine

    def account_units(self, units: Sequence[int]) -> None:
        """One step over rows of ``units`` tokens (dense) or pages (paged)."""
        if not units:
            return
        n, total = len(units), sum(units)
        for kind, (base, slope) in self._coeffs().items():
            add = n * base + (total - n) * slope
            self.by_kind[kind] = self.by_kind.get(kind, 0.0) + add
            if self.metrics is not None:
                self.metrics.counter("op_traffic_bytes_total",
                                     kind=kind).inc(add)

    def stats(self) -> Dict[str, float]:
        return {f"op_traffic_bytes/{k}": v
                for k, v in sorted(self.by_kind.items())}


# ===========================================================================
# Shared stepper core
# ===========================================================================


def refuse_unservable(cfg: ModelConfig) -> None:
    """Raise for a model the engines cannot serve, as the JAX package's
    cannot: an encoder has no decode step, and the engines prefill token
    prompts only, so a frontend's embeddings (patches, audio frames) have
    no way in.  Such models run at model level (``models.model.prefill``,
    then ``decode_step`` for a decoder)."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: it has no decode "
                         "step to serve (run models.model.prefill)")
    if cfg.frontend is not None:
        raise ValueError(
            f"{cfg.name} takes {cfg.frontend!r} embeddings, and the serving "
            "engines prefill token prompts only, as the JAX package's do "
            "(run models.model.prefill with the embeddings, then "
            "decode_step)")


class _EngineCore:
    """Request-lifecycle machinery both engines are rebased onto.

    Subclasses implement the mechanics (``step``, ``_enqueue``,
    ``_abort_impl``, ``has_work``, ``pending_requests``); the core owns
    ``submit`` -> ``step``/``run`` -> terminal status, ``abort`` and the
    stats schema (a view over the obs metrics registry).
    """

    backend: str = "?"

    def __init__(self, cfg: ModelConfig, obs: Optional[Observability] = None):
        refuse_unservable(cfg)
        self.cfg = cfg
        self.obs = obs if obs is not None else Observability()
        self.done: List[Request] = []
        self.step_count = 0

    # ------------- public lifecycle API -------------

    def submit(self, req: Request):
        self._validate(req)
        req.t_submit = time.perf_counter()
        req.status = "queued"
        self.obs.metrics.counter("requests_submitted_total").inc()
        self.obs.lifecycle.enqueued(req.rid, t=req.t_submit)
        self._enqueue(req)

    def step(self) -> bool:
        """One event-loop iteration: admit what fits, run one batched decode
        step if anything is active.  True while work remains."""
        raise NotImplementedError

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drain: step until queue and batch are empty; returns terminal
        requests, with still-pending ones surfaced at the end (their spans
        closed as ``interrupted``) if ``max_steps`` is hit first.  Three
        steps in a row without progress shed the stuck work (``run()``
        terminates, never spins)."""
        for r in self.pending_requests():
            self.obs.lifecycle.reopen(r.rid)
        stalled = 0
        while self.has_work() and self.step_count < max_steps:
            before = (self.step_count, len(self.done))
            self.step()
            stalled = 0 if (self.step_count, len(self.done)) != before \
                else stalled + 1
            if stalled >= 3:
                self._break_stall()
                stalled = 0
        if self.has_work():
            pending = self.pending_requests()
            for r in pending:
                self.obs.lifecycle.interrupt(r.rid)
            return self.done + pending
        self._sanitize_teardown()
        return self.done

    def _sanitize_teardown(self) -> None:
        """Shadow-ledger leak check after a full drain (paged engine)."""

    def _break_stall(self) -> None:
        """Called by ``run()`` after consecutive no-progress steps: shed
        every queued request (the slot engine cannot stall; the paged engine
        overrides with a targeted drop of the unadmittable head)."""
        for r in list(self.pending_requests()):
            if r.status == "queued":
                self._abort_impl(r.rid)

    def abort(self, rid: int) -> bool:
        """Cancel a request at any lifecycle point (waiting, mid-decode,
        spilled); it lands in ``done`` with status ``aborted``.  False if
        ``rid`` is unknown or already terminal."""
        return self._abort_impl(rid)

    def has_work(self) -> bool:
        raise NotImplementedError

    def pending_requests(self) -> List[Request]:
        raise NotImplementedError

    def stats(self) -> Dict[str, float]:
        """Always the full key schema -- zeros before anything finishes."""
        m = self.obs.metrics
        pending = self.pending_requests()
        n_active = sum(1 for r in pending if r.status == "running")
        n_queued = sum(1 for r in pending if r.status == "queued")
        m.gauge("active_requests").set(n_active)
        m.gauge("queued_requests").set(n_queued)
        out: Dict[str, float] = {
            "tokens": m.value("tokens_total"),
            "wall_s": 0.0, "tokens_per_s": 0.0,
            "prefill_tokens": m.value("prefill_tokens_total"),
            "requests_done": m.value("requests_total", status="done"),
            "requests_aborted": m.value("requests_total", status="aborted"),
            "requests_truncated": m.value("requests_total",
                                          status="truncated"),
            "requests_failed": m.value("requests_total", status="failed"),
            "requests_rejected": m.value("requests_total",
                                         status="rejected"),
            "active_requests": float(n_active),
            "queued_requests": float(n_queued),
        }
        timed = [r for r in self.done if r.t_done > 0]
        if timed:
            t0 = min(r.t_submit for r in timed)
            t1 = max(r.t_done for r in timed)
            out["wall_s"] = t1 - t0
            out["tokens_per_s"] = out["tokens"] / max(t1 - t0, 1e-9)
        ttft = m.histogram("ttft_s")
        out["mean_ttft_s"] = ttft.mean
        out["p50_ttft_s"] = ttft.percentile(50)
        out["p99_ttft_s"] = ttft.percentile(99)
        steps_all = m.family_samples("step_s")
        out["p50_step_s"] = (float(np.percentile(steps_all, 50))
                             if steps_all else 0.0)
        out["p99_step_s"] = (float(np.percentile(steps_all, 99))
                             if steps_all else 0.0)
        steady = m.histogram("step_s", compile="false")
        out["p50_step_nocompile_s"] = steady.percentile(50)
        out["p99_step_nocompile_s"] = steady.percentile(99)
        out["compile_steps"] = float(
            m.histogram("step_s", compile="true").count)
        tok = m.histogram("tok_latency_s")
        out["p50_tok_latency_s"] = tok.percentile(50)
        out["p99_tok_latency_s"] = tok.percentile(99)
        out["recompiles"] = 0.0        # no recompile watcher in the port yet
        # speculation accounting is schema-stable: zeros when it is off
        proposed = m.value("spec_proposed_tokens_total")
        accepted = m.value("spec_accepted_tokens_total")
        steps = m.value("spec_verify_steps_total")
        out["proposed_tokens"] = proposed
        out["accepted_tokens"] = accepted
        out["acceptance_rate"] = accepted / proposed if proposed else 0.0
        # each verify row-step emits the accepted drafts plus one token the
        # target model produced itself, so the floor is 1.0, not 0.0
        out["accepted_tokens_per_step"] = ((accepted + steps) / steps
                                           if steps else 0.0)
        out.update(self._traffic.stats())
        return out

    # ------------- subclass hooks -------------

    def _validate(self, req: Request):
        if req.parent_rid is not None:
            raise ValueError(
                f"{type(self).__name__} does not support fork/sessions "
                "(copy-on-write prefix sharing needs the paged pool)")
        if req.retain:
            raise ValueError(
                f"{type(self).__name__} cannot retain finished requests "
                "(page refcounts need the paged pool)")

    def _enqueue(self, req: Request):
        raise NotImplementedError

    def _abort_impl(self, rid: int) -> bool:
        raise NotImplementedError

    def _finalize(self, req: Request, status: str,
                  detail: Optional[str] = None):
        req.status = status
        if detail is not None:
            req.detail = detail
        req.truncated = status == "truncated"
        req.t_done = time.perf_counter()
        self.done.append(req)
        m = self.obs.metrics
        m.counter("requests_total", status=status).inc()
        m.counter("tokens_total").inc(len(req.output))
        self.obs.lifecycle.finish(req.rid, status,
                                  n_tokens=len(req.output), t=req.t_done)

    def _count_prefill(self, n: int):
        """Fresh-context tokens ingested (prefill + streamed tails)."""
        self.obs.metrics.counter("prefill_tokens_total").inc(int(n))

    def _record_step(self, t0: float, builds_before: int):
        """The step-time histogram, tagged ``compile="true"`` when the step
        paid for a kernel build (the port's twin of a JAX compile)."""
        compiled = "true" if _build.builds_done() > builds_before else "false"
        self.obs.metrics.histogram("step_s", compile=compiled).observe(
            time.perf_counter() - t0)


# ===========================================================================
# Fixed-slot engine
# ===========================================================================


class ServingEngine(_EngineCore):
    """Continuous batching over the fixed slot pool."""

    backend = "slots"

    def __init__(self, params, cfg: ModelConfig, ecfg: EngineConfig,
                 obs: Optional[Observability] = None):
        super().__init__(cfg, obs)
        self.params = params
        self.ecfg = ecfg
        self.device = M.params_device(params)
        if cfg.pos_emb == "learned" and ecfg.cache_capacity > M.POS_ROWS:
            raise ValueError(
                f"cache_capacity {ecfg.cache_capacity} reaches past the "
                f"{M.POS_ROWS} rows of {cfg.name}'s learned position table")
        B = ecfg.slots
        self.caches = M.init_decode_caches(cfg, B, ecfg.cache_capacity,
                                           device=self.device)
        # host-side mirror of per-slot lengths: the engine is the writer of
        # record, so it streams host->device with the decode call instead
        # of being read back every step
        self.lengths = np.zeros((B,), np.int32)
        self.cur_tokens = torch.zeros((B,), dtype=torch.int64,
                                      device=self.device)
        self.active = np.zeros((B,), bool)
        self.slot_req: List[Optional[Request]] = [None] * B
        self.queue: List[Request] = []
        self._gen = torch.Generator(device=self.device).manual_seed(ecfg.seed)
        self._traffic = _OpTrafficMeter(cfg, metrics=self.obs.metrics)

    def _enqueue(self, req: Request):
        self.queue.append(req)

    def step(self) -> bool:
        self._admit()
        if self.active.any():
            self._decode_step()
        return self.has_work()

    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.active.any())

    def pending_requests(self) -> List[Request]:
        return ([r for r in self.slot_req if r is not None]
                + list(self.queue))

    def _abort_impl(self, rid: int) -> bool:
        for i, r in enumerate(self.queue):
            if r.rid == rid:
                self.queue.pop(i)
                self._finalize(r, "aborted")
                return True
        for slot, r in enumerate(self.slot_req):
            if r is not None and r.rid == rid:
                # the stale cache row is overwritten by the next admission
                self.slot_req[slot] = None
                self.active[slot] = False
                self._finalize(r, "aborted")
                return True
        return False

    def _admit(self):
        while self.queue and not self.active.all():
            slot = int(np.flatnonzero(~self.active)[0])
            self._prefill_into(slot, self.queue.pop(0))

    def _prefill_into(self, slot: int, req: Request):
        self.obs.lifecycle.phase(req.rid, "prefill", t=time.perf_counter())
        S = int(req.prompt.shape[0])
        self._count_prefill(S)
        prompt = torch.as_tensor(req.prompt, dtype=torch.int64,
                                 device=self.device)[None]
        logits, row_caches = M.prefill(self.params, self.cfg,
                                       {"tokens": prompt})
        M.write_row(self.caches, row_caches, slot, S)
        tok = int(sample(logits, self.ecfg.sampling, self._gen)[0])
        req.t_first = time.perf_counter()
        self.obs.lifecycle.first_token(req.rid, t=req.t_first)
        req.output.append(tok)
        hit_eos = req.eos_id is not None and tok == req.eos_id
        if len(req.output) >= req.max_new_tokens or hit_eos:
            self._finalize(req, "done")
            return                      # never occupies a decode slot
        self.cur_tokens[slot] = tok
        self.lengths[slot] = S
        self.active[slot] = True
        self.slot_req[slot] = req
        req.status = "running"
        self.obs.lifecycle.phase(req.rid, "decode")

    def _decode_step(self):
        self.step_count += 1
        builds = _build.builds_done()
        t0 = time.perf_counter()
        lengths = torch.from_numpy(self.lengths).to(self.device)
        logits, self.caches = M.decode_step(self.params, self.cfg,
                                            self.cur_tokens, self.caches,
                                            lengths, seed=self.step_count)
        toks = sample(logits, self.ecfg.sampling, self._gen)
        self.lengths = self.lengths + self.active.astype(np.int32)
        self.cur_tokens = toks
        # the sampled tokens are the step's single device->host sync
        toks_np = toks.cpu().numpy()
        self._record_step(t0, builds)
        lengths_np = self.lengths
        self._traffic.account_units(
            [max(int(n), 1) for n in lengths_np[self.active]])
        for slot in np.flatnonzero(self.active):
            req = self.slot_req[slot]
            req.output.append(int(toks_np[slot]))
            hit_eos = req.eos_id is not None and req.output[-1] == req.eos_id
            done = len(req.output) >= req.max_new_tokens or hit_eos
            full = int(lengths_np[slot]) + 1 >= self.ecfg.cache_capacity
            if done or full:
                self.slot_req[slot] = None
                self.active[slot] = False
                # stopped only by slot capacity: clipped, not completed
                self._finalize(req, "done" if done else "truncated")


# ===========================================================================
# Paged engine
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class PagedEngineConfig:
    max_decode_batch: int = 4         # rows in the decode step
    n_pages: Optional[int] = 33       # 128-token pages (incl. 1 scratch)
    n_slabs: int = 9                  # state slabs (incl. 1 scratch)
    byte_budget: Optional[int] = None  # alternative to n_pages
    prefill_chunk: int = 128          # longest full-sequence prefill; the
                                      # prompt tail streams through decode
    # opt-in prefill length bucketing: the full-sequence prefill length
    # snaps down to the largest bucket <= the prompt length and the rest
    # streams through the decode batch (off by default: moving tokens from
    # prefill to decode changes which op consumes which SR draw)
    prefill_buckets: Optional[Tuple[int, ...]] = None
    sampling: SamplingConfig = SamplingConfig()
    scheduler: SchedulerConfig = SchedulerConfig()
    seed: int = 0
    # --- speculative decoding (serving/spec) ---
    spec: Optional[str] = None        # draft source: None (off), "ngram"
                                      # (self-drafting) or "model:<arch>"
                                      # (small-model drafting)
    spec_k: int = 3                   # max drafts per row; the verify step
                                      # always runs at spec_k+1 positions
    spec_window: int = 8              # acceptance window of the k-controller


@dataclasses.dataclass
class _Active:
    req: Request
    length: int                       # cached positions so far
    pending: List[int]                # prompt tokens not yet consumed
    cur_token: int                    # next token to feed once prompt is done


class PagedServingEngine(_EngineCore):
    """Continuous batching over the paged, bank-aware state/KV pool."""

    backend = "paged"

    def __init__(self, params, cfg: ModelConfig, pcfg: PagedEngineConfig,
                 obs: Optional[Observability] = None):
        super().__init__(cfg, obs)
        self.params = params
        self.pcfg = pcfg
        self.device = M.params_device(params)
        self.pool = PagedStatePool(
            cfg, n_pages=None if pcfg.byte_budget is not None else pcfg.n_pages,
            n_slabs=pcfg.n_slabs, byte_budget=pcfg.byte_budget,
            device=self.device)
        self.pool.attach_obs(self.obs)
        self.sched = Scheduler(pcfg.scheduler)
        self.active: Dict[int, _Active] = {}
        self.rows: List[Optional[int]] = [None] * pcfg.max_decode_batch
        self.spilled: Dict[int, Tuple[SpilledRequest, List[int], int]] = {}
        #: finished-but-pinned requests: fork parents for sessions /
        #: N-way continuations; release_retained() frees them
        self.retained: Dict[int, _Active] = {}
        self._traffic = _OpTrafficMeter(cfg, layout="paged",
                                        metrics=self.obs.metrics)
        self.preemptions = 0
        self._occ: List[float] = []
        self._frag: List[float] = []
        self.last_traffic: Optional[np.ndarray] = None
        #: rid -> consecutive failed admission attempts (degradation rung)
        self._admit_fails: Dict[int, int] = {}
        self._gen = torch.Generator(device=self.device).manual_seed(pcfg.seed)
        if pages_for(pcfg.prefill_chunk) > self.pool.usable_pages:
            raise ValueError("prefill_chunk does not fit the page pool")
        # --- speculative decoding (serving/spec) ---
        self.draft = None
        self.kctl = None
        if pcfg.spec is not None:
            if pcfg.spec_k < 1:
                raise ValueError(f"spec_k must be at least 1, got "
                                 f"{pcfg.spec_k}")
            if pcfg.spec == "ngram":
                self.draft = NGramDraft()
            elif pcfg.spec.startswith("model:"):
                from repro_torch.configs import get_smoke_config
                dcfg = get_smoke_config(pcfg.spec.split(":", 1)[1]).with_(
                    state_quant=cfg.state_quant)
                self.draft = ModelDraft(
                    dcfg, max_requests=pcfg.max_decode_batch + 1,
                    seed=pcfg.seed, device=self.device)
            else:
                raise ValueError(
                    f"unknown spec draft source {pcfg.spec!r} "
                    "(expected 'ngram' or 'model:<arch>')")
            self.kctl = KController(pcfg.spec_k, window=pcfg.spec_window)
            # per-position seeds inside the verify step are spec_seed + i,
            # so advance by n per step to keep the streams non-overlapping
            self._spec_seed = 0

    # ------------- lifecycle -------------

    def _validate(self, req: Request):
        if req.parent_rid is not None and req.parent_rid not in self.retained:
            raise ValueError(
                f"fork parent {req.parent_rid} is not retained (submit the "
                "parent with retain=True and let it finish first)")
        if self.cfg.pos_emb == "learned":
            # the last position a request can reach: its prompt (after a
            # fork parent's positions), its new tokens, and a verify step's
            # drafts past them
            base = (self.retained[req.parent_rid].length
                    if req.parent_rid is not None else 0)
            reach = (base + len(req.prompt) + req.max_new_tokens
                     + (self.pcfg.spec_k if self.pcfg.spec else 0))
            if reach > M.POS_ROWS:
                raise ValueError(
                    f"request {req.rid} could reach position {reach - 1}, "
                    f"past the {M.POS_ROWS} rows of {self.cfg.name}'s "
                    "learned position table")

    def _enqueue(self, req: Request):
        self.sched.push(req)

    def step(self) -> bool:
        admitted = self._admit()
        if self.active:
            self._ensure_headroom()
        if self.active:
            self._decode_step()
        elif self.sched and not admitted:
            # queue non-empty but nothing fits and nothing runs: shed the
            # head loudly rather than spinning
            self._drop_queued(
                self.sched.peek(), "rejected",
                detail="cannot admit with the pool idle (request does not "
                       "fit the page budget)")
        return self.has_work()

    def _drop_queued(self, req: Request, status: str, detail: str) -> None:
        """Remove a not-yet-admitted request (queued or spilled) with full
        cleanup: scheduler entry and spill blob."""
        rid = req.rid
        self.sched.remove(rid)
        if rid in self.spilled:
            sp, _, _ = self.spilled.pop(rid)
            self.pool.drop_spilled(sp)
        self._admit_fails.pop(rid, None)
        self._finalize(req, status, detail=detail)

    def has_work(self) -> bool:
        return bool(self.sched) or bool(self.active)

    def pending_requests(self) -> List[Request]:
        return ([a.req for a in self.active.values()]
                + self.sched.requests())

    def _abort_impl(self, rid: int) -> bool:
        if rid in self.active:
            a = self.active.pop(rid)
            self._free_row(rid)
            self._spec_release(rid)
            self.pool.release(rid)
            self._finalize(a.req, "aborted")
            return True
        if rid in self.spilled:
            sp, _, _ = self.spilled.pop(rid)
            self.pool.drop_spilled(sp)
            req = self.sched.remove(rid)
            assert req is not None, "spilled request must be in the heap"
            self._finalize(req, "aborted")
            return True
        req = self.sched.remove(rid)
        if req is not None:
            self._finalize(req, "aborted")
            return True
        return False

    # ------------- retained parents / copy-on-write fork -------------

    def retained_length(self, rid: int) -> int:
        return self.retained[rid].length

    def release_retained(self, rid: int):
        """Drop a retained parent's page references (shared pages free when
        the last fork drops; must not race a never-admitted fork child)."""
        assert all(r.parent_rid != rid or r.rid in self.spilled
                   for r in self.sched.requests()), \
            f"retained {rid} still has unadmitted fork children"
        self.retained.pop(rid)
        self.pool.release(rid)

    # ------------- admission / preemption -------------

    def _admission_need(self, req: Request) -> int:
        """Pages admission must find free for ``req`` (plus one slab)."""
        if req.rid in self.spilled:
            return self.spilled[req.rid][0].pages_needed
        if req.parent_rid is not None:
            # CoW fork: at most the private tail-page copy
            return 1 if self.retained[req.parent_rid].length % PAGE_TOKENS \
                else 0
        return pages_for(min(len(req.prompt), self.pcfg.prefill_chunk))

    def _admit(self) -> bool:
        admitted = False
        while len(self.active) < self.pcfg.max_decode_batch and self.sched:
            head = self.sched.peek()
            need = self._admission_need(head)
            if not self.pool.can_admit(need):
                victim = self.sched.choose_victim(
                    [a.req for a in self.active.values()])
                if victim is not None and self.sched.should_preempt(head,
                                                                    victim):
                    self._preempt(victim.rid)
                    continue
                break
            req = self.sched.pop()
            if req.rid in self.spilled:
                ok = self._resume(req)
            elif req.parent_rid is not None:
                ok = self._fork_into(req)
            else:
                ok = self._prefill_into(req)
            if not ok:
                # transient allocation failure survived bounded retry: walk
                # the degradation ladder (the last rung sheds the request)
                self._degrade(req, need)
                continue
            self._admit_fails.pop(req.rid, None)
            admitted = True
        return admitted

    def _retry(self, site: str, fn) -> bool:
        """Bounded retry around an allocation-style pool call (the PL206
        contract: alloc sites never assert success, they retry and
        escalate)."""
        def on_retry(_k):
            self.obs.metrics.counter("fault_retries_total", site=site).inc()
        return bool(retry_transient(fn, on_retry=on_retry))

    def _degrade(self, req: Request, need: int) -> None:
        """Admission of a popped request failed after bounded retry:
        re-queue it, then preempt live work, then shed it ``rejected``.
        (The JAX ladder's first rung reclaims host-store pages; with no host
        tier here, it is a plain re-queue.)"""
        fails = self._admit_fails.get(req.rid, 0) + 1
        self._admit_fails[req.rid] = fails
        m = self.obs.metrics
        if fails == 1:
            m.counter("degradations_total", rung="requeue").inc()
        elif fails == 2:
            victim = self.sched.choose_victim(
                [a.req for a in self.active.values()])
            if victim is not None:
                self._preempt(victim.rid)
            m.counter("degradations_total", rung="preempt").inc()
        else:
            m.counter("degradations_total", rung="shed").inc()
            self._drop_queued(
                req, "rejected",
                detail=f"admission failed after retries (need {need} pages)")
            return
        req.status = "queued"
        self.sched.push(req, resumed=True)

    def _assign_row(self, rid: int):
        self.rows[self.rows.index(None)] = rid
        if self.draft is not None:
            # draft-side admission is best-effort: a refusal (draft pool
            # full) just means this request decodes without drafts for now
            self.draft.admit(rid, list(map(int, self.active[rid].req.prompt)))

    def _free_row(self, rid: int):
        self.rows[self.rows.index(rid)] = None

    def _spec_release(self, rid: int) -> None:
        """Drop every speculation-side trace of a terminal request: drafted-
        but-unverified tokens die with the draft state (they were never in
        ``req.output``), draft-model pages free, acceptance history resets."""
        if self.draft is not None:
            self.draft.release(rid)
        if self.kctl is not None:
            self.kctl.forget(rid)

    def _bucket_prefill_len(self, n: int) -> int:
        """Full-sequence prefill length for an ``n``-token prompt:
        ``min(n, prefill_chunk)``, snapped down to the largest of
        ``prefill_buckets`` that fits (when set)."""
        s0 = min(n, self.pcfg.prefill_chunk)
        fits = [b for b in (self.pcfg.prefill_buckets or ()) if 0 < b <= s0]
        return max(fits) if fits else s0

    def _start(self, a: _Active) -> None:
        """Seat an admitted request in a decode row."""
        self.active[a.req.rid] = a
        self._assign_row(a.req.rid)
        a.req.status = "running"
        self.obs.lifecycle.phase(a.req.rid, "decode")

    def _prefill_into(self, req: Request) -> bool:
        self.obs.lifecycle.phase(req.rid, "prefill", t=time.perf_counter())
        s0 = self._bucket_prefill_len(len(req.prompt))
        if not self._retry("alloc",
                           lambda: self.pool.register(req.rid, pages_for(s0))):
            return False
        # the whole prompt is fresh context: s0 through full-sequence
        # prefill, the tail streamed through the decode batch
        self._count_prefill(len(req.prompt))
        prompt = torch.as_tensor(req.prompt[:s0], dtype=torch.int64,
                                 device=self.device)[None]
        logits, row_caches = M.prefill(self.params, self.cfg,
                                       {"tokens": prompt})
        self.pool.insert_prefill(req.rid, row_caches)
        a = _Active(req, length=s0, pending=list(map(int, req.prompt[s0:])),
                    cur_token=-1)
        if not a.pending:
            tok = int(sample(logits, self.pcfg.sampling, self._gen)[0])
            req.t_first = time.perf_counter()
            self.obs.lifecycle.first_token(req.rid, t=req.t_first)
            req.output.append(tok)
            a.cur_token = tok
        self._start(a)
        if req.output and (len(req.output) >= req.max_new_tokens
                           or (req.eos_id is not None
                               and req.output[-1] == req.eos_id)):
            self._finish(req.rid)       # prefill already produced the end
        return True

    def _fork_into(self, req: Request) -> bool:
        """Admit a copy-on-write fork: share the retained parent's full
        prefix pages, copy only its partial tail page + slab, and stream the
        continuation (the parent's final sampled token, then the new turn's
        tokens) through the decode batch -- no re-prefill of the prefix."""
        parent = self.retained[req.parent_rid]
        if not self._retry("alloc", lambda: self.pool.fork(
                req.parent_rid, req.rid, parent.length)):
            return False
        pending = [int(parent.cur_token)] + list(map(int, req.prompt))
        self._count_prefill(len(pending))
        self._start(_Active(req, length=parent.length, pending=pending,
                            cur_token=-1))
        return True

    def _resume(self, req: Request) -> bool:
        sp, pending, cur = self.spilled[req.rid]
        if not self._retry("alloc", lambda: self.pool.resume(req.rid, sp)):
            return False
        del self.spilled[req.rid]
        self._start(_Active(req, sp.length, pending, cur))
        return True

    def _preempt(self, rid: int):
        """Evict by page spill: state leaves the device bit-exactly and the
        request goes back to the scheduler queue."""
        a = self.active.pop(rid)
        self._free_row(rid)
        if self.draft is not None:
            self.draft.suspend(rid)
        sp = self.pool.spill(rid, a.length)
        self.spilled[rid] = (sp, a.pending, a.cur_token)
        a.req.status = "queued"
        self.obs.lifecycle.phase(rid, "spilled")
        self.obs.metrics.counter("preemptions_total").inc()
        self.sched.push(a.req, resumed=True)
        self.preemptions += 1

    def _finish(self, rid: int, truncated: bool = False):
        a = self.active.pop(rid)
        self._free_row(rid)
        self._spec_release(rid)
        if a.req.retain and not truncated:
            self.retained[rid] = a      # pages stay pinned: a fork parent
        else:
            self.pool.release(rid)
        self._finalize(a.req, "truncated" if truncated else "done")

    def _ensure_headroom(self):
        """Every active request must own the page its next token writes --
        and with speculation on, every page an *accepted* draft could write
        (a generation row may commit up to ``spec_k + 1`` tokens per step,
        none of which may land on the scratch page); when the pool is
        short, preempt the least urgent other request (or truncate this one
        when it is alone)."""
        for rid in list(self.active):
            a = self.active.get(rid)
            if a is None:
                continue
            span = (self.pcfg.spec_k
                    if self.draft is not None and not a.pending else 0)
            needed = (a.length + span) // PAGE_TOKENS + 1
            while needed > len(self.pool.page_table[rid]):
                short = needed - len(self.pool.page_table[rid])
                if self._retry("alloc",
                               lambda: self.pool.grow(rid, short)):
                    break
                victim = self.sched.choose_victim(
                    [b.req for b in self.active.values()], exclude=a.req)
                if victim is None:
                    self._finish(rid, truncated=True)
                    break
                self._preempt(victim.rid)

    # ------------- the decode step -------------

    def _decode_step(self):
        if self.draft is not None:
            self._spec_decode_step()
            return
        self.step_count += 1
        B = self.pcfg.max_decode_batch
        tokens = np.zeros((B,), np.int32)
        lengths = np.zeros((B,), np.int32)
        for row, rid in enumerate(self.rows):
            if rid is None:
                continue
            a = self.active[rid]
            tokens[row] = a.pending[0] if a.pending else a.cur_token
            lengths[row] = a.length
        builds = _build.builds_done()
        t0 = time.perf_counter()
        logits = self.pool.decode(self.params, self.rows, tokens, lengths,
                                  seed=self.step_count)
        toks = sample(logits, self.pcfg.sampling, self._gen)
        # the sampled tokens are the step's single device->host sync
        toks_np = toks.cpu().numpy()
        self._record_step(t0, builds)
        self._account_step(lengths, 1)

        for row, rid in enumerate(self.rows):
            if rid is None:
                continue
            a = self.active[rid]
            a.length += 1
            if a.pending:
                a.cur_token = a.pending.pop(0)
                if a.pending:
                    continue            # still consuming the prompt
                # that was the last prompt token: this step's logits are
                # the first-generation distribution
                if not a.req.t_first:
                    a.req.t_first = time.perf_counter()
                    self.obs.lifecycle.first_token(rid, t=a.req.t_first)
            tok = int(toks_np[row])
            a.req.output.append(tok)
            a.cur_token = tok
            req = a.req
            hit_eos = req.eos_id is not None and req.output[-1] == req.eos_id
            if len(req.output) >= req.max_new_tokens or hit_eos:
                self._finish(rid)

    def _account_step(self, lengths: np.ndarray, n: int) -> None:
        """Traffic, bank, occupancy and fragmentation of one step whose rows
        attend ``lengths + n`` positions (n = 1 for a plain step; a verify
        pass streams its pages once for all n).  A copy-on-write page
        streamed for several forks is attributed once."""
        seen_pages = set()
        units = []
        for row, rid in enumerate(self.rows):
            if rid is None:
                continue
            table = self.pool.page_table[rid]
            npg = min(pages_for(int(lengths[row]) + n), len(table))
            fresh = [p for p in table[:npg] if p not in seen_pages]
            seen_pages.update(fresh)
            units.append(max(len(fresh), 1))
        self._traffic.account_units(units)

        rids = [r for r in self.rows if r is not None]
        self.last_traffic = self.pool.bank_traffic(rids)
        self._occ.append(self.pool.occupancy())
        self._frag.append(self.pool.fragmentation(
            {r: self.active[r].length for r in rids}))
        bank = pimsim.bank_trace_counters(self.last_traffic)
        self.obs.metrics.gauge("bank_conflict_factor").set(
            bank["conflict_factor"])
        self.obs.metrics.gauge("bank_step_us").set(bank["t_real_us"])

    # ------------- the speculative decode step -------------

    def _spec_decode_step(self):
        """One continuous-batching step with speculative verification.

        Every active row rides the same verify pass at the fixed width
        ``n = spec_k + 1``: generation rows carry their current token plus
        up to ``k`` drafted continuations, prompt-streaming rows carry one
        real position padded with garbage.  Afterwards the recurrent state
        is rolled back per row to exactly the accepted prefix
        (``commit_spec``), which also unwinds the garbage positions.

        Greedy rows emit the model's own argmax stream -- drafts only decide
        how many of those tokens one pass may confirm -- so greedy output
        is the non-speculative stream wherever the verify pass's position
        rows equal the plain step's.  Sampled rows use rejection sampling
        against :func:`filtered_probs` with numpy draws seeded by
        ``(seed, step, row)``, as the JAX engine does.
        """
        self.step_count += 1
        B = self.pcfg.max_decode_batch
        n = self.pcfg.spec_k + 1
        tokens = np.zeros((B, n), np.int32)
        lengths = np.zeros((B,), np.int32)
        drafts: Dict[int, List[int]] = {}
        for row, rid in enumerate(self.rows):
            if rid is None:
                continue
            a = self.active[rid]
            lengths[row] = a.length
            if a.pending:
                tokens[row, 0] = a.pending[0]   # positions 1.. are garbage
                continue
            # the budget keeps one fully-accepted step inside the request's
            # remaining token allowance
            budget = min(self.kctl.k_for(rid), self.pcfg.spec_k,
                         a.req.max_new_tokens - len(a.req.output) - 1)
            d = []
            if budget > 0:
                ctx = list(map(int, a.req.prompt)) + list(a.req.output)
                d = [int(t) for t in
                     self.draft.propose(rid, ctx, budget)[:budget]]
            drafts[rid] = d
            tokens[row, 0] = a.cur_token
            tokens[row, 1:1 + len(d)] = d
        builds = _build.builds_done()
        t0 = time.perf_counter()
        # every row's block table must span the garbage positions too: the
        # append kernel refuses a slot outside the table
        min_pages = max(pages_for(int(lengths[row]) + n)
                        for row, rid in enumerate(self.rows)
                        if rid is not None)
        seed = self._spec_seed
        self._spec_seed += n
        logits, snaps = self.pool.decode_spec(
            self.params, self.rows, tokens, lengths, seed=seed,
            min_pages=min_pages)
        greedy = self.pcfg.sampling.temperature <= 0.0
        if greedy:
            # the sampler's greedy op, so ties break as in plain decoding;
            # the step's device->host sync
            g = torch.argmax(logits, dim=-1).cpu().numpy()
        else:
            probs = filtered_probs(logits, self.pcfg.sampling).cpu().numpy()
        sel = np.zeros((B,), np.int64)
        emits: Dict[int, List[int]] = {}
        for row, rid in enumerate(self.rows):
            if rid is None:
                continue
            a = self.active[rid]
            if a.pending:
                continue                      # single real position: sel = 0
            d = drafts.get(rid, [])
            if greedy:
                m = 0
                while m < len(d) and d[m] == int(g[row, m]):
                    m += 1
                emit = [int(g[row, j]) for j in range(m + 1)]
            else:
                emit = self._rejection_sample(probs[row], d, row)
            if a.req.eos_id is not None and a.req.eos_id in emit:
                emit = emit[:emit.index(a.req.eos_id) + 1]
            sel[row] = len(emit) - 1
            emits[rid] = emit
        # roll state back to the accepted prefix before any host-side
        # bookkeeping -- prompt rows too: their garbage padding advanced
        # the recurrent state
        self.pool.commit_spec(self.rows, snaps, sel)
        self._record_step(t0, builds)
        self._account_step(lengths, n)
        n_proposed = n_accepted = n_steps = 0
        for row, rid in enumerate(self.rows):
            if rid is None:
                continue
            a = self.active[rid]
            if a.pending:
                a.length += 1
                a.cur_token = a.pending.pop(0)
                if a.pending:
                    continue
                tok = (int(g[row, 0]) if greedy else int(
                    np.random.default_rng(
                        (self.pcfg.seed, self.step_count, row)
                    ).choice(probs.shape[-1],
                             p=probs[row, 0] / probs[row, 0].sum())))
                if not a.req.t_first:
                    a.req.t_first = time.perf_counter()
                    self.obs.lifecycle.first_token(rid, t=a.req.t_first)
                a.req.output.append(tok)
                a.cur_token = tok
            else:
                emit = emits[rid]
                proposed = len(drafts.get(rid, []))
                # the last emitted token is the model's own (correction or
                # bonus), so drafts surviving into the stream are len - 1,
                # capped by proposed (an eos cut can only shorten it)
                accepted = min(len(emit) - 1, proposed)
                self.kctl.observe(rid, proposed, accepted)
                n_proposed += proposed
                n_accepted += accepted
                n_steps += 1
                a.length += len(emit)
                if not a.req.t_first:
                    a.req.t_first = time.perf_counter()
                    self.obs.lifecycle.first_token(rid, t=a.req.t_first)
                a.req.output.extend(emit)
                a.cur_token = emit[-1]
            req = a.req
            hit_eos = (req.eos_id is not None and req.output
                       and req.output[-1] == req.eos_id)
            if len(req.output) >= req.max_new_tokens or hit_eos:
                self._finish(rid)
        m = self.obs.metrics
        m.counter("spec_proposed_tokens_total").inc(n_proposed)
        m.counter("spec_accepted_tokens_total").inc(n_accepted)
        m.counter("spec_verify_steps_total").inc(n_steps)

    def _rejection_sample(self, probs: np.ndarray, d: List[int],
                          row: int) -> List[int]:
        """Sampled-mode acceptance of drafts ``d`` against the target's
        per-position distributions ``probs (n, V)``: accept draft t with
        probability p(t), else emit a correction from the residual
        max(0, p - q) of the one-hot draft q and stop; all accepted: one
        bonus draw from the next position.  Draws from numpy's
        ``default_rng((seed, step, row))``, as the JAX engine's."""
        rng = np.random.default_rng((self.pcfg.seed, self.step_count, row))
        emit = []
        for j, t in enumerate(d):
            pj = probs[j]
            pj = pj / pj.sum()
            if rng.random() < pj[t]:
                emit.append(t)                # accepted with probability p(t)
                continue
            q = pj.copy()
            q[t] = 0.0
            s = q.sum()
            if s <= 0.0:
                emit.append(t)                # p was a point mass on t
                continue
            emit.append(int(rng.choice(len(q), p=q / s)))
            return emit
        pj = probs[len(d)]
        emit.append(int(rng.choice(len(pj), p=pj / pj.sum())))
        return emit

    def _break_stall(self) -> None:
        """No-progress steps in ``run()``: shed the unadmittable queue head
        with a clear reason instead of spinning forever."""
        head = self.sched.peek() if self.sched else None
        if head is None:
            super()._break_stall()
            return
        self.obs.metrics.counter("stalls_broken_total").inc()
        self._drop_queued(
            head, "rejected",
            detail="engine made no progress for 3 consecutive steps with "
                   "this request at the head of the queue")

    def _sanitize_teardown(self) -> None:
        # only once the spill set is empty: engine-held SpilledRequest
        # objects legitimately own shared pages mid-flight
        if not self.spilled:
            self.pool.sanitizer_check_leaks(
                what=f"drained paged engine (step {self.step_count})")
            if isinstance(self.draft, ModelDraft):
                self.draft.sanitizer_check_leaks(
                    what=f"drained draft pool (step {self.step_count})")

    # ------------- stats -------------

    def stats(self) -> Dict[str, float]:
        out = super().stats()
        out.update({
            "preemptions": float(self.preemptions),
            "occupancy": float(np.mean(self._occ)) if self._occ else 0.0,
            "fragmentation": (float(np.mean(self._frag))
                              if self._frag else 0.0),
            # bytes still moved by gather/scatter: spill/resume, prefill
            # insertion and the one-page fork copy -- the decode loop adds 0
            "gather_bytes": float(self.pool.gather_bytes),
            "pages_allocated": float(self.pool.pages_allocated),
            "shared_page_hits": float(self.pool.shared_page_hits),
            "shared_page_savings": float(self.pool.shared_savings_peak),
            "shared_page_savings_live": float(self.pool.shared_page_savings),
        })
        # the host tier and prefix store are a later slice: schema-stable
        # zeros, as the JAX engine reports with them off
        for k in ("prefix_hits", "prefix_hit_pages", "prefix_hit_tokens",
                  "prefix_store_pages", "prefetch_commits", "tier_hits",
                  "tier_misses", "promote_bytes", "demote_bytes",
                  "host_bytes"):
            out[k] = 0.0
        return out

    def bank_report(self) -> Dict[str, float]:
        """Score the pool's *actual* page map with the PIM timing model."""
        m = self.last_traffic
        if m is None:
            m = self.pool.bank_traffic(list(self.active))
        rep = pimsim.placement_step_latency(m, pimsim.SystemConfig())
        rep["imbalance"] = self.pool.placement.imbalance()
        return rep
