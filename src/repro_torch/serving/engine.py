"""Batched serving over the fixed slot pool (PyTorch port of the
``ServingEngine`` of ``repro/serving/engine.py``).

``ServingEngine`` runs continuous batching over ``slots x cache_capacity``
preallocated caches: an explicit ``step()`` event loop (admit what fits +
one batched decode step), ``submit`` / ``abort`` with terminal statuses
(``done`` / ``aborted`` / ``truncated``) and a ``run()`` drain wrapper.
Prefill runs at batch 1 per admitted request and writes its caches straight
into the slot's row (:func:`repro_torch.models.model.write_row`).

On the card every decode step launches the fused MX8 state-update kernel
once per Mamba-2 layer and the MX8 decode-attention kernel once per
attention layer, and synchronizes with the host once, to read the sampled
tokens.  The paged pool (``PagedServingEngine``) is the next slice of the
port (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import ops as OPS
from repro_torch.kernels import _build
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.obs import Observability
from repro_torch.serving.sampler import SamplingConfig, sample

#: terminal request statuses of the slot engine (the JAX package's paged
#: engine adds ``failed`` / ``rejected``; ``stats()`` keeps their counters)
TERMINAL_STATUSES = ("done", "aborted", "truncated")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    output: List[int] = dataclasses.field(default_factory=list)
    status: str = "new"                # new|queued|running|done|aborted|
                                       # truncated
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
    registered ops' own ``traffic(plan)`` at each active row's context
    length (affine in the length: probed once at 1 and 2 tokens)."""

    def __init__(self, cfg: ModelConfig, metrics=None):
        self.cfg = cfg
        self.metrics = metrics
        self.by_kind: Dict[str, float] = {}
        self._affine = None

    def _coeffs(self) -> Dict[str, tuple]:
        if self._affine is None:
            t1 = OPS.decode_traffic_by_kind(self.cfg, 1, 1)
            t2 = OPS.decode_traffic_by_kind(self.cfg, 1, 2)
            self._affine = {k: (t1[k].total, t2[k].total - t1[k].total)
                            for k in t1}
        return self._affine

    def account_step(self, lengths: Sequence[int]) -> None:
        units = [max(int(L), 1) for L in lengths]
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


class ServingEngine:
    """Continuous batching over the fixed slot pool.

    ``submit`` -> ``step``/``run`` -> terminal status, plus ``abort``;
    ``stats()`` keeps the JAX slot engine's key set.
    """

    backend = "slots"

    def __init__(self, params, cfg: ModelConfig, ecfg: EngineConfig,
                 obs: Optional[Observability] = None):
        self.cfg = cfg
        self.obs = obs if obs is not None else Observability()
        self.done: List[Request] = []
        self.step_count = 0
        self.params = params
        self.ecfg = ecfg
        self.device = M.params_device(params)
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

    # ------------- public lifecycle API -------------

    def submit(self, req: Request):
        req.t_submit = time.perf_counter()
        req.status = "queued"
        self.obs.metrics.counter("requests_submitted_total").inc()
        self.obs.lifecycle.enqueued(req.rid, t=req.t_submit)
        self.queue.append(req)

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drain: step until queue and batch are empty; returns terminal
        requests, with still-pending ones surfaced at the end (their spans
        closed as ``interrupted``) if ``max_steps`` is hit first."""
        for r in self.pending_requests():
            self.obs.lifecycle.reopen(r.rid)
        while self.has_work() and self.step_count < max_steps:
            self.step()
        if self.has_work():
            pending = self.pending_requests()
            for r in pending:
                self.obs.lifecycle.interrupt(r.rid)
            return self.done + pending
        return self.done


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
        out["recompiles"] = 0.0        # no recompile watcher in this slice
        # speculation is schema-stable and zero here (paged engine only)
        for k in ("proposed_tokens", "accepted_tokens", "acceptance_rate",
                  "accepted_tokens_per_step"):
            out[k] = 0.0
        out.update(self._traffic.stats())
        return out

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

    def abort(self, rid: int) -> bool:
        """Cancel a queued or running request; its slot frees immediately
        and it lands in ``done`` with status ``aborted``."""
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

    # ------------- internals -------------

    def _finalize(self, req: Request, status: str):
        req.status = status
        req.truncated = status == "truncated"
        req.t_done = time.perf_counter()
        self.done.append(req)
        m = self.obs.metrics
        m.counter("requests_total", status=status).inc()
        m.counter("tokens_total").inc(len(req.output))
        self.obs.lifecycle.finish(req.rid, status,
                                  n_tokens=len(req.output), t=req.t_done)

    def _admit(self):
        while self.queue and not self.active.all():
            slot = int(np.flatnonzero(~self.active)[0])
            self._prefill_into(slot, self.queue.pop(0))

    def _prefill_into(self, slot: int, req: Request):
        t_p0 = time.perf_counter()
        self.obs.lifecycle.phase(req.rid, "prefill", t=t_p0)
        S = int(req.prompt.shape[0])
        self.obs.metrics.counter("prefill_tokens_total").inc(S)
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
        # a step that paid for a kernel build is tagged like a JAX compile
        compiled = "true" if _build.builds_done() > builds else "false"
        self.obs.metrics.histogram("step_s", compile=compiled).observe(
            time.perf_counter() - t0)
        lengths_np = self.lengths
        self._traffic.account_step(lengths_np[self.active])
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
