"""Preempting continuous-batching scheduler for the paged serving engine
(the port's copy of ``repro/serving/scheduler.py``).

Separates *policy* (who runs next, who gets evicted) from the engine's
*mechanics* (prefill, decode, page bookkeeping):

  * ``fcfs``     -- arrival order, no preemption on admission.
  * ``priority`` -- lower ``Request.priority`` runs first; an urgent waiting
    request may evict the least-urgent running one when the pool is full.
  * ``deadline`` -- earliest ``Request.deadline`` first (EDF); latest
    deadline is the preferred victim.

Preemption itself is page eviction: the engine spills the victim's
pages+slab to host memory and this queue gets the request back, to be
re-admitted (re-pinned to fresh pages) when capacity frees up.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import List, Optional, Set, Tuple


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    policy: str = "fcfs"            # fcfs | priority | deadline
    preemption: bool = True         # allow admission-driven eviction
    resume_boost: bool = True       # preempted work re-queues ahead of
                                    # equal-key fresh arrivals


class Scheduler:
    """An ordered waiting queue plus the victim-selection policy."""

    def __init__(self, cfg: SchedulerConfig = SchedulerConfig()):
        assert cfg.policy in ("fcfs", "priority", "deadline"), cfg.policy
        self.cfg = cfg
        self._heap: List[Tuple[tuple, int, object]] = []
        self._seq = itertools.count()
        # aborted rids: removal from a heap is lazy -- tombstoned entries are
        # skipped by peek/pop and pruned as they surface
        self._gone: Set[int] = set()
        self._n_live = 0

    def _key(self, req, resumed: bool = False) -> tuple:
        boost = -1 if (resumed and self.cfg.resume_boost) else 0
        if self.cfg.policy == "priority":
            return (req.priority, boost, req.t_submit)
        if self.cfg.policy == "deadline":
            dl = req.deadline if req.deadline is not None else float("inf")
            return (dl, boost, req.t_submit)
        return (0, boost, req.t_submit)

    # ------------- queue -------------

    def push(self, req, resumed: bool = False):
        # a tombstoned rid still has a stale entry in the heap; re-pushing
        # it would revive that entry as a duplicate.  Engines never reuse an
        # aborted rid, so fail loudly rather than corrupt the queue.
        assert req.rid not in self._gone, f"rid {req.rid} reuse after abort"
        heapq.heappush(self._heap,
                       (self._key(req, resumed), next(self._seq), req))
        self._n_live += 1

    def _prune(self):
        while self._heap and self._heap[0][2].rid in self._gone:
            _, _, req = heapq.heappop(self._heap)
            self._gone.discard(req.rid)

    def peek(self):
        self._prune()
        return self._heap[0][2] if self._heap else None

    def pop(self):
        self._prune()
        self._n_live -= 1
        return heapq.heappop(self._heap)[2]

    def remove(self, rid: int):
        """Abort support: drop a waiting request from the heap.  Returns the
        removed request, or None if ``rid`` is not queued.  O(n) scan to hand
        the caller its Request; the heap itself is cleaned lazily."""
        for _, _, req in self._heap:
            if req.rid == rid and rid not in self._gone:
                self._gone.add(rid)
                self._n_live -= 1
                return req
        return None

    def requests(self) -> List[object]:
        """Live (non-tombstoned) waiting requests, unordered."""
        return [req for _, _, req in self._heap if req.rid not in self._gone]

    def __len__(self) -> int:
        return self._n_live

    def __bool__(self) -> bool:
        return self._n_live > 0

    # ------------- preemption policy -------------

    def choose_victim(self, running: List[object],
                      exclude: Optional[object] = None):
        """The least-urgent running request (never ``exclude``), or None."""
        cands = [r for r in running if r is not exclude]
        if not cands:
            return None
        return max(cands, key=self._key)

    def should_preempt(self, waiting, victim) -> bool:
        """Evict ``victim`` to admit ``waiting``?  Only when the policy says
        the waiting request is strictly more urgent -- FCFS never preempts
        on admission (capacity-driven eviction is the engine's call)."""
        if not self.cfg.preemption or victim is None:
            return False
        if self.cfg.policy == "fcfs":
            return False
        return self._key(waiting) < self._key(victim)
