"""Bank-aware page placement for the paged state/KV pool (the port's copy
of ``repro/serving/memory/placement.py``; pure Python and numpy).

Pimba puts one SPU per two DRAM banks and interleaves accesses between the
bank pair (paper Fig. 8), so *where* a page lands -- which pseudo-channel and
which bank pair -- decides whether a decode step's traffic pipelines cleanly
or serializes on a hot bank pair.  The placement policy here mirrors that
argument in software:

  * every physical page id has a static (pseudo-channel, bank-pair)
    coordinate, striped channel-first so consecutive ids land on different
    pseudo-channels (the widest parallelism axis);
  * allocation is load-aware: among coordinates that still have free pages,
    pick the one with the least *live* allocated pages, so the concurrent
    traffic of a decode batch spreads across SPUs instead of piling onto one
    bank pair.

The resulting page map is what :mod:`repro_torch.core.pimsim` scores with
``placement_step_latency`` -- real allocations instead of idealized uniform
traffic.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class BankTopology:
    """The coordinate space pages are placed into.

    Defaults are one HBM device's worth of Pimba SPUs: 16 pseudo-channels,
    16 banks each => 8 bank pairs per pseudo-channel (paper Table 1).
    """
    pseudo_channels: int = 16
    bank_pairs: int = 8

    @property
    def n_coords(self) -> int:
        return self.pseudo_channels * self.bank_pairs

    def coord(self, page_id: int) -> Tuple[int, int]:
        """Static page id -> (pseudo-channel, bank-pair), channel-striped."""
        return (page_id % self.pseudo_channels,
                (page_id // self.pseudo_channels) % self.bank_pairs)


class BankAwarePlacement:
    """Free-page bookkeeping with load-balanced, bank-aware allocation.

    Page id 0 is reserved as the scratch page that inactive decode rows write
    into; it is never handed out.
    """

    def __init__(self, n_pages: int, topo: Optional[BankTopology] = None,
                 reserved: Sequence[int] = (0,)):
        self.topo = topo or BankTopology()
        self.n_pages = n_pages
        self.reserved = frozenset(reserved)
        self._free: Dict[Tuple[int, int], Deque[int]] = {}
        for pid in range(n_pages):
            if pid in self.reserved:
                continue
            self._free.setdefault(self.topo.coord(pid), deque()).append(pid)
        # live allocated-page count per coordinate (the balance target)
        self._live = np.zeros(
            (self.topo.pseudo_channels, self.topo.bank_pairs), np.int64)
        self._n_free = n_pages - len(self.reserved)
        # copy-on-write sharing: physical page id -> reference count.  A page
        # leaves the free list with one reference; forked requests take extra
        # references on a parent's immutable full pages; the page returns to
        # the free list only when the last owner drops it.
        self._refs: Dict[int, int] = {}
        self._extra_peak = 0
        #: optional repro_torch.obs MetricsRegistry -- when attached (via
        #: ``PagedStatePool.attach_obs``) alloc/free/ref mirror into
        #: ``pages_alloc_total`` / ``pages_freed_total`` /
        #: ``page_refs_total`` counters and the ``pages_live`` gauge
        self.metrics = None
        #: shadow-ledger sanitizer (``REPRO_SANITIZE=1``): an independent
        #: refcount mirror that raises SanitizerError on double-free,
        #: ref-on-free, free-with-sharers, double-alloc, use-after-evict,
        #: and teardown leaks.  Lazy import: runtime.py is stdlib-only and
        #: must not be paid for when the sanitizer is off.
        self._shadow = None
        import os as _os
        if _os.environ.get("REPRO_SANITIZE", "").strip() not in \
                ("", "0", "false"):
            from repro_torch.analysis.lint import runtime as _rt
            _rt.attach(self)

    # ------------- allocation -------------

    @property
    def n_free(self) -> int:
        return self._n_free

    @property
    def n_usable(self) -> int:
        return self.n_pages - len(self.reserved)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages from the least-loaded bank pairs, or None."""
        if n > self._n_free:
            return None
        out: List[int] = []
        for _ in range(n):
            best = min((c for c, dq in self._free.items() if dq),
                       key=lambda c: (int(self._live[c]), c))
            out.append(self._free[best].popleft())
            self._live[best] += 1
        self._n_free -= n
        for pid in out:
            self._refs[pid] = 1
        if self._shadow is not None:
            self._shadow.on_alloc(out)
        if self.metrics is not None:
            self.metrics.counter("pages_alloc_total").inc(n)
            self.metrics.gauge("pages_live").set(self.n_usable - self._n_free)
        return out

    def ref(self, pages: Sequence[int]):
        """Take one extra (copy-on-write) reference on each page."""
        if self._shadow is not None:
            self._shadow.on_ref(pages)
        for pid in pages:
            assert self._refs.get(pid, 0) >= 1, f"ref on free page {pid}"
            self._refs[pid] += 1
        self._extra_peak = max(self._extra_peak, self.n_shared_extra)
        if self.metrics is not None:
            self.metrics.counter("page_refs_total").inc(len(pages))

    def refcount(self, pid: int) -> int:
        return self._refs.get(pid, 0)

    def unref(self, pages: Sequence[int]) -> List[int]:
        """Drop one reference per page; pages whose count hits zero return to
        the free list.  Returns the page ids actually freed."""
        if self._shadow is not None:
            self._shadow.pre_unref(pages)
        freed: List[int] = []
        for pid in pages:
            n = self._refs[pid] - 1
            if n > 0:
                self._refs[pid] = n
                continue
            del self._refs[pid]
            c = self.topo.coord(pid)
            self._free[c].append(pid)
            self._live[c] -= 1
            freed.append(pid)
        self._n_free += len(freed)
        if self._shadow is not None:
            self._shadow.on_unref(pages, freed)
        if self.metrics is not None and freed:
            self.metrics.counter("pages_freed_total").inc(len(freed))
            self.metrics.gauge("pages_live").set(self.n_usable - self._n_free)
        return freed

    # back-compat alias: pre-refcount callers freed unconditionally; with
    # single-owner pages (refcount 1) unref is exactly the old free
    free = unref

    @property
    def n_shared_extra(self) -> int:
        """Extra references beyond one owner per live page -- the number of
        physical pages copy-on-write sharing is currently saving."""
        return sum(self._refs.values()) - len(self._refs)

    @property
    def shared_extra_peak(self) -> int:
        """High-water mark of :attr:`n_shared_extra` over the pool's life."""
        return self._extra_peak

    # ------------- accounting -------------

    def live_map(self) -> np.ndarray:
        """(pseudo_channels, bank_pairs) live allocated-page counts."""
        return self._live.copy()

    def traffic_map(self, page_lists: Sequence[Sequence[int]],
                    bursts_per_page: float) -> np.ndarray:
        """Column bursts per (pch, bank-pair) for one decode step.

        ``page_lists`` is one list of physical page ids per active request --
        a decode step streams every resident page of every active request
        (KV attention reads the whole context).
        """
        m = np.zeros((self.topo.pseudo_channels, self.topo.bank_pairs))
        for pages in page_lists:
            for pid in pages:
                m[self.topo.coord(pid)] += bursts_per_page
        return m

    def imbalance(self) -> float:
        """max/mean live load across bank pairs (1.0 == perfectly even)."""
        mean = self._live.mean()
        if mean == 0:
            return 1.0
        return float(self._live.max() / mean)
