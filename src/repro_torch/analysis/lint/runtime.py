"""Runtime shadow-ledger sanitizer (``PL25x``) -- the port's copy of
``repro/analysis/lint/runtime.py``.

A :class:`ShadowLedger` mirrors every refcount transition the real
allocator performs -- alloc, ref, unref, free -- in an independent
bookkeeping structure, and raises :class:`SanitizerError` the moment the
two disagree:

  * ``PL250`` ref on a page that is not live (use-after-free acquire)
  * ``PL251`` unref below zero (double-free)
  * ``PL252`` page returned to the free list with live sharers
  * ``PL253`` allocator handed out an already-live page (double-alloc)
  * ``PL254`` a block table references a non-live page (use-after-evict)
  * ``PL255`` pages still live at engine teardown (leak)

Enable with ``REPRO_SANITIZE=1``: :class:`BankAwarePlacement
<repro_torch.serving.memory.placement.BankAwarePlacement>` attaches a ledger
to itself at construction and calls the hooks from ``alloc``/``ref``/
``unref``.
The hooks are O(pages touched) dict updates -- roughly 2-5% overhead on the
serving smoke tests, negligible next to a device step.

This module must stay import-light (stdlib only): ``placement`` imports it
lazily, and importing anything from ``repro_torch.serving`` here would
cycle.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional

_ENV_FLAG = "REPRO_SANITIZE"


def sanitize_enabled() -> bool:
    """True when the shadow-ledger sanitizer is switched on via env."""
    return os.environ.get(_ENV_FLAG, "").strip() not in ("", "0", "false")


class SanitizerError(AssertionError):
    """A shadow-ledger violation.  ``code`` is the ``PL25x`` rule id."""

    def __init__(self, code: str, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code
        self.message = message


class ShadowLedger:
    """Independent refcount mirror for one placement/allocator instance."""

    def __init__(self, n_pages: Optional[int] = None):
        self.n_pages = n_pages
        self._rc: Dict[int, int] = {}       # live page -> shadow refcount
        self.events = 0                     # transitions observed

    # -- transition hooks (called by the real allocator) ---------------

    def on_alloc(self, pages: Iterable[int]) -> None:
        self.events += 1
        for pid in pages:
            if pid in self._rc:
                raise SanitizerError(
                    "PL253", f"page {pid} allocated while already live "
                             f"(shadow rc={self._rc[pid]})")
            if self.n_pages is not None and not 0 <= pid < self.n_pages:
                raise SanitizerError(
                    "PL253", f"allocator produced out-of-range page {pid} "
                             f"(pool has {self.n_pages})")
            self._rc[pid] = 1

    def on_ref(self, pages: Iterable[int]) -> None:
        self.events += 1
        for pid in pages:
            if pid not in self._rc:
                raise SanitizerError(
                    "PL250", f"ref taken on non-live page {pid} "
                             f"(use-after-free acquire)")
            self._rc[pid] += 1

    def pre_unref(self, pages: Iterable[int]) -> None:
        """Validate an unref *before* the real allocator mutates, so a
        double-free raises ``PL251`` instead of the allocator's KeyError.
        Simulates on a copy: duplicate page ids within one call count."""
        sim = dict(self._rc)
        for pid in pages:
            rc = sim.get(pid, 0)
            if rc <= 0:
                raise SanitizerError(
                    "PL251", f"unref of page {pid} below zero (double-free)")
            sim[pid] = rc - 1

    def on_unref(self, pages: Iterable[int],
                 freed: Iterable[int]) -> None:
        """``freed`` is the subset the real allocator returned to the free
        list; the shadow ledger independently decides who *should* free."""
        self.events += 1
        freed_set = set(freed)
        for pid in pages:
            rc = self._rc.get(pid)
            if rc is None or rc <= 0:
                raise SanitizerError(
                    "PL251", f"unref of page {pid} below zero (double-free)")
            self._rc[pid] = rc - 1
            if self._rc[pid] == 0:
                if pid not in freed_set:
                    raise SanitizerError(
                        "PL251", f"page {pid} reached shadow rc=0 but the "
                                 f"allocator did not free it (leak-by-"
                                 f"divergence)")
                del self._rc[pid]
            elif pid in freed_set:
                raise SanitizerError(
                    "PL252", f"page {pid} returned to the free list with "
                             f"{self._rc[pid]} live sharer(s)")
        stray = freed_set - set(pages)
        if stray:
            raise SanitizerError(
                "PL252", f"allocator freed page(s) {sorted(stray)} that "
                         f"were not part of this unref")

    # -- queries --------------------------------------------------------

    def refcount(self, pid: int) -> int:
        return self._rc.get(pid, 0)

    def live_pages(self) -> List[int]:
        return sorted(self._rc)

    def check_live(self, pages: Iterable[int], what: str = "block table"
                   ) -> None:
        """``PL254``: every page a consumer is about to address must be
        live.  Called on block-table construction before a decode step."""
        dead = [pid for pid in pages if pid not in self._rc]
        if dead:
            raise SanitizerError(
                "PL254", f"{what} references non-live page(s) {dead} "
                         f"(use-after-evict)")

    def assert_no_leaks(self, expected_live: Iterable[int] = (),
                        what: str = "engine teardown") -> None:
        """``PL255``: at teardown, every live page must have a named owner
        (request block table, spill extraction, store node, staged
        prefetch).  ``expected_live`` is the union of those owners' pages."""
        orphans = sorted(set(self._rc) - set(expected_live))
        if orphans:
            raise SanitizerError(
                "PL255", f"{len(orphans)} page(s) still live at {what} "
                         f"with no owner: {orphans[:16]}"
                         f"{'...' if len(orphans) > 16 else ''}")


def attach(placement) -> Optional[ShadowLedger]:
    """Attach a ledger to a placement instance when sanitizing is on.

    Returns the ledger (also stored as ``placement._shadow``), or None when
    ``REPRO_SANITIZE`` is unset.
    """
    if not sanitize_enabled():
        return None
    ledger = ShadowLedger(n_pages=getattr(placement, "n_pages", None))
    placement._shadow = ledger
    return ledger
