"""Two-tier (device memory <-> pinned host memory) paged pool with async
prefetch and a persistent cross-request prefix cache (PyTorch port of
``repro/serving/memory/tiered.py``).

``TieredStatePool`` extends :class:`~repro_torch.serving.memory.pool.
PagedStatePool` with the memory hierarchy:

  * **host tier** -- preemption spills move a victim's private pages to host
    bit-exactly (the base class: pinned tensors on the card, CRC-checked),
    and the bytes are *accounted* against a host-tier budget
    (:class:`HostTier`).  They come back through an **async prefetch**:
    ``prefetch_begin`` issues the host-to-device copy and the scatter into
    freshly allocated staging pages on a side CUDA stream while decode keeps
    running on the current one, and ``prefetch_commit`` later installs the
    staged pages into the block table -- O(1) bookkeeping plus one stream
    wait, no synchronous copy in the step loop.  The staging pages *are* the
    final pages (no bounce copy).
  * **prefix store** -- a :class:`~.prefix_store.PrefixStore` radix tree
    keyed by token ids remembers every *full* 128-token prompt page a
    request prefills (plus, for recurrent / hybrid models, a host snapshot
    of the recurrent state at each page boundary).  A later request whose
    prompt shares that prefix adopts the stored pages with a refcount bump
    -- the copy-on-write sharing a ``Session`` fork buys, but automatic and
    across requests.  Stored pages outlive their creating request under
    ``prefix_store_pages`` capacity with LRU + refcount-aware eviction, and
    can be demoted to the host tier and promoted back on a hit (a *cold*
    hit), bit-exact either way.

Stream order on the card.  The side stream first waits on the current
stream (the staging pages were free a moment ago, and decode work queued
there may still touch them), then copies and scatters, then records a
completion event; ``prefetch_commit`` and ``prefetch_cancel`` make the
current stream wait on that event before the pages enter a block table or
return to the free list.  Every temporary of the copy is allocated and used
on the side stream; the pinned blob stays referenced until commit or
cancel.  Demotion, promotion and state snapshots copy on the current stream:
a page or a slab row each, small next to a step.

In the trace, a prefetch is one ``b``/``e`` span on the pool track, emitted
closed at commit or cancel: it runs from the host's issue of the copy to
the commit (host time; the copy on the side stream is not timed here).
Tier movement is ``cat="tier"`` instants (promote / demote / prefix_hit /
evict / store_insert).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core.paged import PAGE_TOKENS
from repro_torch.serving.memory.layout import host_copy
from repro_torch.serving.memory.pool import PagedStatePool, SpilledRequest
from repro_torch.serving.memory.prefix_store import PrefixStore, StoredPage
from repro_torch.serving.resilience import (BlobCorruption, corrupt_blob,
                                            crc_blob, retry_transient,
                                            verify_blob)


class HostTier:
    """Byte ledger for the pinned-host tier.

    Two classes of payload:

      * **pinned** spill blobs (``pin``/``unpin`` keyed by rid) -- a preempted
        request's bits must survive no matter what, so pins may overshoot the
        budget (the alternative is dropping live state);
      * **cached** prefix-store payloads (``cache_add``/``cache_drop``) --
        best-effort, admitted only while ``room_for`` says the budget holds.

    ``byte_budget=None`` means unmetered.
    """

    def __init__(self, byte_budget: Optional[int] = None):
        self.byte_budget = byte_budget
        self._pinned: Dict[int, float] = {}
        self.cached_bytes = 0.0

    @property
    def pinned_bytes(self) -> float:
        return sum(self._pinned.values())

    @property
    def bytes_used(self) -> float:
        return self.pinned_bytes + self.cached_bytes

    def room_for(self, nbytes: float) -> bool:
        if self.byte_budget is None:
            return True
        return self.bytes_used + nbytes <= self.byte_budget

    def pin(self, rid: int, nbytes: float) -> None:
        self._pinned[rid] = self._pinned.get(rid, 0.0) + nbytes

    def unpin(self, rid: int) -> float:
        return self._pinned.pop(rid, 0.0)

    def cache_add(self, nbytes: float) -> None:
        self.cached_bytes += nbytes

    def cache_drop(self, nbytes: float) -> None:
        self.cached_bytes = max(0.0, self.cached_bytes - nbytes)


@dataclasses.dataclass
class _Staged:
    """An in-flight prefetch: copy issued, not yet committed."""
    pages: List[int]
    slab: int
    sp: SpilledRequest      # holds the pinned blob until commit / cancel
    done: Optional[torch.cuda.Event]   # side-stream completion (None: CPU)
    ts0: float              # tracer timestamp when the copy was issued


def _blob_nbytes(blob) -> float:
    return float(sum(t.numel() * t.element_size() for t in blob))


class TieredStatePool(PagedStatePool):
    """Paged pool with a host tier, async spill-resume prefetch, and an
    automatic cross-request prefix cache.  Drop-in for ``PagedStatePool``."""

    def __init__(self, cfg, *args, host_tier_bytes: Optional[int] = None,
                 prefix_cache: bool = False, prefix_store_pages: int = 64,
                 **kw):
        super().__init__(cfg, *args, **kw)
        self.host = HostTier(host_tier_bytes)
        self.store: Optional[PrefixStore] = (
            PrefixStore(prefix_store_pages) if prefix_cache else None)
        self._staged: Dict[int, _Staged] = {}
        #: cross-request prefix-cache hit ledger
        self.prefix_hits = 0
        self.prefix_hit_pages = 0
        self.prefix_hit_tokens = 0
        #: prefetch lifecycle ledger: every begin must end in exactly one
        #: commit or cancel (checked by the sanitizer at teardown)
        self.prefetch_begun = 0
        self.prefetch_commits = 0
        self.prefetch_cancels = 0
        self._has_slabs = any(s.kind == "slab" for s in self.paging.specs)
        # tier movement steppers: bare page stacks and slab rows (the units
        # of store demotion / promotion and state-snapshot capture)
        self._extract_pages = self.paging.extract_pages
        self._insert_pages = self.paging.insert_pages
        self._extract_slab = self.paging.extract_slab
        self._insert_slab = self.paging.insert_slab
        #: the prefetch copies' stream (the card only)
        self.copy_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)

    def attach_obs(self, obs) -> None:
        super().attach_obs(obs)
        self._extract_pages = obs.wrap_step(self._extract_pages,
                                            "pool.tier_extract")
        self._insert_pages = obs.wrap_step(self._insert_pages,
                                           "pool.tier_insert")
        self._extract_slab = obs.wrap_step(self._extract_slab,
                                           "pool.slab_extract")
        self._insert_slab = obs.wrap_step(self._insert_slab,
                                          "pool.slab_insert")

    def _tier_metric(self, name: str, v: float = 1.0, **labels) -> None:
        if self._obs is not None:
            self._obs.metrics.counter(name, **labels).inc(v)

    def _tier_instant(self, name: str, **args) -> None:
        if self._obs is not None:
            self._obs.tracer.instant(name, cat="tier", track="pool", **args)

    def _now_us(self) -> float:
        return self._obs.tracer.now_us() if self._obs is not None else 0.0

    def _sync_host_gauge(self) -> None:
        if self._obs is not None:
            self._obs.metrics.gauge("host_tier_bytes").set(
                self.host.bytes_used)

    # ------------------------------------------------------------------
    # spill / resume with host-tier accounting
    # ------------------------------------------------------------------

    def spill(self, rid: int, length: int) -> SpilledRequest:
        sp = super().spill(rid, length)
        if self._inject("blob_corrupt", rid=rid, what="spill"):
            # flip one byte *after* the CRC was recorded: resume / prefetch
            # must detect the mismatch, not decode the garbage
            corrupt_blob(sp.blob)
        nbytes = _blob_nbytes(sp.blob)
        self._pin_with_retry(rid, nbytes)
        self._tier_metric("demote_bytes_total", nbytes, kind="spill")
        self._tier_instant("tier.demote", rid=rid, bytes=nbytes, kind="spill")
        self._sync_host_gauge()
        return sp

    def _pin_with_retry(self, rid: int, nbytes: float) -> None:
        """Pin a spill blob in the host ledger with bounded retry against
        injected transient pin failures, then *force-pin*: a preempted
        request's bits are live state and may never be dropped, so the
        terminal rung here is overshoot-and-degrade, not failure."""
        retried = [0]

        def attempt():
            if self._inject("host_pin", rid=rid, what="spill"):
                return False
            self.host.pin(rid, nbytes)
            return True

        def on_retry(_k):
            retried[0] += 1
            self._tier_metric("fault_retries_total", site="host_pin")

        if retry_transient(attempt, on_retry=on_retry):
            if retried[0]:
                self._tier_metric("faults_recovered_total", site="host_pin")
            return
        # retries exhausted: pin anyway (HostTier pins may overshoot the
        # budget by contract) and record the degradation
        self.host.pin(rid, nbytes)
        self._tier_metric("degradations_total", rung="force_pin")
        if self._obs is not None:
            self._obs.tracer.instant("fault.host_pin_forced", cat="fault",
                                     track="pool", rid=rid)

    def resume(self, rid: int, sp: SpilledRequest) -> bool:
        """Synchronous resume -- the fallback when no prefetch was staged.
        A staged prefetch commits instead (O(1), no copy here)."""
        if rid in self._staged:
            if self._inject("prefetch_commit", rid=rid, what="commit"):
                # injected commit failure: return the staging pages and fall
                # back to the synchronous path below -- the request still
                # resumes, one copy later than planned
                self.prefetch_cancel(rid)
                self._tier_metric("faults_recovered_total",
                                  site="prefetch_commit")
            else:
                return self.prefetch_commit(rid)
        if not super().resume(rid, sp):
            return False
        nbytes = self.host.unpin(rid)
        self._tier_metric("tier_miss_total", kind="resume")
        self._tier_metric("promote_bytes_total", nbytes, kind="resume")
        self._tier_instant("tier.promote", rid=rid, bytes=nbytes,
                           kind="resume")
        self._sync_host_gauge()
        return True

    def drop_spilled(self, sp: SpilledRequest, rid: Optional[int] = None):
        super().drop_spilled(sp, rid)
        if rid is not None:
            self.host.unpin(rid)
            self._sync_host_gauge()

    # ------------------------------------------------------------------
    # async prefetch (issue-then-commit)
    # ------------------------------------------------------------------

    def prefetch_begin(self, rid: int, sp: SpilledRequest,
                       reserve: int = 1) -> bool:
        """Issue the copy of a spilled request's blob into fresh staging
        pages, without installing them.  Returns False (no-op) when pages /
        slabs are too tight -- ``reserve`` pages are left free so staging
        never starves decode growth."""
        if rid in self._staged or rid in self.page_table:
            return rid in self._staged
        need = sp.pages_needed
        if self.free_pages < need + reserve or self.free_slabs < 2:
            return False
        # verify *before* the copy: a corrupt blob must never start one (the
        # engine converts this into a re-prefill)
        verify_blob(sp.blob, sp.crc, "spill blob", rid=rid)
        pages = self.placement.alloc(need)
        if pages is None:
            return False
        self.pages_allocated += need
        self.prefetch_begun += 1
        slab = self._free_slabs.pop()
        # the span's start: the host's issue of the copy (the copy itself
        # runs on the side stream and is not timed here)
        ts0 = self._now_us()
        done = None
        if self.copy_stream is None:
            self._insert_blob(self.pools, sp.blob, self._ids(pages), slab)
        else:
            # every host-to-device copy here reads pinned memory: one from
            # pageable memory would make the host wait for the stream, and
            # so for the decode work it waits on
            ids = torch.tensor(pages, dtype=torch.int64).pin_memory()
            self.copy_stream.wait_stream(
                torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.copy_stream):
                self._insert_blob(self.pools, sp.blob,
                                  ids.to(self.device, non_blocking=True),
                                  slab)
                done = torch.cuda.Event()
                done.record(self.copy_stream)
        self._adopt_homes(sp, pages, slab)
        self._staged[rid] = _Staged(pages, slab, sp, done, ts0)
        self._tier_instant("prefetch.dispatch", rid=rid, pages=need)
        return True

    def prefetch_ready(self, rid: int) -> bool:
        return rid in self._staged

    def _join(self, st: _Staged) -> None:
        """Order the current stream after a staged copy."""
        if st.done is not None:
            torch.cuda.current_stream(self.device).wait_event(st.done)

    def prefetch_commit(self, rid: int) -> bool:
        """Install a staged prefetch: build the block table from still-
        resident shared pages + the staged private pages.  O(1) bookkeeping
        and one stream wait; the data moved while decode was running."""
        st = self._staged.pop(rid, None)
        if st is None:
            return False
        assert rid not in self.page_table
        self._join(st)
        sp = st.sp
        table = [0] * sp.n_pages
        for pos, pid in sp.shared:
            table[pos] = pid
        for pos, pid in zip(sp.private_idx, st.pages):
            table[pos] = pid
        self.page_table[rid] = table
        self.slab_of[rid] = st.slab
        nbytes = self.host.unpin(rid)
        self._account_gather(self.request_nbytes(sp.pages_needed))
        self.prefetch_commits += 1
        self._tier_metric("tier_hit_total", kind="prefetch")
        self._tier_metric("promote_bytes_total", nbytes, kind="prefetch")
        self._sync_host_gauge()
        if self._obs is not None:
            # emitted closed: an uncommitted prefetch never leaves a
            # dangling ``b`` in the trace
            self._obs.tracer.async_span(
                "prefetch", rid, cat="prefetch", ts0=st.ts0,
                ts1=self._now_us(), track="pool", rid=rid,
                pages=sp.pages_needed)
        return True

    def prefetch_cancel(self, rid: int) -> None:
        """Abandon a staged prefetch (request aborted / truncated / its blob
        found corrupt): return the staging pages and slab once the copy into
        them is done; the host blob stays pinned."""
        st = self._staged.pop(rid, None)
        if st is None:
            return
        self._join(st)
        self.homes.forget_pages(self.placement.unref(st.pages))
        self._free_slabs.append(st.slab)
        self.prefetch_cancels += 1
        if self._obs is not None:
            self._obs.tracer.async_span(
                "prefetch", rid, cat="prefetch", ts0=st.ts0,
                ts1=self._now_us(), track="pool", rid=rid, canceled=True)

    # ------------------------------------------------------------------
    # prefix store: match / admit / insert / tiering
    # ------------------------------------------------------------------

    def prefix_match(self, prompt: Sequence[int]
                     ) -> Optional[List[StoredPage]]:
        """Longest usable stored prefix for ``prompt``, or None.

        Pure lookup -- no metrics (the engine may probe repeatedly while a
        request waits in the queue); hit / miss is counted at admission.
        The match is capped so at least one prompt token remains un-cached
        (the engine needs a tail to feed through decode), and trimmed to the
        deepest node carrying a recurrent-state snapshot (without the state
        at the boundary a hit would not be bit-exact for SSM / hybrid
        models)."""
        if self.store is None or len(prompt) <= PAGE_TOKENS:
            return None
        max_pages = (len(prompt) - 1) // PAGE_TOKENS
        path = self.store.match(self.store.chunks(prompt, max_pages))
        while path and path[-1].state is None:
            path.pop()
        return path or None

    def prefix_admit(self, rid: int, nodes: List[StoredPage]) -> bool:
        """Admit ``rid`` with its first ``len(nodes)`` pages adopted from the
        store (refcount bumps, no prefill).  Demoted nodes are promoted
        first; the tail node's state snapshot is written into the fresh
        slab.  Returns False (nothing changed) if capacity is short."""
        assert self.store is not None and nodes
        assert rid not in self.page_table
        cold = [n for n in nodes if not n.resident]
        if not self.can_admit(len(cold)):
            return False
        for n in cold:
            if not self.promote_node(n):
                return False
        warm = len(nodes) - len(cold)
        pages = [n.device_page for n in nodes]
        self.placement.ref(pages)
        self.shared_page_hits += len(pages)
        self.page_table[rid] = list(pages)
        slab = self._free_slabs.pop()
        self.slab_of[rid] = slab
        if self._has_slabs:
            self._insert_slab(self.pools, nodes[-1].state, slab)
            self._account_gather(self.slab_nbytes)
        if self.homes.active:
            self.homes.set_slab(slab, nodes[-1].state_homes)
        self.store.touch(nodes)
        self.prefix_hits += 1
        self.prefix_hit_pages += len(nodes)
        self.prefix_hit_tokens += len(nodes) * PAGE_TOKENS
        self._tier_metric("tier_hit_total", kind="prefix")
        self._tier_instant("tier.prefix_hit", rid=rid, pages=len(nodes),
                           warm=warm, cold=len(cold))
        return True

    def note_prefix_miss(self) -> None:
        if self.store is not None:
            self._tier_metric("tier_miss_total", kind="prefix")

    def snapshot_slab(self, rid: int) -> List[torch.Tensor]:
        """Host copy of ``rid``'s recurrent-state slab row (may be [])."""
        if not self._has_slabs:
            return []
        return host_copy(self._extract_slab(self.pools, self.slab_of[rid]))

    def store_insert(self, rid: int, tokens: Sequence[int]) -> int:
        """Record ``rid``'s pages for the exact-page-boundary prefix
        ``tokens`` (``len(tokens) % PAGE_TOKENS == 0``) in the store.  The
        store takes one placement ref per newly created node, and the tail
        node captures the request's recurrent state at this boundary.
        Returns the number of new nodes."""
        if self.store is None or len(tokens) == 0:
            return 0
        assert len(tokens) % PAGE_TOKENS == 0
        chunks = self.store.chunks(tokens)
        path, created = self.store.extend(chunks)
        table = self.page_table[rid]
        for node in created:
            node.device_page = table[node.depth - 1]
            self.placement.ref([node.device_page])
        tail = path[-1]
        if tail.state is None:
            state = self.snapshot_slab(rid)
            tail.state = state
            tail.state_homes = self.homes.slab_homes(self.slab_of[rid])
            self.host.cache_add(_blob_nbytes(state))
            self._account_gather(self.slab_nbytes)
            self._sync_host_gauge()
        if created:
            self._tier_instant("tier.store_insert", rid=rid,
                               pages=len(created), depth=len(path))
        self._enforce_store_capacity()
        return len(created)

    # ------------------------------------------------------------------
    # store tiering: demote / promote / evict
    # ------------------------------------------------------------------

    def _locked(self, node: StoredPage) -> bool:
        """A node whose device page other owners still reference (live
        requests, spill blobs) must not be demoted or evicted."""
        return (node.resident
                and self.placement.refcount(node.device_page) > 1)

    def demote_node(self, node: StoredPage) -> bool:
        """Move one resident store node's page payload to the host tier
        (pinned) and free its device page.  Refuses locked nodes; falls back
        to eviction when the host budget has no room (a cache entry is
        best-effort)."""
        if not node.resident or self._locked(node):
            return False
        nbytes = self.page_nbytes
        if not self.host.room_for(nbytes):
            if node.is_leaf:
                self.evict_node(node)
            return False
        node.host_blob = host_copy(self._extract_pages(
            self.pools, self._ids([node.device_page])))
        node.host_crc = crc_blob(node.host_blob)
        node.host_homes = self.homes.page_homes([node.device_page])
        if self._inject("blob_corrupt", what="store_demote"):
            corrupt_blob(node.host_blob)
        self.homes.forget_pages(self.placement.unref([node.device_page]))
        node.device_page = None
        self.host.cache_add(nbytes)
        self._account_gather(nbytes)
        self._tier_metric("demote_bytes_total", float(nbytes), kind="store")
        self._tier_instant("tier.demote", node=node.node_id,
                           bytes=float(nbytes), kind="store")
        self._sync_host_gauge()
        return True

    def promote_node(self, node: StoredPage) -> bool:
        """Bring a demoted store node back to the device (a cold hit).

        The host payload is checksum-verified first: a corrupt cache entry
        is converted into a *miss* (the node -- and, for interior nodes, its
        whole subtree -- is evicted) rather than a poisoned hit."""
        if node.resident:
            return True
        assert node.host_blob is not None
        try:
            verify_blob(node.host_blob, node.host_crc, "store blob")
        except BlobCorruption:
            self._evict_subtree(node)
            self._tier_metric("faults_recovered_total", site="store_promote")
            self._tier_instant("tier.store_corrupt", node=node.node_id)
            return False
        if self._inject("alloc", what="promote"):
            return False
        got = self.placement.alloc(1)
        if got is None:
            return False
        self.pages_allocated += 1
        self._insert_pages(self.pools, node.host_blob, self._ids(got))
        if node.host_homes is not None:
            self.homes.set_pages(got, node.host_homes)
        node.device_page = got[0]
        node.host_blob = None
        node.host_crc = None
        nbytes = self.page_nbytes
        self.host.cache_drop(nbytes)
        self._account_gather(nbytes)
        self._tier_metric("promote_bytes_total", float(nbytes), kind="store")
        self._tier_instant("tier.promote", node=node.node_id,
                           bytes=float(nbytes), kind="store")
        self._sync_host_gauge()
        return True

    def evict_node(self, node: StoredPage) -> None:
        """Drop a leaf store node entirely (device ref and / or host bytes)."""
        assert not self._locked(node)
        self.store.remove(node)
        if node.resident:
            self.homes.forget_pages(
                self.placement.unref([node.device_page]))
            node.device_page = None
        if node.host_blob is not None:
            self.host.cache_drop(self.page_nbytes)
            node.host_blob = None
            node.host_crc = None
        if node.state is not None:
            self.host.cache_drop(_blob_nbytes(node.state))
            node.state = None
        self._tier_instant("tier.evict", node=node.node_id)
        self._sync_host_gauge()

    def _evict_subtree(self, node: StoredPage) -> int:
        """Evict ``node`` and every descendant (``PrefixStore.remove`` is
        leaf-only, so the subtree is peeled deepest-first).  Used when an
        *interior* node's host payload fails its checksum: its cached path
        is unusable below the corruption point.  Locked descendants stop
        the peel -- their payloads back live requests -- in which case the
        corrupt node stays unpromotable: every later promote attempt
        re-detects the mismatch and reports a miss.  Returns nodes
        evicted."""
        evicted = 0
        while True:
            sub = [node]
            i = 0
            while i < len(sub):
                sub.extend(sub[i].children.values())
                i += 1
            peel = [n for n in sub if n.is_leaf and not self._locked(n)]
            if not peel:
                return evicted
            for n in peel:
                self.evict_node(n)
                evicted += 1
            if node not in self.store.nodes():
                return evicted

    def sanitizer_owned_pages(self) -> set:
        """Base owners plus staged prefetch pages and resident prefix-store
        nodes (the store holds one placement ref per resident node)."""
        owned = super().sanitizer_owned_pages()
        for st in self._staged.values():
            owned.update(st.pages)
        if self.store is not None:
            owned.update(self.store.resident_pages())
        return owned

    def sanitizer_check_leaks(self, what: str = "engine teardown") -> None:
        """Tiered teardown additionally requires the prefetch ledger to be
        settled: a staged prefetch whose request already retired would hold
        its staging pages (and slab) forever."""
        if self.placement._shadow is not None and self._staged:
            from repro_torch.analysis.lint.runtime import SanitizerError
            raise SanitizerError(
                "PL255", f"{len(self._staged)} staged prefetch(es) never "
                f"committed or canceled at {what} "
                f"(rids {sorted(self._staged)})")
        super().sanitizer_check_leaks(what)

    def _enforce_store_capacity(self) -> None:
        over = self.store.over_capacity()
        while over > 0:
            cands = self.store.evict_candidates(locked=self._locked)
            if not cands:
                break
            self.evict_node(cands[0])
            over -= 1

    def reclaim(self, n_pages: int) -> int:
        """Free device pages by demoting (or evicting) LRU store nodes until
        ``n_pages`` are available.  Returns pages actually reclaimed."""
        if self.store is None:
            return 0
        got = 0
        for node in self.store.lru_nodes():
            if self.free_pages >= n_pages:
                break
            if not node.resident or self._locked(node):
                continue
            if self.demote_node(node):
                got += 1
            elif node.is_leaf:
                # demote refused for host-budget reasons and evicted inside
                got += 1
        return got

    def demote_all(self) -> int:
        """Demote every unlocked resident store node to the host tier
        (cold-store hook for tests and drains)."""
        if self.store is None:
            return 0
        n = 0
        for node in self.store.nodes():
            if node.resident and not self._locked(node):
                if self.demote_node(node):
                    n += 1
        return n

    def prefetch_prefix(self, prompt: Sequence[int]) -> int:
        """Scheduler lookahead hook: promote demoted store nodes matching a
        queued prompt ahead of its admission, so the hit is warm by the time
        the request admits.  Returns nodes promoted."""
        nodes = self.prefix_match(prompt)
        if not nodes:
            return 0
        n = 0
        for node in nodes:
            if not node.resident and self.free_pages > 1:
                if self.promote_node(node):
                    n += 1
        if n:
            self._tier_instant("prefetch.prefix", pages=n)
        return n
