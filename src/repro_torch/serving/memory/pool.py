"""Paged, bank-aware state/KV memory pool (PyTorch port of
``repro/serving/memory/pool.py``).

One ``PagedStatePool`` owns the physical decode-cache storage of a serving
engine:

  * **KV pages** -- every attention cache stream is a page pool
    ``(n_pages, G, 128, KVH, d)``; a physical page id addresses one
    128-token, MX-tile-aligned chunk across all KV pools at once;
  * **state slabs** -- every fixed-size recurrent leaf (SSM state, conv
    tails) is ``(n_slabs, G, ...)``; one slab id per request.

A request owns a block table (list of page ids) plus one slab id; growing or
finishing a request only moves integer ids between free lists.  Placement
is bank-aware (:mod:`.placement`), so the page map is one that
:func:`repro_torch.core.pimsim.placement_step_latency` can score.

The decode step is eager PyTorch over the pools, in place: with
``decode_mode="paged"`` (default) the block-table-native ops read pages and
slab rows where they live (on the card: the paged attention kernel, the
append kernel and the state-update kernel in slab mode); ``"gather"`` is
the dense reference path (gather the context, run the dense ops, scatter
one token back), kept for bit-exact parity checks.  Preemption spills a
victim's private pages + slab to host memory bit-exactly (CRC-checked);
resume re-pins them to fresh physical ids.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import ops as OPS
from repro_torch.core.paged import PAGE_TOKENS
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.serving.memory.layout import CachePaging
from repro_torch.serving.memory.placement import (BankAwarePlacement,
                                                  BankTopology)
from repro_torch.serving.resilience import crc_blob, verify_blob


def bucket_pages(npg: int) -> int:
    """Round a page count up to a power of two (a bounded set of block-table
    widths, as in the JAX package, where each width is one compile)."""
    return 1 << max(0, (npg - 1).bit_length())


@dataclasses.dataclass
class SpilledRequest:
    """Host-side copy of an evicted request's state (bit-exact).

    Only *privately owned* pages are extracted into ``blob`` (CPU tensors,
    one per pool spec); pages shared with other resident requests stay on
    the device and the spilled request keeps its reference on them
    (``shared``: (block-table position, physical id)), so resume reuses
    those ids verbatim.
    """
    blob: List[torch.Tensor]
    n_pages: int                        # total block-table length
    length: int
    private_idx: List[int] = dataclasses.field(default_factory=list)
    shared: List[tuple] = dataclasses.field(default_factory=list)
    #: CRC32 of ``blob`` at extraction; resume verifies it
    crc: Optional[int] = None

    @property
    def pages_needed(self) -> int:
        """Fresh pages a resume must allocate (private pages only)."""
        return len(self.private_idx)


class PagedStatePool:
    """Block/page-granular pool backing both KV caches and SSM states.

    Page id 0 and slab id 0 are reserved scratch targets for idle decode
    rows; usable capacity is ``n_pages - 1`` pages / ``n_slabs - 1`` slabs.
    The pools live on ``device`` (the card unless the caller asks for the
    CPU).
    """

    def __init__(self, cfg: ModelConfig, n_pages: Optional[int] = None,
                 n_slabs: int = 9, byte_budget: Optional[int] = None,
                 topology: Optional[BankTopology] = None,
                 decode_mode: str = "paged", device=None):
        if decode_mode not in ("paged", "gather"):
            raise ValueError(f"decode_mode must be 'paged' or 'gather', got "
                             f"{decode_mode!r}")
        self.cfg = cfg
        self.decode_mode = decode_mode
        self.device = M.resolve_device(device)
        self.paging = CachePaging(
            M.init_decode_caches(cfg, 1, PAGE_TOKENS, device=self.device))

        if byte_budget is not None:
            if n_pages is not None:
                raise ValueError("give n_pages or byte_budget, not both")
            state_bytes = (n_slabs - 1) * self.paging.slab_nbytes
            per_page = max(self.paging.page_nbytes, 1)
            n_pages = 1 + max(1, (byte_budget - state_bytes) // per_page)
        if n_pages is None or n_pages < 2 or n_slabs < 2:
            raise ValueError(f"need n_pages >= 2 and n_slabs >= 2, got "
                             f"{n_pages} / {n_slabs}")
        self.n_pages = int(n_pages)
        self.n_slabs = int(n_slabs)

        self.pools = self.paging.make_pools(self.n_pages, self.n_slabs)
        if topology is None:
            # size the coordinate space to the pool, so the conflict score
            # compares against a *reachable* ideal spread
            pch, pairs = 16, 8
            while pch * pairs > max(self.n_pages - 1, 1) and pch * pairs > 1:
                if pairs >= pch:
                    pairs = max(1, pairs // 2)
                else:
                    pch = max(1, pch // 2)
            topology = BankTopology(pch, pairs)
        self.placement = BankAwarePlacement(self.n_pages, topology)
        self._free_slabs: List[int] = list(range(1, self.n_slabs))
        self.page_table: Dict[int, List[int]] = {}     # rid -> page ids
        self.slab_of: Dict[int, int] = {}              # rid -> slab id

        # per-page stream bytes and per-request slab bytes for the PIM bank
        # model come from the layout="paged" ops' own traffic descriptors
        entries = OPS.decode_op_plans(cfg, 1, PAGE_TOKENS, layout="paged")
        self._page_stream_bytes = sum(
            e.traffic.state_read for e in entries
            if e.kind in ("attn_decode", "mla_decode"))
        self._slab_rw_bytes = sum(
            e.traffic.state_total for e in entries
            if e.kind == "state_update")
        #: bytes still moved by gather/scatter: preemption spill/resume,
        #: prefill insertion and the one-page fork copy -- never the decode
        #: loop (in decode_mode="paged")
        self.gather_bytes = 0.0
        #: cumulative pages handed out by the allocator (copy-on-write shares
        #: are not counted: the gap versus an unshared run is the savings)
        self.pages_allocated = 0
        #: cumulative extra references taken by fork()
        self.shared_page_hits = 0
        #: optional repro_torch.obs.Observability (see ``attach_obs``)
        self._obs = None

    def attach_obs(self, obs) -> None:
        """Attach an engine's observability bundle: the placement mirrors
        page alloc / free / ref into its metrics registry."""
        self._obs = obs
        self.placement.metrics = obs.metrics

    def _account_gather(self, nbytes: float) -> None:
        self.gather_bytes += nbytes
        if self._obs is not None:
            self._obs.metrics.counter("gather_bytes_total").inc(nbytes)

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(list(ids), dtype=torch.int64,
                               device=self.device)

    # ------------------------------------------------------------------
    # allocation
    # ------------------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return self.placement.n_free

    @property
    def free_slabs(self) -> int:
        return len(self._free_slabs)

    @property
    def usable_pages(self) -> int:
        return self.placement.n_usable

    def can_admit(self, n_pages: int, n_slabs: int = 1) -> bool:
        return self.free_pages >= n_pages and self.free_slabs >= n_slabs

    def register(self, rid: int, n_pages: int) -> bool:
        """Claim a slab + ``n_pages`` pages for a new request."""
        assert rid not in self.page_table
        if not self.can_admit(n_pages):
            return False
        pages = self.placement.alloc(n_pages)
        if pages is None:
            return False
        self.page_table[rid] = pages
        self.slab_of[rid] = self._free_slabs.pop()
        self.pages_allocated += n_pages
        return True

    def grow(self, rid: int, n_new: int) -> bool:
        """Extend a request's block table -- copy-free, just new page ids."""
        pages = self.placement.alloc(n_new)
        if pages is None:
            return False
        self.page_table[rid].extend(pages)
        self.pages_allocated += n_new
        return True

    def release(self, rid: int):
        """Drop a request's references: pages return to the free list only
        when the last owner drops them (forks keep shared prefix pages
        alive); the slab is always exclusive and frees now."""
        pages = self.page_table.pop(rid)
        self.placement.unref(pages)
        self._free_slabs.append(self.slab_of.pop(rid))

    def fork(self, parent_rid: int, child_rid: int, length: int) -> bool:
        """Copy-on-write fork: the child shares the parent's full prefix
        pages by reference and gets a private copy of only the partially
        filled tail page plus the parent's slab row (recurrent state at
        ``length``).  At most 1 page + 1 slab, whatever the prefix length."""
        assert child_rid not in self.page_table
        parent_pages = self.page_table[parent_rid]
        n_full, tail = divmod(length, PAGE_TOKENS)
        assert len(parent_pages) >= n_full + (1 if tail else 0), \
            (parent_rid, length, len(parent_pages))
        if not self.can_admit(1 if tail else 0):
            return False
        new_pages: List[int] = []
        if tail:
            got = self.placement.alloc(1)
            if got is None:
                return False
            new_pages = got
            self.pages_allocated += 1
        shared = list(parent_pages[:n_full])
        self.placement.ref(shared)
        self.shared_page_hits += len(shared)
        self.page_table[child_rid] = shared + new_pages
        slab = self._free_slabs.pop()
        self.slab_of[child_rid] = slab
        src_slab = self.slab_of[parent_rid]
        if tail:
            self.paging.fork_copy(self.pools, parent_pages[n_full],
                                  new_pages[0], src_slab, slab)
            self._account_gather(self.page_nbytes + self.slab_nbytes)
        else:
            self.paging.copy_slab(self.pools, src_slab, slab)
            self._account_gather(self.slab_nbytes)
        if self._obs is not None:
            self._obs.metrics.counter("forks_total").inc()
            self._obs.metrics.counter(
                "shared_page_refs_total").inc(len(shared))
        return True

    # ------------------------------------------------------------------
    # data movement
    # ------------------------------------------------------------------

    def request_nbytes(self, n_pages: int) -> float:
        """Physical bytes one request's pages + slab occupy (spill size)."""
        return n_pages * self.page_nbytes + self.slab_nbytes

    def insert_prefill(self, rid: int, row_caches):
        """Pin a prefilled B=1 cache row (T must equal npg*PAGE_TOKENS)."""
        self.paging.insert_request(self.pools, row_caches,
                                   self._ids(self.page_table[rid]),
                                   self.slab_of[rid])
        self._account_gather(self.request_nbytes(len(self.page_table[rid])))

    def spill(self, rid: int, length: int) -> SpilledRequest:
        """Evict: copy the request's *private* pages + slab to host
        bit-exactly and free those device ids.  Pages shared with other
        requests (refcount > 1) stay resident: the spilled request keeps its
        reference, so a shared page never spills twice."""
        pages = self.page_table[rid]
        private_idx = [i for i, p in enumerate(pages)
                       if self.placement.refcount(p) == 1]
        shared = [(i, p) for i, p in enumerate(pages)
                  if self.placement.refcount(p) > 1]
        priv = [pages[i] for i in private_idx]
        blob = self.paging.extract_request(self.pools, self._ids(priv),
                                           self.slab_of[rid])
        self.page_table.pop(rid)
        self.placement.unref(priv)
        self._free_slabs.append(self.slab_of.pop(rid))
        self._account_gather(self.request_nbytes(len(priv)))
        # checksum the host copy at the tier boundary: resume verifies it
        return SpilledRequest(blob, len(pages), length,
                              private_idx=private_idx, shared=shared,
                              crc=crc_blob(blob))

    def resume(self, rid: int, sp: SpilledRequest) -> bool:
        """Re-pin a spilled request: private pages land on fresh physical
        ids, shared prefix pages rejoin the block table verbatim."""
        assert rid not in self.page_table
        if not self.can_admit(sp.pages_needed):
            return False
        # a corrupted byte must stop here (BlobCorruption), not surface as
        # garbage logits
        verify_blob(sp.blob, sp.crc, "spill blob", rid=rid)
        fresh = self.placement.alloc(sp.pages_needed)
        if fresh is None:
            return False
        self.pages_allocated += sp.pages_needed
        table = [0] * sp.n_pages
        for pos, pid in sp.shared:
            table[pos] = pid
        for pos, pid in zip(sp.private_idx, fresh):
            table[pos] = pid
        self.page_table[rid] = table
        slab = self._free_slabs.pop()
        self.slab_of[rid] = slab
        self.paging.insert_blob(self.pools, sp.blob, self._ids(fresh), slab)
        self._account_gather(self.request_nbytes(sp.pages_needed))
        return True

    def drop_spilled(self, sp: SpilledRequest):
        """Abort a spilled request: release the references its blob holds on
        still-resident shared pages (the last owner to drop frees them)."""
        self.placement.unref([pid for _, pid in sp.shared])
        sp.shared = []

    # ------------------------------------------------------------------
    # the decode step
    # ------------------------------------------------------------------

    def block_table(self, rids: Sequence[Optional[int]],
                    min_pages: int = 1) -> np.ndarray:
        """Dense (B, npg_bucket) block table; absent rows use scratch ids.

        ``min_pages`` floors the (pre-bucketing) width: the speculative
        verify step appends n rows per request, so its table must span
        ``pages_for(length + n)`` even where a garbage-padded row does not
        own that many pages yet -- those appends land on scratch page 0,
        like idle rows' writes, and are never read back (the append kernel
        refuses a slot outside the table).
        """
        npg = max([len(self.page_table[r]) for r in rids if r is not None],
                  default=1)
        bt = np.zeros((len(rids), bucket_pages(max(npg, min_pages))),
                      np.int32)
        shadow = self.placement._shadow
        if shadow is not None:   # PL254: every addressed page must be live
            shadow.check_live(
                {pid for r in rids if r is not None
                 for pid in self.page_table[r]},
                what=f"block table for rids "
                     f"{[r for r in rids if r is not None]}")
        for i, r in enumerate(rids):
            if r is not None:
                pages = self.page_table[r]
                bt[i, :len(pages)] = pages
        return bt

    def _step_tensors(self, rids, lengths, tokens, min_pages: int = 1):
        dev = self.device
        bt = torch.as_tensor(self.block_table(rids, min_pages), device=dev)
        slabs = self._slabs(rids)
        lens = torch.as_tensor(np.asarray(lengths, np.int32), device=dev)
        toks = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)
        return bt, slabs, lens, toks

    def _slabs(self, rids) -> torch.Tensor:
        return torch.tensor([self.slab_of[r] if r is not None else 0
                             for r in rids], dtype=torch.int32,
                            device=self.device)

    def decode(self, params, rids: Sequence[Optional[int]],
               tokens: np.ndarray, lengths: np.ndarray, seed: int
               ) -> torch.Tensor:
        """Run one batched decode step over ``rids`` (None = idle row),
        updating the pools in place.  Returns logits (B, V) on the device.

        ``decode_mode="paged"`` runs the block-table-native ops over the
        pools; ``"gather"`` the dense-gather reference path.
        """
        bt, slabs, lens, toks = self._step_tensors(rids, lengths, tokens)
        if self.decode_mode == "paged":
            views = self.paging.paged_view(self.pools, bt, slabs, lens)
            logits, views = M.paged_decode_step(params, self.cfg, toks,
                                                views, lens, seed=seed)
            self.paging.commit(self.pools, views, slabs)
        else:
            caches = self.paging.gather(self.pools, bt, slabs, lens)
            logits, caches = M.decode_step(params, self.cfg, toks, caches,
                                           lens, seed=seed)
            self.paging.scatter_step(self.pools, caches, bt, slabs, lens)
        return logits

    def decode_spec(self, params, rids: Sequence[Optional[int]],
                    tokens: np.ndarray, lengths: np.ndarray, seed: int,
                    min_pages: int = 1):
        """Run one speculative verify step: tokens (B, n) per row, logits
        (B, n, V) back, plus the snapshots for :meth:`commit_spec`.

        Position i of every row runs with the seeds of the sequential
        decode step ``seed + i``, so its logits row is the one decoding that
        token in a plain step gives.  ``min_pages`` must span
        ``pages_for(length + n)`` over the batch (see :meth:`block_table`).
        """
        if self.decode_mode != "paged":
            raise ValueError("speculative decode needs the block-table-"
                             "native path (decode_mode='paged')")
        bt, slabs, lens, toks = self._step_tensors(rids, lengths, tokens,
                                                   min_pages)
        views = self.paging.paged_view(self.pools, bt, slabs, lens)
        logits, views, snaps = M.paged_spec_decode_step(
            params, self.cfg, toks, views, lens, seed=seed)
        self.paging.commit(self.pools, views, slabs)
        return logits, snaps

    def commit_spec(self, rids: Sequence[Optional[int]], snaps,
                    sel: np.ndarray) -> None:
        """Roll recurrent state back to each row's last accepted position
        (``sel`` (B,), an index into the verify step's n positions).  KV
        needs no rollback -- the engine's host lengths mask rejected rows
        and later appends overwrite them."""
        self.paging.commit_select(
            self.pools, snaps, self._slabs(rids),
            torch.as_tensor(np.asarray(sel, np.int64), device=self.device))

    # ------------------------------------------------------------------
    # accounting
    # ------------------------------------------------------------------

    @property
    def page_nbytes(self) -> int:
        return self.paging.page_nbytes

    @property
    def slab_nbytes(self) -> int:
        return self.paging.slab_nbytes

    def occupancy(self) -> float:
        """Fraction of usable pages currently pinned."""
        used = self.usable_pages - self.free_pages
        return used / max(self.usable_pages, 1)

    def fragmentation(self, lengths: Dict[int, int]) -> float:
        """1 - used_tokens / allocated_token_capacity over resident requests
        (internal fragmentation of the last partially-filled pages)."""
        alloc_tokens = sum(len(p) for p in self.page_table.values()) \
            * PAGE_TOKENS
        used_tokens = sum(lengths.get(r, 0) for r in self.page_table)
        if alloc_tokens == 0:
            return 0.0
        return 1.0 - used_tokens / alloc_tokens

    def bank_traffic(self, rids: Sequence[int]) -> np.ndarray:
        """Column bursts per (pseudo-channel, bank-pair) for one decode step
        over ``rids``: every resident page streams once, every slab row is
        read + written -- bytes from the ``layout="paged"`` ops'
        ``traffic(plan)`` descriptors."""
        burst = 32.0
        page_lists = [self.page_table[r] for r in rids if r in self.page_table]
        m = self.placement.traffic_map(page_lists,
                                       self._page_stream_bytes / burst)
        topo = self.placement.topo
        for r in rids:
            s = self.slab_of.get(r)
            if s is not None:
                m[topo.coord(s)] += self._slab_rw_bytes / burst
        return m

    @property
    def shared_page_savings(self) -> int:
        """Physical pages currently saved by copy-on-write sharing."""
        return self.placement.n_shared_extra

    @property
    def shared_savings_peak(self) -> int:
        """High-water mark of :attr:`shared_page_savings`."""
        return self.placement.shared_extra_peak

    # ------------------------------------------------------------------
    # shadow-ledger sanitizer (REPRO_SANITIZE=1)
    # ------------------------------------------------------------------

    def sanitizer_owned_pages(self) -> set:
        """Every page a resident request's block table accounts for."""
        return {pid for pages in self.page_table.values() for pid in pages}

    def sanitizer_check_leaks(self, what: str = "engine teardown") -> None:
        """``PL255``: raise if the shadow ledger sees live pages no owner
        accounts for.  No-op unless ``REPRO_SANITIZE=1`` attached a ledger."""
        shadow = self.placement._shadow
        if shadow is not None:
            shadow.assert_no_leaks(self.sanitizer_owned_pages(), what=what)
