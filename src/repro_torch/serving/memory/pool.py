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
victim's private pages + slab to host memory bit-exactly (pinned on the
card, CRC-checked); resume re-pins them to fresh physical ids.  The host
tier, async prefetch and the prefix store extend this class in
:mod:`.tiered`.

Under tensor parallelism (``par``) each rank's pool holds its heads of
every page and slab (``models.model.init_decode_caches(..., par=)``) and
its steps run the tensor-parallel model step; the block tables, slab ids
and every other host-side decision are the same on every rank, so spill,
resume and the host tier move each rank's own pages.

Under data parallelism (``data_rows``, a ``dist.rows.DataRows``) a rank
decodes only its block of the decode rows, and a page or slab holds valid
bits only on the data ranks that wrote it (its *homes*,
:class:`DataHomes`): the rank of the row whose prefill or step wrote it,
and every rank a copy reached.  Copies between ids (fork, spill, resume,
the host tier, the prefix store) carry the homes with the bits.  Before a
step, every page or slab a row is about to read that is not valid on the
row's rank is broadcast from its first home over the data group
(``dp_moves`` / ``dp_move_bytes``).  Every rank holds the whole id space,
as every device holds the JAX engine's replicated pools.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import ops as OPS
from repro_torch.core.paged import PAGE_TOKENS, pages_for
from repro_torch.dist.rows import DataRows
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.serving.memory.layout import CachePaging
from repro_torch.serving.memory.placement import (BankAwarePlacement,
                                                  BankTopology)
from repro_torch.serving.resilience import crc_blob, verify_blob


def _paged_step(paging: CachePaging, cfg: ModelConfig, par, params, pools,
                bt, slabs, lengths, tokens, seed) -> torch.Tensor:
    """Block-table-native step: the layout="paged" ops read pages and slab
    rows where they live and write the new token / state back in place --
    no gathered dense cache exists in the steady-state loop."""
    views = paging.paged_view(pools, bt, slabs, lengths)
    logits, views = M.paged_decode_step(params, cfg, tokens, views, lengths,
                                        seed=seed, par=par)
    paging.commit(pools, views, slabs)
    return logits


def _spec_step(paging: CachePaging, cfg: ModelConfig, par, params, pools,
               bt, slabs, lengths, tokens, seed):
    """Speculative verify step: tokens (B, n) through the paged caches in
    one pass; the per-position state snapshots come back so ``commit_spec``
    can roll rejected positions back bit-exactly."""
    views = paging.paged_view(pools, bt, slabs, lengths)
    logits, views, snaps = M.paged_spec_decode_step(
        params, cfg, tokens, views, lengths, seed=seed, par=par)
    paging.commit(pools, views, slabs)
    return logits, snaps


def _gather_step(paging: CachePaging, cfg: ModelConfig, par, params, pools,
                 bt, slabs, lengths, tokens, seed) -> torch.Tensor:
    """Dense-gather reference step: gather the context, run the dense ops,
    scatter one token back (bit-exact parity checks)."""
    caches = paging.gather(pools, bt, slabs, lengths)
    logits, caches = M.decode_step(params, cfg, tokens, caches, lengths,
                                   seed=seed, par=par)
    paging.scatter_step(pools, caches, bt, slabs, lengths)
    return logits


def bucket_pages(npg: int) -> int:
    """Round a page count up to a power of two (a bounded set of block-table
    widths, as in the JAX package, where each width is one compile)."""
    return 1 << max(0, (npg - 1).bit_length())


class DataHomes:
    """The data ranks on which each page's and slab's bits are valid.

    Inactive (every query returns None, every update is a no-op) unless
    ``rows`` splits the decode rows over data ranks.  Every rank keeps the
    same table: it follows the replicated host-side decisions."""

    def __init__(self, rows):
        self.rows = rows
        self.active = rows.split
        self.pages: Dict[int, FrozenSet[int]] = {}
        self.slabs: Dict[int, FrozenSet[int]] = {}
        #: pages and slabs moved between data ranks, and their bytes
        self.moves = 0
        self.move_bytes = 0.0

    def of_row(self, row: int) -> Optional[FrozenSet[int]]:
        return self.rows.owners(row) if self.active else None

    def set_pages(self, ids: Sequence[int], homes) -> None:
        """``homes``: one set for every id, or a sequence of sets."""
        if not self.active:
            return
        each = isinstance(homes, (list, tuple))
        for i, pid in enumerate(ids):
            self.pages[pid] = frozenset(homes[i] if each else homes)

    def set_slab(self, slab: int, homes) -> None:
        if self.active:
            self.slabs[slab] = frozenset(homes)

    def page_homes(self, ids: Sequence[int]) -> Optional[tuple]:
        if not self.active:
            return None
        return tuple(self.pages.get(pid, frozenset()) for pid in ids)

    def slab_homes(self, slab: int) -> Optional[FrozenSet[int]]:
        return self.slabs.get(slab, frozenset()) if self.active else None

    def forget_pages(self, ids: Sequence[int]) -> None:
        """Pages back on the free list: valid nowhere."""
        for pid in ids:
            self.pages.pop(pid, None)


@dataclasses.dataclass
class SpilledRequest:
    """Host-side copy of an evicted request's state (bit-exact).

    Only *privately owned* pages are extracted into ``blob`` (CPU tensors,
    one per pool spec); pages shared with other resident requests stay on
    the device and the spilled request keeps its reference on them
    (``shared``: (block-table position, physical id)), so resume reuses
    those ids verbatim.
    """
    blob: List[torch.Tensor]            # pinned when spilled off the card
    n_pages: int                        # total block-table length
    length: int
    private_idx: List[int] = dataclasses.field(default_factory=list)
    shared: List[tuple] = dataclasses.field(default_factory=list)
    #: CRC32 of ``blob`` at extraction; resume verifies it
    crc: Optional[int] = None
    #: under data parallelism, the data ranks whose blob holds valid bits:
    #: (one set per private page, the slab's set); their host tiers hold
    #: the request
    homes: Optional[Tuple[tuple, FrozenSet[int]]] = None

    @property
    def pages_needed(self) -> int:
        """Fresh pages a resume must allocate (private pages only)."""
        return len(self.private_idx)


class PagedStatePool:
    """Block/page-granular pool backing both KV caches and SSM states.

    Page id 0 and slab id 0 are reserved scratch targets for idle decode
    rows; usable capacity is ``n_pages - 1`` pages / ``n_slabs - 1`` slabs.
    The pools live on ``device`` (the card unless the caller asks for the
    CPU); under ``par`` (tensor parallelism) they hold this rank's heads.
    """

    def __init__(self, cfg: ModelConfig, n_pages: Optional[int] = None,
                 n_slabs: int = 9, byte_budget: Optional[int] = None,
                 topology: Optional[BankTopology] = None,
                 decode_mode: str = "paged", device=None, par=None,
                 data_rows=None):
        if decode_mode not in ("paged", "gather"):
            raise ValueError(f"decode_mode must be 'paged' or 'gather', got "
                             f"{decode_mode!r}")
        self.cfg = cfg
        self.decode_mode = decode_mode
        self.device = M.resolve_device(device)
        #: the decode rows' split over data ranks (default: one data rank)
        self.data_rows = data_rows if data_rows is not None else DataRows(
            None, 0)
        self.homes = DataHomes(self.data_rows)
        self.paging = CachePaging(
            M.init_decode_caches(cfg, 1, PAGE_TOKENS, device=self.device,
                                 par=par))

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
        # the steppers over the pools (in place); ``attach_obs`` puts the
        # recompile watcher around each, under the JAX package's site names.
        # None holds the pool itself: a pool dropped by its engine frees its
        # device memory at once, without waiting for the cycle collector
        self._decode = partial(_paged_step, self.paging, cfg, par)
        self._decode_spec = partial(_spec_step, self.paging, cfg, par)
        self._commit_spec = self.paging.commit_select
        self._decode_gather = partial(_gather_step, self.paging, cfg, par)
        self._insert = self.paging.insert_request
        self._insert_blob = self.paging.insert_blob
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
        #: optional repro_torch.serving.faults.FaultPlan -- when installed
        #: (the engine sets it), allocation sites may report injected
        #: transient failures
        self.faults = None

    def attach_obs(self, obs) -> None:
        """Attach an engine's :class:`repro_torch.obs.Observability`
        bundle: the pool steppers get recompile watchers, the placement
        mirrors page alloc / free / ref into the metrics registry, and page
        movement (register / grow / fork / spill / resume / release) emits
        instants on the pool track."""
        self._obs = obs
        obs.recompiles.fixed(self.pools)
        self._decode = obs.wrap_step(self._decode, "pool.decode")
        self._decode_spec = obs.wrap_step(self._decode_spec,
                                          "pool.decode_spec")
        self._commit_spec = obs.wrap_step(self._commit_spec,
                                          "pool.commit_spec")
        self._decode_gather = obs.wrap_step(self._decode_gather,
                                            "pool.decode_gather")
        self._insert = obs.wrap_step(self._insert, "pool.prefill_insert")
        self._insert_blob = obs.wrap_step(self._insert_blob,
                                          "pool.resume_insert")
        self.placement.metrics = obs.metrics

    def _instant(self, name: str, **args) -> None:
        if self._obs is not None:
            self._obs.tracer.instant(name, cat="pool", track="pool", **args)

    def _inject(self, site: str, rid: Optional[int] = None,
                what: str = "") -> bool:
        """One fault-plan consult: True means the caller must fail now.
        Fires are mirrored into ``faults_injected_total{site=}`` and a
        ``cat="fault"`` trace instant."""
        if self.faults is None or not self.faults.should_fire(site, rid=rid):
            return False
        if self._obs is not None:
            self._obs.metrics.counter("faults_injected_total",
                                      site=site).inc()
            self._obs.tracer.instant(f"fault.{site}", cat="fault",
                                     track="pool", rid=rid, what=what)
        return True

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
        if self._inject("alloc", rid=rid, what="register"):
            return False                # injected transient shortage
        pages = self.placement.alloc(n_pages)
        if pages is None:
            return False
        self.page_table[rid] = pages
        self.slab_of[rid] = self._free_slabs.pop()
        self.pages_allocated += n_pages
        self._instant("pool.register", rid=rid, pages=n_pages)
        return True

    def grow(self, rid: int, n_new: int) -> bool:
        """Extend a request's block table -- copy-free, just new page ids."""
        if self._inject("alloc", rid=rid, what="grow"):
            return False                # injected transient shortage
        pages = self.placement.alloc(n_new)
        if pages is None:
            return False
        self.page_table[rid].extend(pages)
        self.pages_allocated += n_new
        self._instant("pool.grow", rid=rid, pages=n_new)
        return True

    def release(self, rid: int):
        """Drop a request's references: pages return to the free list only
        when the last owner drops them (forks keep shared prefix pages
        alive); the slab is always exclusive and frees now."""
        pages = self.page_table.pop(rid)
        self.homes.forget_pages(self.placement.unref(pages))
        self._free_slabs.append(self.slab_of.pop(rid))
        self._instant("pool.release", rid=rid, pages=len(pages))

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
            self.homes.set_pages(new_pages, self.homes.page_homes(
                [parent_pages[n_full]]))
            self._account_gather(self.page_nbytes + self.slab_nbytes)
        else:
            self.paging.copy_slab(self.pools, src_slab, slab)
            self._account_gather(self.slab_nbytes)
        if self.homes.active:
            self.homes.set_slab(slab, self.homes.slab_homes(src_slab))
        self._instant("pool.fork", parent=parent_rid, child=child_rid,
                      shared_pages=len(shared), copied_pages=len(new_pages))
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

    def insert_prefill(self, rid: int, row_caches, row: Optional[int] = None):
        """Pin a prefilled B=1 cache row (T must equal npg*PAGE_TOKENS).
        Under data parallelism the prefill ran on the ranks of decode row
        ``row``, and the others pass ``row_caches`` None: their bits of the
        request are not valid."""
        if row_caches is not None:
            self._insert(self.pools, row_caches,
                         self._ids(self.page_table[rid]), self.slab_of[rid])
        if self.homes.active:
            owners = self.homes.of_row(row)
            self.homes.set_pages(self.page_table[rid], owners)
            self.homes.set_slab(self.slab_of[rid], owners)
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
        homes = (None if not self.homes.active else
                 (self.homes.page_homes(priv),
                  self.homes.slab_homes(self.slab_of[rid])))
        self.page_table.pop(rid)
        self.homes.forget_pages(self.placement.unref(priv))
        self._free_slabs.append(self.slab_of.pop(rid))
        self._account_gather(self.request_nbytes(len(priv)))
        self._instant("pool.spill", rid=rid, private_pages=len(priv),
                      shared_pages=len(shared))
        # checksum the host copy at the tier boundary: resume verifies it
        return SpilledRequest(blob, len(pages), length,
                              private_idx=private_idx, shared=shared,
                              crc=crc_blob(blob), homes=homes)

    def resume(self, rid: int, sp: SpilledRequest) -> bool:
        """Re-pin a spilled request: private pages land on fresh physical
        ids, shared prefix pages rejoin the block table verbatim."""
        assert rid not in self.page_table
        if not self.can_admit(sp.pages_needed):
            return False
        # a corrupted byte must stop here (BlobCorruption), not surface as
        # garbage logits
        verify_blob(sp.blob, sp.crc, "spill blob", rid=rid)
        if self._inject("alloc", rid=rid, what="resume"):
            return False                # injected transient shortage
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
        self._insert_blob(self.pools, sp.blob, self._ids(fresh), slab)
        self._adopt_homes(sp, fresh, slab)
        self._account_gather(self.request_nbytes(sp.pages_needed))
        self._instant("pool.resume", rid=rid, pages=sp.pages_needed,
                      shared_pages=len(sp.shared))
        return True

    def _adopt_homes(self, sp: SpilledRequest, pages: Sequence[int],
                     slab: int) -> None:
        """A spilled request's bits re-entered ``pages`` and ``slab``: valid
        where its blob was."""
        if sp.homes is not None:
            self.homes.set_pages(pages, sp.homes[0])
            self.homes.set_slab(slab, sp.homes[1])

    def drop_spilled(self, sp: SpilledRequest, rid: Optional[int] = None):
        """Abort a spilled request: release the references its blob holds on
        still-resident shared pages (the last owner to drop frees them).
        ``rid`` lets the tiered pool release per-request host accounting."""
        self.homes.forget_pages(
            self.placement.unref([pid for _, pid in sp.shared]))
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
        # lint: disable=JH103  pages bucketed (bucket_pages); rows = slots
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

    def _local(self, rids, *per_row):
        """This rank's rows of ``rids`` and of each per-row array."""
        dr = self.data_rows
        if not dr.split:
            return (list(rids),) + per_row
        return (list(rids[dr.lo:dr.hi]),) + tuple(a[dr.lo:dr.hi]
                                                 for a in per_row)

    def _fetch(self, rids: Sequence[Optional[int]], lengths, n: int) -> None:
        """Before a step over ``rids`` at ``lengths`` and ``n`` positions a
        row: broadcast over the data group, from its first home, every page
        a row reads (``pages_for(length + n)`` of its table) and every slab
        that is not valid on the row's rank.  Every rank computes the same
        moves; afterwards the moved ids are valid everywhere."""
        h = self.homes
        if not h.active:
            return
        moves: Dict[int, List[Tuple[str, int]]] = {}
        for row, rid in enumerate(rids):
            if rid is None:
                continue
            owners = h.of_row(row)
            table = self.page_table[rid]
            npg = min(pages_for(int(lengths[row]) + n), len(table))
            for pid in table[:npg]:
                have = h.pages.get(pid)
                if have and not owners <= have:
                    moves.setdefault(min(have), []).append(("page", pid))
            slab = self.slab_of[rid]
            have = h.slabs.get(slab)
            if self.slab_nbytes and have and not owners <= have:
                moves.setdefault(min(have), []).append(("slab", slab))
        everywhere = frozenset(range(self.data_rows.dp))
        for src in sorted(moves):
            items = list(dict.fromkeys(moves[src]))
            for kind in ("page", "slab"):
                ids = [i for k, i in items if k == kind]
                if not ids:
                    continue
                idx = self._ids(ids)
                for pool, spec in zip(self.pools, self.paging.specs):
                    if spec.kind == kind:
                        pool[idx] = self.data_rows.broadcast(pool[idx], src)
                if kind == "page":
                    h.set_pages(ids, everywhere)
                else:
                    for i in ids:
                        h.set_slab(i, everywhere)
                h.moves += len(ids)
                h.move_bytes += len(ids) * (self.page_nbytes if kind == "page"
                                            else self.slab_nbytes)

    def _wrote(self, rids: Sequence[Optional[int]], lengths, n: int) -> None:
        """After a step: each row's slab and the pages of its ``n`` new
        positions are valid on the row's rank alone."""
        h = self.homes
        if not h.active:
            return
        for row, rid in enumerate(rids):
            if rid is None:
                continue
            owners = h.of_row(row)
            table = self.page_table[rid]
            first = int(lengths[row]) // PAGE_TOKENS
            last = (int(lengths[row]) + n - 1) // PAGE_TOKENS
            h.set_pages(table[first:last + 1], owners)
            h.set_slab(self.slab_of[rid], owners)

    def decode(self, params, rids: Sequence[Optional[int]],
               tokens: np.ndarray, lengths: np.ndarray, seed: int
               ) -> torch.Tensor:
        """Run one batched decode step over ``rids`` (None = idle row),
        updating the pools in place.  Returns logits (B, V) on the device.
        Under data parallelism the rank steps its rows (stochastic rounding
        counted from its first row of the whole batch) and every rank gets
        the whole batch's logits.

        ``decode_mode="paged"`` runs the block-table-native ops over the
        pools; ``"gather"`` the dense-gather reference path.
        """
        self._fetch(rids, lengths, 1)
        local, toks_l, lens_l = self._local(rids, tokens, lengths)
        bt, slabs, lens, toks = self._step_tensors(local, lens_l, toks_l)
        step = (self._decode if self.decode_mode == "paged"
                else self._decode_gather)
        with self.data_rows.sr_rows():
            logits = step(params, self.pools, bt, slabs, lens, toks, seed)
        self._wrote(rids, lengths, 1)
        return self.data_rows.gather(logits)

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
        n = int(np.shape(tokens)[1])
        self._fetch(rids, lengths, n)
        local, toks_l, lens_l = self._local(rids, tokens, lengths)
        bt, slabs, lens, toks = self._step_tensors(local, lens_l, toks_l,
                                                   min_pages)
        with self.data_rows.sr_rows():
            logits, snaps = self._decode_spec(params, self.pools, bt, slabs,
                                              lens, toks, seed)
        self._wrote(rids, lengths, n)
        return self.data_rows.gather(logits), snaps

    def commit_spec(self, rids: Sequence[Optional[int]], snaps,
                    sel: np.ndarray) -> None:
        """Roll recurrent state back to each row's last accepted position
        (``sel`` (B,), an index into the verify step's n positions).  KV
        needs no rollback -- the engine's host lengths mask rejected rows
        and later appends overwrite them.  Under data parallelism the rank
        rolls back its rows (``snaps`` are its step's)."""
        local, sel_l = self._local(rids, np.asarray(sel, np.int64))
        self._commit_spec(
            self.pools, snaps, self._slabs(local),
            torch.as_tensor(sel_l, device=self.device))

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
        """Every page a resident request's block table accounts for; the
        tiered pool adds staged prefetches and resident store nodes."""
        return {pid for pages in self.page_table.values() for pid in pages}

    def sanitizer_check_leaks(self, what: str = "engine teardown") -> None:
        """``PL255``: raise if the shadow ledger sees live pages no owner
        accounts for.  No-op unless ``REPRO_SANITIZE=1`` attached a ledger."""
        shadow = self.placement._shadow
        if shadow is not None:
            shadow.assert_no_leaks(self.sanitizer_owned_pages(), what=what)
