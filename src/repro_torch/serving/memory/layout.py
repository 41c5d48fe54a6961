"""Cache-tree paging adapter: maps the model's decode caches onto page /
slab pools and back (PyTorch port of ``repro/serving/memory/layout.py``).

The port's decode caches are ``caches[g][pos]`` (layer ``g`` of pattern
position ``pos``, the shared block last) -- for a model with a prelude
``{"prelude": [...], "groups": caches[g][pos]}`` -- with

  * ``KVCache`` nodes -- K/V streams ``(B, T, KVH, d)`` (an MLA cache: one
    latent stream, no V) whose time axis is paged: cut into 128-token
    pages, each page at a physical page id shared by every KV leaf;
  * fixed-size recurrent leaves (the mixer's ``"S"`` state, conv tails) --
    slab allocated: one slab id per request indexes one row of every slab
    pool.

The port walks its own cache structure instead of probing shapes, in the
JAX package's spec order (positions in pattern order, then the shared
block, then the prelude layers -- the JAX tree's sorted ``"groups"`` /
``"prelude"`` keys; dict keys sorted; payload fields sorted), and keeps the
JAX physical layout: page pools ``(n_pages, G, 128, KVH, w)``, slab pools
``(n_slabs, G, *row)``, ``G`` the layers of a position (1 for a prelude
layer, which the JAX package stores without the G axis).

Every move is eager PyTorch and writes the pools in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence, Tuple

import torch

from repro_torch.core import attention_cache as AC
from repro_torch.core import formats as F
from repro_torch.core import paged as PG
from repro_torch.core.paged import PAGE_TOKENS
from repro_torch.kernels import ref as _ref
from repro_torch.models.model import join_caches, split_caches
from repro_torch.ops.base import fmt_of_state

Path = Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """One pooled array leaf of the cache tree."""
    kind: str                      # "page" | "slab"
    pos: int                       # position (pattern, shared, prelude)
    path: Path                     # keys from the position's cache to it
    content_shape: Tuple[int, ...]  # one page (G, 128, KVH, w) / slab (G, ..)
    dtype: torch.dtype

    @property
    def content_nbytes(self) -> int:
        return math.prod(self.content_shape) * torch.empty(
            (), dtype=self.dtype).element_size()


def _stream_paths(stream, prefix: Path) -> List[Path]:
    if isinstance(stream, F.QuantizedTensor):
        return [prefix + (f,) for f in sorted(stream.payload)]
    return [prefix]


def _leaf_paths(cache) -> List[Path]:
    """Array leaves of one position's cache, in the canonical order."""
    if isinstance(cache, AC.KVCache):
        v = [] if cache.v is None else _stream_paths(cache.v, ("v",))
        return _stream_paths(cache.k, ("k",)) + v
    return [p for key in sorted(cache)
            for p in _stream_paths(cache[key], (key,))]


def _positions(tree) -> List[List[Any]]:
    """Per position (pattern positions and the shared block, then each
    prelude layer), its layers' nodes: ``[caches[g][pos] for g]`` or
    ``[prelude[i]]``.  Works on cache trees, view lists and snapshots."""
    prelude, groups = split_caches(tree)
    return ([[grp[pos] for grp in groups] for pos in range(len(groups[0]))]
            + [[c] for c in prelude])


def _flat_views(views) -> List[Any]:
    """One node per position of a view tree (views have no layer axis)."""
    prelude, groups = split_caches(views)
    return list(groups) + list(prelude)


def _get(node, path: Path):
    """The leaf at ``path`` under a cache (or view) node."""
    for key in path:
        if isinstance(node, PG.PagedState):
            node = node.pool
        if isinstance(node, (AC.KVCache, PG.PagedKVCache)):
            node = getattr(node, key)
        elif isinstance(node, F.QuantizedTensor):
            node = node.payload[key]
        else:
            node = node[key]
    return node


class CachePaging:
    """Flattens a model's cache tree into LeafSpecs and moves data between
    pooled storage and the model's caches (dense trees or paged views)."""

    def __init__(self, template):
        """``template`` is a real cache tree at (B=1, T=PAGE_TOKENS)
        (``models.model.init_decode_caches``)."""
        self.template = template
        self.n_group_pos = len(split_caches(template)[1][0])
        layers = _positions(template)
        self.n_layers = [len(ls) for ls in layers]     # G per position
        self.templates = [ls[0] for ls in layers]      # layer 0's node
        self.specs: List[LeafSpec] = []
        for pos, cache in enumerate(self.templates):
            kind = "page" if isinstance(cache, AC.KVCache) else "slab"
            for path in _leaf_paths(cache):
                leaf = _get(cache, path)
                self.specs.append(LeafSpec(
                    kind, pos, path,
                    (self.n_layers[pos],) + tuple(leaf.shape[1:]),
                    leaf.dtype))

    def _nest(self, per_pos: List[Any]):
        """Per-position nodes back into the model's tree structure."""
        return join_caches(per_pos[self.n_group_pos:],
                           per_pos[:self.n_group_pos])

    # ------------------------------------------------------------------
    # pools
    # ------------------------------------------------------------------

    def _stacked(self, caches, spec: LeafSpec) -> torch.Tensor:
        """``spec``'s leaf of every layer, stacked ``(G, B, ...)``."""
        return torch.stack([_get(c, spec.path)
                            for c in _positions(caches)[spec.pos]])

    def make_pools(self, n_pages: int, n_slabs: int) -> List[torch.Tensor]:
        """One pool per spec: zeroed pages ``(n_pages, *content)``, and slabs
        ``(n_slabs, *content)`` replicating the template's initial state
        (a freshly pinned slab is a valid zero-context state)."""
        pools = []
        for spec in self.specs:
            if spec.kind == "page":
                dev = _get(self.templates[spec.pos], spec.path).device
                pools.append(torch.zeros((n_pages,) + spec.content_shape,
                                         dtype=spec.dtype, device=dev))
            else:
                row = self._stacked(self.template, spec)[:, 0]
                pools.append(row[None].expand(
                    (n_slabs,) + spec.content_shape).contiguous())
        return pools

    @property
    def page_nbytes(self) -> int:
        """Device bytes one page occupies across every KV pool."""
        return sum(s.content_nbytes for s in self.specs if s.kind == "page")

    @property
    def slab_nbytes(self) -> int:
        return sum(s.content_nbytes for s in self.specs if s.kind == "slab")

    # ------------------------------------------------------------------
    # whole-request moves: prefill insert, spill / resume, fork
    # ------------------------------------------------------------------

    def insert_request(self, pools: Sequence[torch.Tensor], row_caches,
                       page_ids: torch.Tensor, slab: int) -> None:
        """Pin a prefilled B=1 cache row (``T == len(page_ids) * 128``) into
        its pages and slab."""
        npg = int(page_ids.shape[0])
        for pool, spec in zip(pools, self.specs):
            rows = self._stacked(row_caches, spec)[:, 0]     # (G, T|.., ...)
            if spec.kind == "page":
                if rows.shape[1] != npg * PAGE_TOKENS:
                    raise ValueError(f"prefill row of {rows.shape[1]} "
                                     f"positions for {npg} pages")
                pages = rows.reshape((rows.shape[0], npg, PAGE_TOKENS)
                                     + tuple(rows.shape[2:]))
                pool[page_ids] = pages.transpose(0, 1).to(pool.dtype)
            else:
                pool[slab] = rows.to(pool.dtype)

    def extract_request(self, pools: Sequence[torch.Tensor],
                        page_ids: torch.Tensor, slab: int
                        ) -> List[torch.Tensor]:
        """One request's pages + slab, copied to the host (a spill blob)."""
        return [(pool[page_ids] if spec.kind == "page" else pool[slab]).to(
                    "cpu", copy=True)
                for pool, spec in zip(pools, self.specs)]

    def insert_blob(self, pools: Sequence[torch.Tensor], blob,
                    page_ids: torch.Tensor, slab: int) -> None:
        """Re-pin a spilled request (inverse of :meth:`extract_request`);
        the physical page ids may differ from the ones it left."""
        for pool, spec, vals in zip(pools, self.specs, blob):
            vals = vals.to(pool.device)
            if spec.kind == "page":
                pool[page_ids] = vals
            else:
                pool[slab] = vals

    def fork_copy(self, pools: Sequence[torch.Tensor], src_page: int,
                  dst_page: int, src_slab: int, dst_slab: int) -> None:
        """Copy-on-write fork: duplicate the parent's partially filled tail
        page and its slab row (full prefix pages are shared, not copied)."""
        for pool, spec in zip(pools, self.specs):
            if spec.kind == "page":
                pool[dst_page] = pool[src_page]
            else:
                pool[dst_slab] = pool[src_slab]

    def copy_slab(self, pools: Sequence[torch.Tensor], src_slab: int,
                  dst_slab: int) -> None:
        """Fork at an exact page boundary: only the slab row is copied."""
        for pool, spec in zip(pools, self.specs):
            if spec.kind == "slab":
                pool[dst_slab] = pool[src_slab]

    # ------------------------------------------------------------------
    # the decode step: block-table-native views (the served path)
    # ------------------------------------------------------------------

    @staticmethod
    def _pool_stream(by_path, pos: int, prefix: str, template_stream):
        if isinstance(template_stream, F.QuantizedTensor):
            payload = {f: by_path[(pos, (prefix, f))]
                       for f in sorted(template_stream.payload)}
            return F.QuantizedTensor(template_stream.fmt,
                                     tuple(payload["mantissa"].shape),
                                     payload)
        return by_path[(pos, (prefix,))]

    def _by_path(self, pools) -> Dict[Tuple[int, Path], torch.Tensor]:
        return {(s.pos, s.path): p for s, p in zip(self.specs, pools)}

    def paged_view(self, pools: Sequence[torch.Tensor], bt: torch.Tensor,
                   slabs: torch.Tensor, lengths: torch.Tensor):
        """One view per position for a decode step (nested as the model's
        caches are): KV pools as ``PagedKVCache``, ``"S"`` pools as
        ``PagedState`` (zero-copy), and the residual slab leaves (conv
        tails) gathered as ``(G, B, ...)`` rows -- the minimal traffic,
        since every step rewrites them."""
        by_path = self._by_path(pools)
        views = []
        for pos, t in enumerate(self.templates):
            if isinstance(t, AC.KVCache):
                views.append(PG.PagedKVCache(
                    self._pool_stream(by_path, pos, "k", t.k),
                    None if t.v is None
                    else self._pool_stream(by_path, pos, "v", t.v),
                    bt, lengths, 0, t.fmt, t.v_width))
                continue
            view = {}
            for key in sorted(t):
                if key == "S":
                    fmt = (t[key].fmt if isinstance(t[key], F.QuantizedTensor)
                           else fmt_of_state(t[key]))
                    view[key] = PG.PagedState(
                        self._pool_stream(by_path, pos, key, t[key]), slabs,
                        0, fmt)
                else:
                    if isinstance(t[key], F.QuantizedTensor):
                        raise ValueError(f"paged_view: quantized residual "
                                         f"leaf {key!r} is not supported")
                    view[key] = by_path[(pos, (key,))][slabs.long()
                                                       ].transpose(0, 1)
            views.append(view)
        return self._nest(views)

    def commit(self, pools: Sequence[torch.Tensor], views,
               slabs: torch.Tensor) -> None:
        """Commit a paged decode step: the KV and state pools were updated in
        place by the ops; scatter the residual slab rows back."""
        views = _flat_views(views)
        for pool, spec in zip(pools, self.specs):
            if spec.kind == "slab" and spec.path[0] != "S":
                pool[slabs.long()] = _get(views[spec.pos],
                                          spec.path).transpose(0, 1)

    def commit_select(self, pools: Sequence[torch.Tensor], snaps,
                      slabs: torch.Tensor, sel: torch.Tensor) -> None:
        """Roll every slab row back to one selected speculative position.

        ``snaps`` is what ``paged_spec_decode_step`` returns: per pattern
        position, None (attention: KV rollback is a host-side length reset)
        or ``{path: (n, B, G, *row)}``, the state rows after each of the n
        positions.  Row ``b`` of every slab pool is rewritten with
        ``snap[sel[b], b]``, in place.  A request that accepted every
        position rewrites its final state verbatim, so running this after
        :meth:`commit` is idempotent for it.
        """
        B = int(slabs.shape[0])
        bidx = torch.arange(B, device=slabs.device)
        sel = sel.long()
        snaps = _flat_views(snaps)
        for pool, spec in zip(pools, self.specs):
            if spec.kind != "slab":
                continue
            snap = snaps[spec.pos]
            if snap is None:
                raise ValueError(f"no snapshot for slab leaf {spec.path} of "
                                 f"position {spec.pos}")
            pool[slabs.long()] = snap[spec.path][sel, bidx].to(pool.dtype)

    # ------------------------------------------------------------------
    # the dense-gather reference path (parity testing)
    # ------------------------------------------------------------------

    def gather(self, pools: Sequence[torch.Tensor], bt: torch.Tensor,
               slabs: torch.Tensor, lengths: torch.Tensor):
        """Materialize the dense cache tree ``caches[g][pos]`` of one decode
        step: the block table's pages and the slab rows, copied out."""
        views = _flat_views(self.paged_view(pools, bt, slabs, lengths))

        def dense(view, g):
            if isinstance(view, PG.PagedKVCache):
                v = (None if view.v is None
                     else _ref.gather_pages(view.v, bt, g))
                return AC.KVCache(_ref.gather_pages(view.k, bt, g), v,
                                  lengths, view.fmt, view.v_width)
            return {k: (_gather_rows(v.pool, slabs, g)
                        if isinstance(v, PG.PagedState) else v[g].clone())
                    for k, v in view.items()}

        per_pos = [[dense(view, g) for g in range(n)]
                   for view, n in zip(views, self.n_layers)]
        groups = [[per_pos[pos][g] for pos in range(self.n_group_pos)]
                  for g in range(self.n_layers[0])]
        return join_caches([ls[0] for ls in per_pos[self.n_group_pos:]],
                           groups)

    def scatter_step(self, pools: Sequence[torch.Tensor], new_caches,
                     bt: torch.Tensor, slabs: torch.Tensor,
                     lengths: torch.Tensor) -> None:
        """Commit one dense decode step: the token row each request appended
        at ``lengths`` goes to its page, slab rows are rewritten."""
        B = bt.shape[0]
        rows = torch.arange(B, device=bt.device)
        lens = lengths.long()
        page = bt.long()[rows, lens // PAGE_TOKENS]
        off = lens % PAGE_TOKENS
        for pool, spec in zip(pools, self.specs):
            dense = self._stacked(new_caches, spec)          # (G, B, ...)
            if spec.kind == "page":
                pool[page, :, off] = dense[:, rows, lens].transpose(0, 1)
            else:
                pool[slabs.long()] = dense.transpose(0, 1)


def _gather_rows(pool, slabs: torch.Tensor, group: int):
    """Slab rows ``pool[slabs, group]`` as a dense state (copied)."""
    idx = (slabs.long(), group)
    if isinstance(pool, F.QuantizedTensor):
        payload = {f: a[idx] for f, a in pool.payload.items()}
        return F.QuantizedTensor(pool.fmt, tuple(payload["mantissa"].shape),
                                 payload)
    return pool[idx]
