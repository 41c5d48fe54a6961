"""Persistent radix-tree prefix index over full 128-token pages (PyTorch
port of ``repro/serving/memory/prefix_store.py``).

Real serving traffic shares prompts implicitly -- every request carries
the same system prompt -- and the pool forgets those pages the moment the
request that prefilled them retires.  This module is the index that makes
the sharing automatic: a radix tree keyed by token ids, one node per *full*
page (``PAGE_TOKENS`` tokens), so a new request whose prompt extends a
previously-served prefix can adopt the stored pages with a refcount bump
instead of re-prefilling them.

Design points:

  * Nodes only ever represent *immutable full pages*.  A partially-filled
    tail page is never inserted -- it is still being written by its request.
  * The tree is pure Python; it never touches a tensor.  The pool
    (:class:`~repro_torch.serving.memory.tiered.TieredStatePool`) owns the
    device / host payloads and tells the store which node holds which page.
  * A node can be *resident* (``device_page`` set: the pool holds one
    placement reference on its behalf) or *demoted* (``host_blob`` set: the
    page payload lives in the host tier, pinned).  Both count against
    ``capacity_pages``.
  * Eviction is LRU over *leaf* nodes only -- evicting an interior node would
    orphan its descendants' token paths.  The pool additionally passes a
    ``locked`` predicate so pages still referenced by live requests or spill
    blobs are never evicted (refcount-aware eviction).
  * For recurrent / hybrid architectures bit-exactness needs more than KV
    pages: each node may also carry a host snapshot of the recurrent state
    *at the end of its page* (``state``), captured when the request that
    created the node crossed that page boundary.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

Chunk = Tuple[int, ...]


@dataclasses.dataclass(eq=False)
class StoredPage:
    """One radix-tree node == one immutable full page of a stored prefix."""
    chunk: Chunk                       # the PAGE_TOKENS token ids of this page
    depth: int                         # 1-based: prefix length = depth * PAGE_TOKENS
    parent: Optional["StoredPage"]
    node_id: int
    children: Dict[Chunk, "StoredPage"] = dataclasses.field(default_factory=dict)
    #: physical device page id when resident (store holds one placement ref)
    device_page: Optional[int] = None
    #: host-tier payload (list of pinned CPU tensors) when demoted
    host_blob: Optional[object] = None
    #: CRC32 of ``host_blob`` recorded at demotion; promote verifies it,
    #: evicting the node on mismatch (a corrupt cache entry is a miss,
    #: never a poisoned hit)
    host_crc: Optional[int] = None
    #: host snapshot of the recurrent state at the *end* of this page; an
    #: empty list is valid (attention-only models have no slab leaves)
    state: Optional[object] = None
    last_used: int = 0
    #: under data parallelism, the data ranks whose copies of ``state`` and
    #: ``host_blob`` hold valid bits (the slab's and the page's homes when
    #: they were taken)
    state_homes: Optional[object] = None
    host_homes: Optional[object] = None

    @property
    def resident(self) -> bool:
        return self.device_page is not None

    @property
    def is_leaf(self) -> bool:
        return not self.children


class PrefixStore:
    """Radix tree of stored prefix pages with LRU, leaf-only eviction.

    The store tracks *which* prefixes are cached and in what tier; it never
    owns device memory directly.  ``capacity_pages`` bounds the total node
    count (resident + demoted) -- the pool calls :meth:`evict_candidates`
    and :meth:`remove` to enforce it, skipping locked nodes.
    """

    def __init__(self, capacity_pages: int, page_tokens: int = 128):
        if capacity_pages < 1:
            raise ValueError("capacity_pages must be >= 1")
        self.capacity_pages = capacity_pages
        self.page_tokens = page_tokens
        self._root: Dict[Chunk, StoredPage] = {}
        self._nodes: List[StoredPage] = []
        self._clock = itertools.count(1)
        self._ids = itertools.count(0)
        # counters (read by the pool / stats)
        self.inserts = 0
        self.evictions = 0

    # ------------- token helpers -------------

    def chunks(self, tokens: Sequence[int],
               max_pages: Optional[int] = None) -> List[Chunk]:
        """Split ``tokens`` into full-page chunks (partial tail dropped)."""
        n = len(tokens) // self.page_tokens
        if max_pages is not None:
            n = min(n, max_pages)
        return [tuple(int(t) for t in
                      tokens[i * self.page_tokens:(i + 1) * self.page_tokens])
                for i in range(n)]

    # ------------- lookup / insert -------------

    def match(self, chunks: Sequence[Chunk]) -> List[StoredPage]:
        """Longest stored path matching ``chunks`` front-to-back.

        Touches every matched node's LRU clock (a hit is a use)."""
        path: List[StoredPage] = []
        level = self._root
        for ch in chunks:
            node = level.get(ch)
            if node is None:
                break
            path.append(node)
            level = node.children
        self.touch(path)
        return path

    def extend(self, chunks: Sequence[Chunk]
               ) -> Tuple[List[StoredPage], List[StoredPage]]:
        """Walk/create the path for ``chunks``; returns (path, created)."""
        path: List[StoredPage] = []
        created: List[StoredPage] = []
        level = self._root
        parent: Optional[StoredPage] = None
        for depth, ch in enumerate(chunks, start=1):
            node = level.get(ch)
            if node is None:
                node = StoredPage(chunk=ch, depth=depth, parent=parent,
                                  node_id=next(self._ids))
                level[ch] = node
                self._nodes.append(node)
                created.append(node)
                self.inserts += 1
            path.append(node)
            parent = node
            level = node.children
        self.touch(path)
        return path, created

    def touch(self, nodes: Sequence[StoredPage]):
        tick = next(self._clock)
        for n in nodes:
            n.last_used = tick

    # ------------- eviction -------------

    @property
    def n_pages(self) -> int:
        return len(self._nodes)

    def over_capacity(self) -> int:
        return max(0, self.n_pages - self.capacity_pages)

    def lru_nodes(self) -> List[StoredPage]:
        return sorted(self._nodes, key=lambda n: n.last_used)

    def evict_candidates(
            self, locked: Optional[Callable[[StoredPage], bool]] = None
    ) -> List[StoredPage]:
        """Evictable leaves, LRU-first.  ``locked(node)`` True exempts it."""
        out = [n for n in self.lru_nodes() if n.is_leaf]
        if locked is not None:
            out = [n for n in out if not locked(n)]
        return out

    def remove(self, node: StoredPage):
        """Detach a *leaf* node from the tree.  Caller frees its payloads."""
        assert node.is_leaf, "only leaf nodes are evictable"
        level = self._root if node.parent is None else node.parent.children
        assert level.get(node.chunk) is node
        del level[node.chunk]
        self._nodes.remove(node)
        self.evictions += 1

    # ------------- introspection (tests / stats) -------------

    def nodes(self) -> List[StoredPage]:
        return list(self._nodes)

    def resident_pages(self) -> List[int]:
        return [n.device_page for n in self._nodes if n.resident]
