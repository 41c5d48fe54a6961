"""Paged decode-cache views: block-table-native operand containers
(PyTorch port of ``repro/core/paged.py``).

The paged serving pool (``repro_torch/serving/memory``) stores every KV
stream as a page pool ``(n_pages, G, 128, KVH, d)`` and every recurrent
state as a slab pool ``(n_slabs, G, H, dv, dk)``, ``G`` being the number of
layers that share one pattern position.  The two containers here make that
layout an operand layout of the SPU ops:

``PagedKVCache``
    One pattern position's K/V page pools plus the step's block table.  The
    ``layout="paged"`` ops (``repro_torch/ops/paged_ops.py``) walk
    ``bt[B, npg]`` in place: the attention kernel streams each 128-token
    page straight out of the pool, the append kernel writes the new token's
    row into its page slot.  No dense copy of the context exists.

``PagedState``
    One mixer's recurrent-state slab pool plus the step's slab ids.  The
    paged ``state_update`` op updates exactly the ``B`` owned slab rows in
    place.

Both carry a ``group`` index: one view serves all ``G`` layers of a pattern
position, and the decode loop re-binds ``group`` (and the step's base
``lengths``) per layer with :func:`with_group`.  The port's model loops in
Python, so the JAX package's scan-carry split (``split_paged`` /
``merge_paged``) has no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import formats as F

__all__ = ["PAGE_TOKENS", "pages_for", "PagedKVCache", "PagedState",
           "is_paged", "with_group"]

#: tokens per KV page == the MX tile: the paged attention kernel assigns
#: exactly one page to each 128-position tile
PAGE_TOKENS = 128


def pages_for(n_tokens: int) -> int:
    """Pages that hold (and stream for) an ``n_tokens`` context.

    The single definition shared by the allocator, the paged ops' traffic
    descriptors and the engine's traffic meter (ceil, at least one page).
    """
    return max(1, -(-int(n_tokens) // PAGE_TOKENS))


def _payload_dims(stream) -> Tuple[int, ...]:
    """Pool shape of a (possibly quantized) pooled stream."""
    if isinstance(stream, F.QuantizedTensor):
        return tuple(stream.payload["mantissa"].shape)
    return tuple(stream.shape)


@dataclasses.dataclass
class PagedKVCache:
    """Block-table view of one pattern position's shared K/V page pools.

    ``k``/``v`` hold the whole pool, ``(n_pages, G, PAGE_TOKENS, KVH, d)``
    (quantized streams keep one pool per payload field; an MLA view has no
    ``v`` and its values are the first ``v_width`` lanes of ``k``).  ``bt``
    is the step's dense block table, ``lengths`` the valid context per row
    and ``group`` the layer of the position this view addresses.
    """
    k: object
    v: object
    bt: torch.Tensor                 # (B, npg) int32 physical page ids
    lengths: torch.Tensor            # (B,) int32 valid cached positions
    group: int = 0                   # layer index within the position
    fmt: str = "mx8"
    v_width: Optional[int] = None    # MLA only

    @property
    def batch(self) -> int:
        return int(self.bt.shape[0])

    @property
    def n_page_slots(self) -> int:
        """Block-table width: pages the attention walks at most per row."""
        return int(self.bt.shape[1])

    @property
    def max_len(self) -> int:
        return self.n_page_slots * PAGE_TOKENS

    @property
    def kv_heads(self) -> int:
        return _payload_dims(self.k)[3]

    @property
    def dk(self) -> int:
        return _payload_dims(self.k)[4]

    @property
    def dv(self) -> int:
        if self.v is None:
            if self.v_width is None:
                raise ValueError("a latent-only view needs v_width")
            return self.v_width
        return _payload_dims(self.v)[4]

    def with_step(self, group: int,
                  lengths: torch.Tensor) -> "PagedKVCache":
        """Re-bind the view to one layer: its index plus the step's base
        lengths (the previous layer's append bumped the view's own)."""
        return dataclasses.replace(self, group=int(group), lengths=lengths)


@dataclasses.dataclass
class PagedState:
    """Slab-pool view of one mixer's recurrent state (stored ``(B,H,dv,dk)``
    rows living at ``pool[slab_id, group]``)."""
    pool: object                     # (n_slabs, G, H, dv, dk) QT or tensor
    slabs: torch.Tensor              # (B,) int32 slab ids
    group: int = 0
    fmt: str = "mx8"

    @property
    def batch(self) -> int:
        return int(self.slabs.shape[0])

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        """Logical dense-state shape (B, H, dv, dk) of the viewed rows."""
        _, _, h, dv, dk = _payload_dims(self.pool)
        return (self.batch, h, dv, dk)

    def with_step(self, group: int, lengths=None) -> "PagedState":
        return dataclasses.replace(self, group=int(group))


def is_paged(x) -> bool:
    return isinstance(x, (PagedKVCache, PagedState))


def with_group(cache, group: int, lengths=None):
    """One pattern position's view tree re-bound to layer ``group``: paged
    containers re-bind ``group`` (KV views also the step's base lengths);
    residual leaves stacked ``(G, B, ...)`` give their layer's rows."""
    if isinstance(cache, PagedKVCache):
        return cache.with_step(group, cache.lengths if lengths is None
                               else lengths)
    if isinstance(cache, PagedState):
        return cache.with_step(group)
    if isinstance(cache, dict):
        return {k: with_group(v, group, lengths) for k, v in cache.items()}
    return cache[group]
