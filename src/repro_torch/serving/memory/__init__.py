"""The paged serving memory of the port (``repro/serving/memory``): page /
slab pools, bank-aware placement and the cache-tree paging adapter.  The
host tier and the radix prefix store follow with the tiering slice
(ROADMAP.md)."""
from repro_torch.core.paged import PAGE_TOKENS, pages_for
from repro_torch.serving.memory.layout import CachePaging, LeafSpec
from repro_torch.serving.memory.placement import (BankAwarePlacement,
                                                  BankTopology)
from repro_torch.serving.memory.pool import (PagedStatePool, SpilledRequest,
                                             bucket_pages)

__all__ = ["PAGE_TOKENS", "pages_for", "CachePaging", "LeafSpec",
           "BankAwarePlacement", "BankTopology", "PagedStatePool",
           "SpilledRequest", "bucket_pages"]
