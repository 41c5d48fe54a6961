"""The paged serving memory of the port (``repro/serving/memory``): page /
slab pools, bank-aware placement, the cache-tree paging adapter, the host
tier with async prefetch and the radix prefix store."""
from repro_torch.core.paged import PAGE_TOKENS, pages_for
from repro_torch.serving.memory.layout import CachePaging, LeafSpec
from repro_torch.serving.memory.placement import (BankAwarePlacement,
                                                  BankTopology)
from repro_torch.serving.memory.pool import (PagedStatePool, SpilledRequest,
                                             bucket_pages)
from repro_torch.serving.memory.prefix_store import PrefixStore, StoredPage
from repro_torch.serving.memory.tiered import HostTier, TieredStatePool

__all__ = ["PAGE_TOKENS", "pages_for", "CachePaging", "LeafSpec",
           "BankAwarePlacement", "BankTopology", "PagedStatePool",
           "SpilledRequest", "bucket_pages", "PrefixStore", "StoredPage",
           "HostTier", "TieredStatePool"]
