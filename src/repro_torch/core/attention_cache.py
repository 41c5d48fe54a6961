"""Quantized KV-cache container for decode attention (PyTorch port).

Mirrors ``repro/core/attention_cache.py``: keys and values packed along
the head dimension, logical layout ``(B, T, KVH, d)`` with the time axis at
1.  MLA caches hold one latent stream (``v is None``) whose first
``v_width`` lanes double as values.  The port keeps one cache per layer (no
group stacking), and the slot engine writes a prefill's rows straight into
its slot (``models/model.py::write_row``), so the JAX package's
``recapacity`` has no caller here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import formats as F
from repro_torch.core.paged import PAGE_TOKENS
from repro_torch.ops.base import StateQuantConfig


@dataclasses.dataclass
class KVCache:
    """Decode-time KV cache for one attention layer.

    k/v are `QuantizedTensor` (packed) or plain tensors (float formats);
    `lengths` is (B,) int32 -- valid cached positions per sequence.  MLA:
    `v` is None and the first `v_width` lanes of `k` are the values.
    """
    k: object
    v: object
    lengths: torch.Tensor
    fmt: str = "mx8"
    v_width: Optional[int] = None     # MLA only

    @property
    def max_len(self) -> int:
        return self.k.shape[1]


def init_kv_cache(B: int, T: int, KVH: int, dk: int, cfg: StateQuantConfig,
                  dv: Optional[int] = None, device=None,
                  mla_v_width: Optional[int] = None) -> KVCache:
    """Preallocate a zeroed cache of capacity T (multiple of 128).

    ``mla_v_width`` set: a latent-only MLA cache (no value stream)."""
    if T % PAGE_TOKENS:
        raise ValueError(f"cache capacity {T} must be a multiple of "
                         f"{PAGE_TOKENS}")
    dv = dv if dv is not None else dk
    lengths = torch.zeros((B,), dtype=torch.int32, device=device)
    zk = torch.zeros((B, T, KVH, dk), dtype=torch.float32, device=device)
    zv = (None if mla_v_width is not None else
          torch.zeros((B, T, KVH, dv), dtype=torch.float32, device=device))
    if cfg.quantized:
        return KVCache(F.quantize(zk, cfg.fmt),
                       None if zv is None else F.quantize(zv, cfg.fmt),
                       lengths, cfg.fmt, mla_v_width)
    dt = F.FLOAT_DTYPES[cfg.fmt]
    return KVCache(zk.to(dt), None if zv is None else zv.to(dt), lengths,
                   cfg.fmt, mla_v_width)


def _update_at(buf: torch.Tensor, rows: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """Write rows (B, n, ...) into buf (B, T, ...) at per-row offsets idx.

    Offsets clamp to ``[0, T - n]`` exactly as ``lax.dynamic_update_slice``
    does in the JAX package (an idle slot's length may run past capacity).
    Unlike the JAX package, the write is in place: ``buf`` is returned.
    """
    B, n = rows.shape[:2]
    T = buf.shape[1]
    start = idx.to(torch.int64).clamp(0, T - n)
    pos = start[:, None] + torch.arange(n, device=buf.device)[None, :]
    buf[torch.arange(B, device=buf.device)[:, None], pos] = rows.to(buf.dtype)
    return buf
