"""Decode attention and KV-cache append as registered SpuOps (PyTorch port).

Mirrors ``repro/ops/attention.py``:

``kv_append``   -- quantize the new token's K/V (or MLA latent) rows (SR
                   seeds ``seed`` and ``seed + 1``) and scatter them into
                   the cache at each row's length, in place: ``cuda`` (MX8:
                   one fused quantize-and-append launch for all streams)
                   or ``torch`` (every format: a quantize and a scatter,
                   as the JAX package leaves it to XLA).
``attn_decode`` -- one-token GQA attention against the packed cache:
                   ``cuda`` (the MX8 kernel) or ``torch`` (every format).
``mla_decode``  -- the MLA variant: a single latent stream whose first
                   ``v_width`` lanes double as values (the kernel's MLA
                   mode).  The cache's ``v_width`` selects it.

The cache container picks the layout: a dense ``KVCache`` dispatches the
ops here, a block-table ``PagedKVCache`` the ``layout="paged"`` ops of
``repro_torch/ops/paged_ops.py``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import attention_cache as AC
from repro_torch.core import formats as F
from repro_torch.core.paged import PagedKVCache
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.mx_attention import mx_attention_decode as _attn_cuda
from repro_torch.kernels.mx_quant import mx_kv_append_quant as _append_cuda
from repro_torch.ops import registry
from repro_torch.ops.base import (OPERAND_BYTES, OUTPUT_BYTES, OpPlan, SpuOp,
                                  StateQuantConfig, TrafficBytes,
                                  fmt_of_state)

_U32 = 0xFFFFFFFF


def _cache_row_vals(plan: OpPlan) -> int:
    """Stored values per cached token across K and V streams."""
    return plan.dim("KVH") * (plan.dim("dk") + plan.dim("dv"))


class _KVAppendBase(SpuOp):
    kind = "kv_append"

    def traffic(self, plan: OpPlan) -> TrafficBytes:
        B, n = plan.dim("B"), plan.dim("n")
        vals = B * n * _cache_row_vals(plan)
        return TrafficBytes(state_write=vals * plan.bits_per_val / 8.0,
                            operand_read=vals * OPERAND_BYTES)


@registry.register
class KVAppendCuda(_KVAppendBase):
    """One launch quantizes the n new rows of every stream (K seed
    ``seed``, V ``seed + 1``) into the dense MX8 cache at each row's
    length: bitwise the ``torch`` twin."""
    backend = "cuda"
    formats = ("mx8",)

    def execute(self, cache: AC.KVCache, inputs: Dict[str, Any],
                plan: OpPlan) -> Tuple[AC.KVCache, None]:
        k_new, v_new = inputs["k"], inputs.get("v")
        streams, caches = [k_new.to(torch.float32)], [cache.k]
        if v_new is not None:           # an MLA latent stream has no V
            streams.append(v_new.to(torch.float32))
            caches.append(cache.v)
        _append_cuda(streams, caches, cache.lengths,
                     int(inputs.get("seed", 0)) & _U32,
                     rounding=plan.rounding)
        return AC.KVCache(cache.k, cache.v, cache.lengths + k_new.shape[1],
                          cache.fmt, cache.v_width), None


@registry.register
class KVAppendTorch(_KVAppendBase):
    """Quantize + scatter n new token rows into a KV cache (in place)."""
    backend = "torch"
    formats = ("mx8", "int8", "fp8_e4m3", "fp8_e5m2", "fp32", "bf16", "fp16")

    def execute(self, cache: AC.KVCache, inputs: Dict[str, Any],
                plan: OpPlan) -> Tuple[AC.KVCache, None]:
        k_new, v_new = inputs["k"], inputs.get("v")
        seed = int(inputs.get("seed", 0)) & _U32
        stochastic = plan.rounding == "stochastic"

        def put(stream, rows, s):
            if not isinstance(stream, F.QuantizedTensor):
                return AC._update_at(stream, rows, cache.lengths)
            bits = (F.sr_bits(rows.shape, s, device=rows.device)
                    if stochastic else None)
            qr = F.quantize(rows, cache.fmt, plan.rounding, bits)
            for f, a in stream.payload.items():
                AC._update_at(a, qr.payload[f], cache.lengths)
            return stream

        nk = put(cache.k, k_new, seed)
        nv = (cache.v if v_new is None
              else put(cache.v, v_new, (seed + 1) & _U32))
        return AC.KVCache(nk, nv, cache.lengths + k_new.shape[1],
                          cache.fmt, cache.v_width), None


class _AttnDecodeBase(SpuOp):
    def traffic(self, plan: OpPlan) -> TrafficBytes:
        B, T, H = plan.dim("B"), plan.dim("T"), plan.dim("H")
        cache = B * T * _cache_row_vals(plan) * plan.bits_per_val / 8.0
        dv_out = plan.opt("v_width") or plan.dim("dv")
        return TrafficBytes(
            state_read=cache,
            operand_read=B * H * plan.dim("dk") * OPERAND_BYTES,
            output_write=B * H * dv_out * OUTPUT_BYTES)


class _AttnDecodeCuda(_AttnDecodeBase):
    """Fused decode attention over the packed MX8 cache (GQA or MLA)."""
    backend = "cuda"
    formats = ("mx8",)

    def execute(self, cache: AC.KVCache, inputs: Dict[str, Any],
                plan: OpPlan) -> Tuple[AC.KVCache, torch.Tensor]:
        return cache, _attn_cuda(inputs["q"], cache.k, cache.v, cache.lengths,
                                 scale=plan.opt("scale"),
                                 v_width=plan.opt("v_width"))


def dequantized(cache, v_width: Optional[int]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A dense cache's K and V in f32; MLA: V is K's first ``v_width``
    lanes."""
    def deq(s):
        return (F.dequantize(s) if isinstance(s, F.QuantizedTensor)
                else s.to(torch.float32))
    kf = deq(cache.k)
    return kf, kf[..., :v_width] if cache.v is None else deq(cache.v)


class _AttnDecodeTorch(_AttnDecodeBase):
    """Plain decode attention for every storage format."""
    backend = "torch"
    formats = ("mx8", "int8", "fp8_e4m3", "fp8_e5m2", "fp32", "bf16", "fp16")

    def execute(self, cache: AC.KVCache, inputs: Dict[str, Any],
                plan: OpPlan) -> Tuple[AC.KVCache, torch.Tensor]:
        kf, vf = dequantized(cache, plan.opt("v_width"))
        return cache, _ref.attention_decode_ref(inputs["q"], kf, vf,
                                                cache.lengths,
                                                plan.opt("scale"))


@registry.register
class AttnDecodeCuda(_AttnDecodeCuda):
    kind = "attn_decode"


@registry.register
class AttnDecodeTorch(_AttnDecodeTorch):
    kind = "attn_decode"


@registry.register
class MlaDecodeCuda(_AttnDecodeCuda):
    kind = "mla_decode"


@registry.register
class MlaDecodeTorch(_AttnDecodeTorch):
    kind = "mla_decode"


def attn_kind_of(cache) -> str:
    """``mla_decode`` for a latent-only cache, else ``attn_decode``."""
    return "mla_decode" if cache.v_width is not None else "attn_decode"


def _layout_of(cache) -> str:
    """The container type selects the op layout: a ``PagedKVCache``
    dispatches the block-table-native ops, a dense ``KVCache`` the dense
    ones."""
    return "paged" if isinstance(cache, PagedKVCache) else "dense"


def _cache_quant(cache, cfg: StateQuantConfig) -> StateQuantConfig:
    fmt = (cache.fmt if isinstance(cache, PagedKVCache)
           else fmt_of_state(cache.k))
    return StateQuantConfig(fmt=fmt, rounding=cfg.rounding,
                            backend=cfg.backend)


def _cache_dims(cache, n: int = 1) -> Dict[str, int]:
    """Plan dims of a cache; ``dv`` counts stored value lanes (0 for a
    latent-only MLA cache, whose output width is the plan's ``v_width``)."""
    if isinstance(cache, PagedKVCache):
        return dict(B=cache.batch, T=cache.max_len, KVH=cache.kv_heads,
                    dk=cache.dk, dv=0 if cache.v is None else cache.dv, n=n)
    B, T, KVH, dk = cache.k.shape
    dv = 0 if cache.v is None else cache.v.shape[-1]
    return dict(B=B, T=T, KVH=KVH, dk=dk, dv=dv, n=n)


def plan_attn_decode_dims(dims: Dict[str, int], cfg: StateQuantConfig, *,
                          kind: str = "attn_decode", scale=None,
                          v_width=None, layout: str = "dense",
                          strict: bool = False) -> OpPlan:
    """Plan a decode-attention invocation (``attn_decode`` or
    ``mla_decode``) from explicit dims (cost models)."""
    dims = dict(dims)
    dims.setdefault("H", dims["KVH"])
    return registry.plan(kind, dims, cfg, cfg.backend, layout=layout,
                         strict=strict, scale=scale, v_width=v_width)


def kv_append(cache, k_new: torch.Tensor, v_new: Optional[torch.Tensor],
              cfg: StateQuantConfig, seed: int = 0):
    """Append one (or n) token(s): k_new (B, n, KVH, dk); ``v_new`` None
    for a latent-only MLA cache.  In place."""
    p = registry.plan("kv_append", _cache_dims(cache, n=k_new.shape[1]),
                      _cache_quant(cache, cfg), cfg.backend,
                      layout=_layout_of(cache))
    new_cache, _ = registry.execute(cache, {"k": k_new, "v": v_new,
                                            "seed": seed}, p)
    return new_cache


def attn_decode(cache, q: torch.Tensor, cfg: StateQuantConfig,
                scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention of current-token queries q (B,H,dk) vs the cache."""
    dims = _cache_dims(cache)
    dims["H"] = q.shape[1]
    p = registry.plan(attn_kind_of(cache), dims, _cache_quant(cache, cfg),
                      cfg.backend, layout=_layout_of(cache), scale=scale,
                      v_width=cache.v_width)
    _, out = registry.execute(cache, {"q": q}, p)
    return out


def attention_decode_step(cache, k_new: torch.Tensor,
                          v_new: Optional[torch.Tensor], q: torch.Tensor,
                          cfg: StateQuantConfig, *,
                          scale: Optional[float] = None, seed: int = 0,
                          ) -> Tuple[torch.Tensor, Any]:
    """One decode step: append the token's K/V, then attend.  The cache
    container (``KVCache`` or ``PagedKVCache``) selects the layout."""
    cache = kv_append(cache, k_new, v_new, cfg, seed=seed)
    return attn_decode(cache, q, cfg, scale=scale), cache
