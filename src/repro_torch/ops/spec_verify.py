"""Speculative-verify attention as a registered SpuOp (``spec_verify``),
PyTorch port of ``repro/ops/spec_verify.py``.

One verify pass scores ``Kq`` query positions (the current token plus the
drafted ones) against a cache that already holds their appended K/V rows.
With ``lengths`` counting the ``Kq`` appended rows,

    position j sees  pos < lengths - (Kq - 1 - j)

so row ``j``'s output is bitwise the single-query ``attn_decode`` of the
j-th sequential decode step (``Kq = 1`` is ``attn_decode``).  The whole
cache streams once for all ``Kq`` positions, so ``traffic(plan)`` reports
one cache stream plus ``Kq``-scaled operand and output bytes -- the JAX
package's descriptors, byte for byte.

Backends, as for the decode-attention ops:

``cuda`` (mx8, dense + paged)
    :mod:`repro_torch.kernels.mx_spec_attention`: the decode kernels' tile
    loop with the ``Kq`` positions folded into the query rows; the paged
    kernel walks the block table, pages streaming once for all queries.
``torch`` (every format, dense + paged)
    The reference: one plain decode attention per position at the shifted
    length, stacked; the paged op gathers the block table's pages in-op.

Entry points: :func:`spec_attend` (plan + dispatch one verify) and
:func:`attention_spec_step` (append the ``n`` new K/V rows with the seeds of
``n`` sequential ``kv_append`` calls, then verify).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import attention_cache as AC
from repro_torch.core.paged import PAGE_TOKENS, PagedKVCache, pages_for
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.mx_spec_attention import (
    mx_paged_spec_attention_decode as _paged_spec_cuda,
    mx_spec_attention_decode as _spec_cuda)
from repro_torch.ops import registry
from repro_torch.ops.attention import (_cache_dims, _cache_quant,
                                       _cache_row_vals, _layout_of,
                                       dequantized, kv_append)
from repro_torch.ops.base import (OPERAND_BYTES, OUTPUT_BYTES, OpPlan, SpuOp,
                                  StateQuantConfig, TrafficBytes)
from repro_torch.ops.paged_ops import _ALL_FORMATS, dense_view

_U32 = 0xFFFFFFFF


class _SpecVerifyBase(SpuOp):
    kind = "spec_verify"

    def traffic(self, plan: OpPlan) -> TrafficBytes:
        # the whole valid cache streams ONCE for all Kq positions; only
        # operands and outputs scale by Kq
        B, T, H, Kq = (plan.dim("B"), plan.dim("T"), plan.dim("H"),
                       plan.dim("Kq"))
        cache = B * T * _cache_row_vals(plan) * plan.bits_per_val / 8.0
        dv_out = plan.opt("v_width") or plan.dim("dv")
        return TrafficBytes(
            state_read=cache,
            operand_read=B * Kq * H * plan.dim("dk") * OPERAND_BYTES,
            output_write=B * Kq * H * dv_out * OUTPUT_BYTES)


def _verify_torch(cache: AC.KVCache, q: torch.Tensor,
                  plan: OpPlan) -> torch.Tensor:
    """Reference semantics: per-position single-query attention at the
    shifted lengths, stacked ``(B, Kq, H, dv)`` (MLA: ``v_width`` lanes)."""
    kf, vf = dequantized(cache, plan.opt("v_width"))
    return _ref.spec_attention_decode_ref(q, kf, vf, cache.lengths,
                                          plan.opt("scale"))


@registry.register
class SpecVerifyCuda(_SpecVerifyBase):
    """Fused dense verify over the packed MX8 cache (GQA or MLA)."""
    backend = "cuda"
    formats = ("mx8",)

    def execute(self, cache: AC.KVCache, inputs: Dict[str, Any],
                plan: OpPlan) -> Tuple[AC.KVCache, torch.Tensor]:
        return cache, _spec_cuda(inputs["q"], cache.k, cache.v, cache.lengths,
                                 scale=plan.opt("scale"),
                                 v_width=plan.opt("v_width"))


@registry.register
class SpecVerifyTorch(_SpecVerifyBase):
    """Plain verify for every storage format."""
    backend = "torch"
    formats = _ALL_FORMATS

    def execute(self, cache: AC.KVCache, inputs: Dict[str, Any],
                plan: OpPlan) -> Tuple[AC.KVCache, torch.Tensor]:
        return cache, _verify_torch(cache, inputs["q"], plan)


class _PagedSpecVerifyBase(SpuOp):
    kind = "spec_verify"
    layout = "paged"

    def traffic(self, plan: OpPlan) -> TrafficBytes:
        # page-granular single stream: every touched page streams whole,
        # once, for all Kq queries
        B, T, H, Kq = (plan.dim("B"), plan.dim("T"), plan.dim("H"),
                       plan.dim("Kq"))
        toks = pages_for(T) * PAGE_TOKENS
        cache = B * toks * _cache_row_vals(plan) * plan.bits_per_val / 8.0
        dv_out = plan.opt("v_width") or plan.dim("dv")
        bt_bytes = B * pages_for(T) * 4.0              # the block table walk
        return TrafficBytes(
            state_read=cache,
            operand_read=B * Kq * H * plan.dim("dk") * OPERAND_BYTES
            + bt_bytes,
            output_write=B * Kq * H * dv_out * OUTPUT_BYTES)


@registry.register
class PagedSpecVerifyCuda(_PagedSpecVerifyBase):
    """Fused paged verify: the kernel walks the block table."""
    backend = "cuda"
    formats = ("mx8",)

    def execute(self, cache: PagedKVCache, inputs: Dict[str, Any],
                plan: OpPlan) -> Tuple[PagedKVCache, torch.Tensor]:
        return cache, _paged_spec_cuda(inputs["q"], cache.k, cache.v,
                                       cache.bt, cache.group, cache.lengths,
                                       scale=plan.opt("scale"),
                                       v_width=plan.opt("v_width"))


@registry.register
class PagedSpecVerifyTorch(_PagedSpecVerifyBase):
    """Reference paged verify: gather-in-op + the dense reference."""
    backend = "torch"
    formats = _ALL_FORMATS

    def execute(self, cache: PagedKVCache, inputs: Dict[str, Any],
                plan: OpPlan) -> Tuple[PagedKVCache, torch.Tensor]:
        return cache, _verify_torch(dense_view(cache), inputs["q"], plan)


# ---------------------------------------------------------------------------
# call-site entry points
# ---------------------------------------------------------------------------

def spec_attend(cache, q: torch.Tensor, cfg: StateQuantConfig,
                scale: Optional[float] = None) -> torch.Tensor:
    """Verify-attention of q ``(B, Kq, H, dk)`` against a cache whose
    lengths already count the ``Kq`` appended rows; returns
    ``(B, Kq, H, dv)`` f32."""
    dims = _cache_dims(cache)
    dims["H"] = q.shape[2]
    dims["Kq"] = q.shape[1]
    p = registry.plan("spec_verify", dims, _cache_quant(cache, cfg),
                      cfg.backend, layout=_layout_of(cache), scale=scale,
                      v_width=cache.v_width)
    _, out = registry.execute(cache, {"q": q}, p)
    return out


def attention_spec_step(cache, k_new: torch.Tensor,
                        v_new: Optional[torch.Tensor],
                        q: torch.Tensor, cfg: StateQuantConfig, *,
                        scale: Optional[float] = None, seed: int = 0):
    """One speculative step: append the n new K/V rows, then verify.

    k_new/v_new are ``(B, n, KVH, d)`` (``v_new`` None for an MLA latent
    stream), q is ``(B, n, H, dk)``.  Rows append
    one at a time with seed ``seed + i`` (uint32), so position i quantizes
    with exactly the bits the i-th sequential decode step would have used
    -- the greedy-exactness guarantee rests on this.  In place on the
    card, as :func:`kv_append` is; returns ``(out, cache)``.
    """
    for i in range(k_new.shape[1]):
        cache = kv_append(cache, k_new[:, i:i + 1].contiguous(),
                          None if v_new is None
                          else v_new[:, i:i + 1].contiguous(), cfg,
                          seed=(int(seed) + i) & _U32)
    return spec_attend(cache, q, cfg, scale=scale), cache
