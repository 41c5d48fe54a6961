"""Block-table-native SPU ops: the ``layout="paged"`` registry entries
(PyTorch port of ``repro/ops/paged_ops.py``).

They consume the paged containers of :mod:`repro_torch.core.paged` -- the
serving pool's page / slab pools plus the step's block table -- in place:

``attn_decode`` / ``mla_decode``
                 ``cuda`` (mx8): the paged attention kernel (GQA or MLA
                 mode) walks ``bt[B, npg]`` straight out of the pool.
                 ``torch`` (every format): the reference -- gathers the
                 block table's pages inside the op and runs the dense plain
                 op, so paged logits equal the dense-gather path's by
                 construction.
``kv_append``    quantizes the new token's rows with the dense op's bits
                 (same shape and seeds ``seed`` / ``seed + 1``) and writes
                 them into their page slot: ``cuda`` (mx8), the fused
                 quantize-and-append kernel, one launch from the fp32 rows
                 to every payload pool (six for K and V, three for an MLA
                 latent stream); ``torch``, the eager quantize and a
                 one-slot indexed write.
``state_update`` the slab rows ``pool[slabs, group]``: the fused kernel in
                 slab mode (``cuda``, mx8, in place) or the dense plain op
                 on the gathered rows, written back (``torch``).

Traffic descriptors are page-granular and equal the JAX package's: whole
128-token pages stream (a partial tail page too), appends write one row,
state updates touch the owned slab rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.core import attention_cache as AC
from repro_torch.core import formats as F
from repro_torch.core.paged import (PAGE_TOKENS, PagedKVCache, PagedState,
                                    pages_for)
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.mx_paged_attention import (
    mx_paged_attention_decode as _paged_attn_cuda,
    mx_paged_kv_append_quant as _paged_append_quant_cuda)
from repro_torch.kernels.mx_state_update import mx_state_update as _su_cuda
from repro_torch.ops import registry
from repro_torch.ops.attention import _cache_row_vals
from repro_torch.ops.base import (OPERAND_BYTES, OUTPUT_BYTES, OpPlan, SpuOp,
                                  TrafficBytes)

_U32 = 0xFFFFFFFF
_ALL_FORMATS = ("mx8", "int8", "fp8_e4m3", "fp8_e5m2", "fp32", "bf16", "fp16")


def dense_view(cache: PagedKVCache) -> AC.KVCache:
    """The block table's dense ``KVCache`` at layer ``cache.group`` (the
    reference path's gather-in-op)."""
    v = (None if cache.v is None
         else _ref.gather_pages(cache.v, cache.bt, cache.group))
    return AC.KVCache(_ref.gather_pages(cache.k, cache.bt, cache.group), v,
                      cache.lengths, cache.fmt, cache.v_width)


# ---------------------------------------------------------------------------
# attn_decode / mla_decode
# ---------------------------------------------------------------------------

class _PagedAttnBase(SpuOp):
    layout = "paged"

    def traffic(self, plan: OpPlan) -> TrafficBytes:
        # page-granular: every touched page streams whole, once, read-only
        B, T, H = plan.dim("B"), plan.dim("T"), plan.dim("H")
        toks = pages_for(T) * PAGE_TOKENS
        cache = B * toks * _cache_row_vals(plan) * plan.bits_per_val / 8.0
        bt_bytes = B * pages_for(T) * 4.0               # the block table walk
        dv_out = plan.opt("v_width") or plan.dim("dv")
        return TrafficBytes(
            state_read=cache,
            operand_read=B * H * plan.dim("dk") * OPERAND_BYTES + bt_bytes,
            output_write=B * H * dv_out * OUTPUT_BYTES)


class _PagedAttnCuda(_PagedAttnBase):
    """Paged decode attention: the kernel walks the block table."""
    backend = "cuda"
    formats = ("mx8",)

    def execute(self, cache: PagedKVCache, inputs: Dict[str, Any],
                plan: OpPlan) -> Tuple[PagedKVCache, torch.Tensor]:
        return cache, _paged_attn_cuda(inputs["q"], cache.k, cache.v,
                                       cache.bt, cache.group, cache.lengths,
                                       scale=plan.opt("scale"),
                                       v_width=plan.opt("v_width"))


class _PagedAttnTorch(_PagedAttnBase):
    """Reference paged attention: gather-in-op + the dense plain op."""
    backend = "torch"
    formats = _ALL_FORMATS

    def execute(self, cache: PagedKVCache, inputs: Dict[str, Any],
                plan: OpPlan) -> Tuple[PagedKVCache, torch.Tensor]:
        dense_op = registry.get_op(plan.kind, "torch", plan.fmt, "dense")
        _, out = dense_op.execute(dense_view(cache), inputs, plan)
        return cache, out


@registry.register
class PagedAttnDecodeCuda(_PagedAttnCuda):
    kind = "attn_decode"


@registry.register
class PagedAttnDecodeTorch(_PagedAttnTorch):
    kind = "attn_decode"


@registry.register
class PagedMlaDecodeCuda(_PagedAttnCuda):
    kind = "mla_decode"


@registry.register
class PagedMlaDecodeTorch(_PagedAttnTorch):
    kind = "mla_decode"


# ---------------------------------------------------------------------------
# kv_append
# ---------------------------------------------------------------------------

class _PagedKVAppendBase(SpuOp):
    kind = "kv_append"
    layout = "paged"
    formats = _ALL_FORMATS

    def traffic(self, plan: OpPlan) -> TrafficBytes:
        # one page *slot* per row per new token -- never the whole cache
        B, n = plan.dim("B"), plan.dim("n")
        vals = B * n * _cache_row_vals(plan)
        bt_bytes = B * n * 4.0
        return TrafficBytes(state_write=vals * plan.bits_per_val / 8.0,
                            operand_read=vals * OPERAND_BYTES + bt_bytes)

    @staticmethod
    def _new_rows(inputs: Dict[str, Any]):
        """The new token's K and V rows (V None for an MLA latent stream)
        and the seed, after the one-token check."""
        k_new, v_new = inputs["k"], inputs.get("v")
        if k_new.shape[1] != 1:
            raise ValueError(f"the paged kv_append writes one token per "
                             f"step, got n={k_new.shape[1]}")
        return k_new, v_new, int(inputs.get("seed", 0)) & _U32


@registry.register
class PagedKVAppendCuda(_PagedKVAppendBase):
    """One fused launch quantizes the fp32 rows into every payload pool's
    slot (K seed ``seed``, V ``seed + 1``)."""
    backend = "cuda"
    formats = ("mx8",)

    def execute(self, cache: PagedKVCache, inputs: Dict[str, Any],
                plan: OpPlan) -> Tuple[PagedKVCache, None]:
        k_new, v_new, seed = self._new_rows(inputs)
        streams, pools = [k_new.to(torch.float32)], [cache.k]
        if v_new is not None:           # an MLA latent stream has no V
            streams.append(v_new.to(torch.float32))
            pools.append(cache.v)
        _paged_append_quant_cuda(streams, pools, cache.bt, cache.group,
                                 cache.lengths, seed, rounding=plan.rounding)
        return dataclasses.replace(cache, lengths=cache.lengths + 1), None


@registry.register
class PagedKVAppendTorch(_PagedKVAppendBase):
    """The eager quantize, then a one-slot indexed write into the page that
    owns position ``lengths``."""
    backend = "torch"

    @staticmethod
    def _quant_rows(cache: PagedKVCache, new: torch.Tensor, plan: OpPlan,
                    seed: int) -> Tuple[torch.Tensor, ...]:
        """(B, 1, KVH, d) -> payload rows ((B, KVH, w), ...), sorted by
        field, bit-identical to what the dense append stores for the same
        (shape, seed)."""
        if not isinstance(cache.k, F.QuantizedTensor):
            return (new[:, 0],)
        bits = (F.sr_bits(new.shape, seed, device=new.device)
                if plan.rounding == "stochastic" else None)
        q = F.quantize(new, cache.fmt, plan.rounding, bits)
        return tuple(q.payload[f][:, 0] for f in sorted(q.payload))

    @staticmethod
    def _pools_of(stream) -> Tuple[torch.Tensor, ...]:
        if isinstance(stream, F.QuantizedTensor):
            return tuple(stream.payload[f] for f in sorted(stream.payload))
        return (stream,)

    def execute(self, cache: PagedKVCache, inputs: Dict[str, Any],
                plan: OpPlan) -> Tuple[PagedKVCache, None]:
        k_new, v_new, seed = self._new_rows(inputs)
        rows = self._quant_rows(cache, k_new, plan, seed)
        pools = self._pools_of(cache.k)
        if v_new is not None:           # an MLA latent stream has no V
            rows += self._quant_rows(cache, v_new, plan, (seed + 1) & _U32)
            pools += self._pools_of(cache.v)
        _ref.paged_kv_append_ref(pools, rows, cache.bt, cache.group,
                                 cache.lengths)
        return dataclasses.replace(cache, lengths=cache.lengths + 1), None


# ---------------------------------------------------------------------------
# state_update
# ---------------------------------------------------------------------------

class _PagedStateUpdateBase(SpuOp):
    kind = "state_update"
    layout = "paged"

    def traffic(self, plan: OpPlan) -> TrafficBytes:
        # identical bytes to the dense layout: the slabs are per-request, so
        # the op touches exactly the B owned rows (read + write in place)
        dense = registry.get_op("state_update", "torch", plan.fmt, "dense")
        return dense.traffic(plan)


@registry.register
class PagedStateUpdateCuda(_PagedStateUpdateBase):
    """The fused MX8 kernel in slab mode: the owned rows, in place."""
    backend = "cuda"
    formats = ("mx8",)

    def execute(self, state: PagedState, inputs: Dict[str, Any],
                plan: OpPlan) -> Tuple[PagedState, torch.Tensor]:
        _, y = _su_cuda(state.pool, inputs["d"], inputs["k"], inputs["v"],
                        inputs["q"], inputs.get("seed", 0),
                        rounding=plan.rounding, slabs=state.slabs,
                        group=state.group)
        return state, y


@registry.register
class PagedStateUpdateTorch(_PagedStateUpdateBase):
    """The dense plain op on the gathered slab rows, written back."""
    backend = "torch"
    formats = _ALL_FORMATS

    def execute(self, state: PagedState, inputs: Dict[str, Any],
                plan: OpPlan) -> Tuple[PagedState, torch.Tensor]:
        seed = int(inputs.get("seed", 0)) & _U32
        _, y = _ref.state_update_slab_ref(
            state.pool, state.slabs, state.group, inputs["d"], inputs["k"],
            inputs["v"], inputs["q"], rounding=plan.rounding, seed=seed)
        return state, y
