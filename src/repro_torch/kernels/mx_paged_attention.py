"""Paged MX8 decode attention and the in-place paged KV append: the wrappers
around ``csrc/mx_paged_attention.cu``.

``mx_paged_attention_decode`` replaces the TPU kernel
``repro/kernels/mx_paged_attention.py::mx_paged_attention_decode``: the
dense decode-attention kernel's split loop, with split ``s`` of row ``b``
(one block) read from page ``bt[b, s]`` of the shared pool at layer
``group``.  Bitwise equal to
:func:`repro_torch.kernels.mx_attention.mx_attention_decode` over the
gathered pages.

``mx_paged_kv_append`` replaces
``repro/kernels/mx_paged_attention.py::mx_paged_kv_append``: one launch
writes one token's quantized payload rows into their page slots of every
payload pool, in place.  ``mx_paged_kv_append_quant`` is that kernel
designed for the card, the one the ``cuda`` backend's paged ``kv_append``
launches: it takes the token's fp32 rows and one launch quantizes them
(MX8, the SR bits of ``sr_bits((B, 1, KVH, w), seed + i)`` for stream
``i``) straight into the slots -- byte for byte the eager quantize
followed by the copy.

MLA mode (``v_pool=None``, ``v_width``) is the dense MLA kernel's split
loop over the latent pages, split ``s`` of row ``b`` being half ``s % 2`` of
page ``bt[b, s // 2]`` (bitwise it over the gathered pages); a latent-only
append is one launch over the stream's three payload pools.

Each wrapper takes its plain version (:mod:`repro_torch.kernels.ref`) only
for tensors on the CPU; for CUDA tensors it launches the kernel of its mode
or raises.  ``launches`` counts GQA launches, ``mla_launches`` MLA ones
(for the fused append: one stream, an MLA latent).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from repro_torch.core import formats as F
from repro_torch.core.paged import PAGE_TOKENS
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.mx_attention import (_aligned, mla_checked,
                                              mla_scratch, split_checked,
                                              split_scratch)

SOURCE = "mx_paged_attention"
MAX_POOLS = 8
MAX_STREAMS = 2                         # K and V; an MLA latent is one

#: plain versions of the same functions (the oracles)
plain = _ref.mx_paged_attention_decode_ref
plain_append = _ref.paged_kv_append_ref
plain_append_quant = _ref.paged_kv_append_quant_ref

_ATTN_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
_MLA_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
_APPEND_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [
    ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_APPEND_QUANT_ARGTYPES = _APPEND_ARGTYPES[:-1] + [ctypes.c_uint32,
                                                  ctypes.c_int,
                                                  ctypes.c_void_p]


def _check_pool(qt: F.QuantizedTensor, name: str) -> tuple:
    if qt.fmt != "mx8":
        raise ValueError(f"{name} pool must be mx8, got {qt.fmt}")
    P, n_stack, tb, KVH, w = qt.payload["mantissa"].shape
    if tb != PAGE_TOKENS:
        raise ValueError(f"{name} pool pages hold {tb} tokens, expected "
                         f"{PAGE_TOKENS}")
    want = {"mantissa": ((P, n_stack, tb, KVH, w), torch.int8),
            "exponent": ((P, n_stack, tb, KVH, w // F.MX8_GROUP),
                         torch.uint8),
            "micro": ((P, n_stack, tb, KVH, w // F.MX8_GROUP), torch.uint8)}
    for f, (shape, dtype) in want.items():
        a = qt.payload[f]
        if tuple(a.shape) != shape or a.dtype != dtype or \
                not a.is_contiguous():
            raise ValueError(f"{name} {f}: {tuple(a.shape)} {a.dtype} "
                             f"(contiguous={a.is_contiguous()}), expected "
                             f"contiguous {shape} {dtype}")
    if qt.payload["mantissa"].data_ptr() % 16:
        raise ValueError(f"{name} mantissa must be 16-byte aligned")
    return P, n_stack, KVH, w


def _index(t: torch.Tensor, dev, name: str) -> torch.Tensor:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    return t.to(torch.int32).contiguous()


def mx_paged_attention_decode(q: torch.Tensor, k_pool: F.QuantizedTensor,
                              v_pool: Optional[F.QuantizedTensor],
                              bt: torch.Tensor, group: int,
                              lengths: torch.Tensor, *,
                              scale: Optional[float] = None,
                              v_width: Optional[int] = None) -> torch.Tensor:
    """Paged decode attention: q ``(B, H, dk)`` against pools
    ``(P, n_stack, 128, KVH, d)`` through the block table ``bt (B, npg)`` at
    layer ``group``, masked to ``pos < lengths``; returns ``(B, H, dv)``
    float32."""
    if q.device.type == "cpu":
        return plain(q, k_pool, v_pool, bt, group, lengths, scale, v_width)
    if q.device.type != "cuda":
        raise ValueError(f"mx_paged_attention_decode: unsupported device "
                         f"{q.device}")
    if v_pool is None:
        return _mla_paged(q, k_pool, bt, group, lengths, scale, v_width)
    B, H, dk = q.shape
    _, n_stack, KVH, wk = _check_pool(k_pool, "K")
    P, n_stack_v, KVH_v, dv = _check_pool(v_pool, "V")
    if (n_stack_v, KVH_v) != (n_stack, KVH) or wk != dk or H % KVH:
        raise ValueError(f"pools K {k_pool.payload['mantissa'].shape} / V "
                         f"{v_pool.payload['mantissa'].shape} do not fit q "
                         f"{tuple(q.shape)}")
    G = H // KVH
    split_checked(G, G, dk, dv, "mx_paged_attention_decode")
    if not 0 <= int(group) < n_stack:
        raise ValueError(f"group {group} outside the pool's {n_stack}")
    for name, t in (("K", k_pool.payload["mantissa"]),
                    ("V", v_pool.payload["mantissa"])):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    bt_ = _index(bt, q.device, "bt")
    lens = _index(lengths, q.device, "lengths")
    if bt_.dim() != 2 or bt_.shape[0] != B or lens.shape != (B,):
        raise ValueError(f"bt {tuple(bt.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not fit batch {B}")
    scale = scale if scale is not None else dk ** -0.5
    qg = _aligned(q)                           # the kernel applies scale
    out = torch.empty((B, H, dv), dtype=torch.float32, device=q.device)
    npg = int(bt_.shape[1])
    ws, counters = split_scratch(B, KVH, npg, G, G, dv, q.device)
    fn = _build.entry(SOURCE, "mx_paged_attention_decode_launch",
                      _ATTN_ARGTYPES)
    kp, vp = k_pool.payload, v_pool.payload
    err = fn(qg.data_ptr(), kp["mantissa"].data_ptr(),
             kp["exponent"].data_ptr(), kp["micro"].data_ptr(),
             vp["mantissa"].data_ptr(), vp["exponent"].data_ptr(),
             vp["micro"].data_ptr(), bt_.data_ptr(), lens.data_ptr(),
             out.data_ptr(), ws.data_ptr(), counters.data_ptr(), B, npg,
             n_stack, int(group), KVH, G, dk, dv, scale, ws.numel(),
             counters.numel(),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mx_paged_attention_decode")
    mx_paged_attention_decode.launches += 1
    return out


def _mla_paged(q: torch.Tensor, k_pool: F.QuantizedTensor, bt: torch.Tensor,
               group: int, lengths: torch.Tensor, scale: Optional[float],
               v_width: Optional[int]) -> torch.Tensor:
    B, H, dk = q.shape
    _, n_stack, KVH, wk = _check_pool(k_pool, "latent")
    if wk != dk or H % KVH:
        raise ValueError(f"latent pool {k_pool.payload['mantissa'].shape} "
                         f"does not fit q {tuple(q.shape)}")
    dv = mla_checked(dk, v_width, "mx_paged_attention_decode")
    if not 0 <= int(group) < n_stack:
        raise ValueError(f"group {group} outside the pool's {n_stack}")
    if k_pool.payload["mantissa"].device != q.device:
        raise ValueError(f"latent pool is on "
                         f"{k_pool.payload['mantissa'].device}, q on "
                         f"{q.device}")
    bt_ = _index(bt, q.device, "bt")
    lens = _index(lengths, q.device, "lengths")
    if bt_.dim() != 2 or bt_.shape[0] != B or lens.shape != (B,):
        raise ValueError(f"bt {tuple(bt.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not fit batch {B}")
    scale = scale if scale is not None else dk ** -0.5
    qg = (q.to(torch.float32) * scale).contiguous()
    out = torch.empty((B, H, dv), dtype=torch.float32, device=q.device)
    npg, G = int(bt_.shape[1]), H // KVH
    ws, counters = mla_scratch(B, KVH, npg * PAGE_TOKENS, G, dv, q.device)
    fn = _build.entry(SOURCE, "mx_paged_attention_decode_mla_launch",
                      _MLA_ARGTYPES)
    kp = k_pool.payload
    err = fn(qg.data_ptr(), kp["mantissa"].data_ptr(),
             kp["exponent"].data_ptr(), kp["micro"].data_ptr(),
             bt_.data_ptr(), lens.data_ptr(), out.data_ptr(), ws.data_ptr(),
             counters.data_ptr(), B, npg, n_stack, int(group), KVH, G, dk,
             dv, ws.numel(), counters.numel(),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mx_paged_attention_decode (MLA)")
    mx_paged_attention_decode.mla_launches += 1
    return out


def mx_paged_kv_append(pools: Sequence[torch.Tensor],
                       rows: Sequence[torch.Tensor], bt: torch.Tensor,
                       group: int, lengths: torch.Tensor
                       ) -> Sequence[torch.Tensor]:
    """Write each ``rows[i] (B, KVH, w)`` into its page slot
    ``pools[i][bt[b, len//128], group, len%128]`` of the byte pools
    ``(P, n_stack, 128, KVH, w)``, in place; returns the pools.

    A slot outside its block table (``len // 128 >= npg``, or a page id
    outside the pool) is a fault: the plain version raises ``IndexError``;
    the kernel fails a device-side assert, which the next synchronizing
    call raises (and which leaves the CUDA context unusable)."""
    pools, rows = list(pools), list(rows)
    if not pools or len(pools) != len(rows) or len(pools) > MAX_POOLS:
        raise ValueError(f"{len(pools)} pools / {len(rows)} rows: expected "
                         f"1..{MAX_POOLS} of each, paired")
    dev = pools[0].device
    if dev.type == "cpu":
        return plain_append(pools, rows, bt, group, lengths)
    if dev.type != "cuda":
        raise ValueError(f"mx_paged_kv_append: unsupported device {dev}")
    P, n_stack, tb, KVH, _ = pools[0].shape
    B = bt.shape[0]
    rows_ = []
    for i, (pool, row) in enumerate(zip(pools, rows)):
        w = pool.shape[-1]
        if (pool.dim() != 5 or tuple(pool.shape[:4]) != (P, n_stack, tb, KVH)
                or tb != PAGE_TOKENS or pool.element_size() != 1
                or not pool.is_contiguous() or pool.device != dev):
            raise ValueError(f"pool {i}: {tuple(pool.shape)} {pool.dtype} "
                             f"on {pool.device}, expected contiguous 1-byte "
                             f"({P}, {n_stack}, {PAGE_TOKENS}, {KVH}, w) on "
                             f"{dev}")
        if tuple(row.shape) != (B, KVH, w) or row.device != dev:
            raise ValueError(f"row {i}: {tuple(row.shape)} on {row.device}, "
                             f"expected ({B}, {KVH}, {w}) on {dev}")
        rows_.append(row.to(pool.dtype).contiguous())
    if not 0 <= int(group) < n_stack:
        raise ValueError(f"group {group} outside the pool's {n_stack}")
    bt_ = _index(bt, dev, "bt")
    lens = _index(lengths, dev, "lengths")
    n = len(pools)
    ptrs = (ctypes.c_ulonglong * n)(*[p.data_ptr() for p in pools])
    rptrs = (ctypes.c_ulonglong * n)(*[r.data_ptr() for r in rows_])
    widths = (ctypes.c_int * n)(*[int(p.shape[-1]) for p in pools])
    fn = _build.entry(SOURCE, "mx_paged_kv_append_launch", _APPEND_ARGTYPES)
    err = fn(ptrs, rptrs, widths, n, bt_.data_ptr(), lens.data_ptr(), B,
             int(bt_.shape[1]), P, n_stack, int(group), KVH,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mx_paged_kv_append")
    mx_paged_kv_append.launches += 1
    return pools


def mx_paged_kv_append_quant(streams: Sequence[torch.Tensor],
                             pools: Sequence[F.QuantizedTensor],
                             bt: torch.Tensor, group: int,
                             lengths: torch.Tensor, seed: int = 0, *,
                             rounding: str = "stochastic"
                             ) -> Sequence[F.QuantizedTensor]:
    """Quantize each new token's fp32 row ``streams[i] (B, 1, KVH, w)`` to
    MX8 (SR seed ``seed + i``) into its page slot
    ``pools[i][bt[b, len//128], group, len%128]`` of the MX8 page pool
    ``(P, n_stack, 128, KVH, w)``, in place; returns the pools.  K and V
    are two streams, an MLA latent one.  A slot outside its block table is
    a fault, as for :func:`mx_paged_kv_append`."""
    streams, pools = list(streams), list(pools)
    if not streams or len(streams) != len(pools) or \
            len(streams) > MAX_STREAMS:
        raise ValueError(f"{len(streams)} streams / {len(pools)} pools: "
                         f"expected 1..{MAX_STREAMS} of each, paired")
    if rounding not in F.ROUNDINGS:
        raise ValueError(f"unknown rounding {rounding!r}")
    dev = streams[0].device
    B = bt.shape[0]
    first = None
    for i, (x, pool) in enumerate(zip(streams, pools)):
        if x.dtype != torch.float32:
            raise TypeError(f"stream {i} must be float32, got {x.dtype}")
        if not isinstance(pool, F.QuantizedTensor):
            raise ValueError(f"pool {i} must be an mx8 QuantizedTensor, "
                             f"got {type(pool).__name__}")
        P, n_stack, KVH, w = _check_pool(pool, f"stream {i}")
        first = first or (P, n_stack, KVH)
        if (P, n_stack, KVH) != first or tuple(x.shape) != (B, 1, KVH, w) \
                or x.device != dev or pool.device != dev:
            raise ValueError(f"stream {i} {tuple(x.shape)} on {x.device} "
                             f"does not fit its pool "
                             f"{tuple(pool.payload['mantissa'].shape)} on "
                             f"{pool.device} (want ({B}, 1, {KVH}, {w}) on "
                             f"{dev}, pools alike)")
    if not 0 <= int(group) < n_stack:
        raise ValueError(f"group {group} outside the pool's {n_stack}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths {tuple(lengths.shape)} do not fit batch "
                         f"{B}")
    seed = int(seed) & 0xFFFFFFFF
    if dev.type == "cpu":
        return plain_append_quant(streams, pools, bt, group, lengths, seed,
                                  rounding)
    if dev.type != "cuda":
        raise ValueError(f"mx_paged_kv_append_quant: unsupported device "
                         f"{dev}")
    bt_ = _index(bt, dev, "bt")
    lens = _index(lengths, dev, "lengths")
    xs = []
    for x in streams:
        xc = x.contiguous()
        xs.append(xc.clone() if xc.data_ptr() % 16 else xc)  # float4 loads
    n = len(streams)
    xptrs = (ctypes.c_ulonglong * n)(*[x.data_ptr() for x in xs])
    pptrs = (ctypes.c_ulonglong * (3 * n))(*[
        p.payload[f].data_ptr() for p in pools
        for f in ("mantissa", "exponent", "micro")])
    widths = (ctypes.c_int * n)(*[int(x.shape[-1]) for x in xs])
    fn = _build.entry(SOURCE, "mx_paged_kv_append_quant_launch",
                      _APPEND_QUANT_ARGTYPES)
    err = fn(xptrs, pptrs, widths, n, bt_.data_ptr(), lens.data_ptr(), B,
             int(bt_.shape[1]), P, n_stack, int(group), KVH, seed,
             int(rounding == "stochastic"),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mx_paged_kv_append_quant")
    if n == 1:
        mx_paged_kv_append_quant.mla_launches += 1
    else:
        mx_paged_kv_append_quant.launches += 1
    return pools


#: launches of the CUDA kernels since the counts were last reset
mx_paged_attention_decode.launches = 0
mx_paged_attention_decode.mla_launches = 0
mx_paged_kv_append.launches = 0
mx_paged_kv_append_quant.launches = 0
mx_paged_kv_append_quant.mla_launches = 0
