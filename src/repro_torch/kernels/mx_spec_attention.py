"""Speculative-verify MX8 attention, dense and paged: the wrappers around
``csrc/mx_spec_attention.cu``.

``mx_spec_attention_decode`` replaces the TPU kernel
``repro/kernels/mx_spec_attention.py::mx_spec_attention_decode`` and
``mx_paged_spec_attention_decode`` its paged twin of the same file (GQA
mode).  A verify pass scores ``Kq = spec_k + 1`` query positions against a
cache whose lengths already count the ``Kq`` appended rows; position ``j``
sees ``pos < lengths - (Kq - 1 - j)``.  The kernels fold the ``Kq``
positions into the query rows of the decode kernels' split loop
(``csrc/mx_attention_split.cuh``: one block per 128-position split, the
splits combined in order in the same launch), so each block streams its
cache positions once for all query positions -- the bytes of one decode
step, amortised over the drafted tokens.  Row ``j`` is bitwise the
decode kernel at the shifted length, ``Kq = 1`` is bitwise the decode
kernel, and the paged kernel is bitwise the dense one over the gathered
pages.

Rows: the ``Kq * G`` query rows of a kv head go to row blocks of at most
16 rows and 2048 accumulator items, whole verify positions where they fit
(:func:`~repro_torch.kernels.mx_attention.split_block_rows`; yi-9b's
``Kq = 4``, ``G = 8``, ``dv = 128``: two blocks of two positions), one
block per row block and split, as the TPU kernel takes all ``Kq * G`` rows
at any count.  The wrappers refuse (``ValueError``, never a fallback) only
what a block cannot hold: ``dv > 2048``, or a row block's shared memory
past 226 KB.  MLA mode (``qV`` / ``v_pool`` ``None``,
``v_width``) folds the ``Kq`` positions into the query rows of
``csrc/mx_mla_tile.cuh``'s split loop the same way, with no row limit
(``Kq = 4`` x 128 heads = 512 rows, 32 blocks of 16 per 64-position split
at deepseek-v2-236b's widths); row ``j`` is bitwise the MLA decode kernel
at the shifted length.  Each wrapper takes its plain
version (:mod:`repro_torch.kernels.ref`) only for tensors on the CPU; for
CUDA tensors it launches the kernel of its mode or raises.  ``launches``
counts GQA launches, ``mla_launches`` MLA ones.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import formats as F
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.core.paged import PAGE_TOKENS
from repro_torch.kernels.mx_attention import (SPLIT, T_BLOCK, _aligned,
                                              _check_stream, mla_checked,
                                              mla_scratch, split_checked,
                                              split_scratch)
from repro_torch.kernels.mx_paged_attention import _check_pool, _index

SOURCE = "mx_spec_attention"

#: plain versions of the same functions (the oracles)
plain = _ref.mx_spec_attention_decode_ref
plain_paged = _ref.mx_paged_spec_attention_decode_ref

_DENSE_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
_PAGED_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
_MLA_DENSE_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
_MLA_PAGED_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def _gqa_rows(q: torch.Tensor, KVH: int, dv: int, name: str) -> int:
    """G after checking that a row block of the GQA kernels holds the
    shape (``ValueError`` where it does not, never a fallback)."""
    B, Kq, H, dk = q.shape
    if H % KVH:
        raise ValueError(f"H={H} must divide by KVH={KVH}")
    G = H // KVH
    split_checked(Kq * G, G, dk, dv, name)
    return G


def _fold(q: torch.Tensor, KVH: int, scale: Optional[float]
          ) -> torch.Tensor:
    """MLA mode: (B, Kq, H, dk) -> pre-scaled (B, KVH, Kq*G, dk),
    query-major rows (the TPU kernel's ``_fold_queries``; the GQA kernels
    fold and scale in the kernel)."""
    B, Kq, H, dk = q.shape
    if H % KVH:
        raise ValueError(f"H={H} must divide by KVH={KVH}")
    G = H // KVH
    scale = scale if scale is not None else dk ** -0.5
    qg = (q.to(torch.float32) * scale).reshape(B, Kq, KVH, G, dk)
    return qg.permute(0, 2, 1, 3, 4).contiguous()


def _unfold(y: torch.Tensor) -> torch.Tensor:
    """(B, KVH, Kq, G, dv) -> (B, Kq, H, dv)."""
    B, KVH, Kq, G, dv = y.shape
    return y.permute(0, 2, 1, 3, 4).reshape(B, Kq, KVH * G, dv)


def _device_checked(q: torch.Tensor, name: str) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be (B, Kq, H, dk), got "
                         f"{tuple(q.shape)}")


def mx_spec_attention_decode(q: torch.Tensor, qK: F.QuantizedTensor,
                             qV: Optional[F.QuantizedTensor],
                             lengths: torch.Tensor, *,
                             scale: Optional[float] = None,
                             v_width: Optional[int] = None) -> torch.Tensor:
    """Dense verify attention: q ``(B, Kq, H, dk)`` against K/V
    ``(B, T, KVH, d)``, position ``j`` masked to
    ``pos < lengths - (Kq - 1 - j)``; returns ``(B, Kq, H, dv)`` float32."""
    if q.device.type == "cpu":
        return plain(q, qK, qV, lengths, scale, v_width)
    _device_checked(q, "mx_spec_attention_decode")
    if qV is None:
        return _mla_dense(q, qK, lengths, scale, v_width)
    B, Kq, H, dk = q.shape
    _, T, KVH, _ = qK.shape
    if T % T_BLOCK:
        raise ValueError(f"T={T} must be a multiple of {T_BLOCK}")
    if _check_stream(qK, B, T, KVH, "K") != dk:
        raise ValueError(f"key width {qK.shape[-1]} != query width {dk}")
    dv = _check_stream(qV, B, T, KVH, "V")
    G = _gqa_rows(q, KVH, dv, "mx_spec_attention_decode")
    for name, t in (("K", qK.payload["mantissa"]),
                    ("V", qV.payload["mantissa"]), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    lens = lengths.to(torch.int32).contiguous()
    if lens.shape != (B,):
        raise ValueError(f"lengths {tuple(lengths.shape)} for batch {B}")
    scale = scale if scale is not None else dk ** -0.5
    qg = _aligned(q)                        # the kernel folds and scales
    out = torch.empty((B, Kq, H, dv), dtype=torch.float32, device=q.device)
    ws, counters = split_scratch(B, KVH, T // SPLIT, Kq * G, G, dv,
                                 q.device)
    fn = _build.entry(SOURCE, "mx_spec_attention_decode_launch",
                      _DENSE_ARGTYPES)
    kp, vp = qK.payload, qV.payload
    err = fn(qg.data_ptr(), kp["mantissa"].data_ptr(),
             kp["exponent"].data_ptr(), kp["micro"].data_ptr(),
             vp["mantissa"].data_ptr(), vp["exponent"].data_ptr(),
             vp["micro"].data_ptr(), lens.data_ptr(), out.data_ptr(),
             ws.data_ptr(), counters.data_ptr(), B, T, KVH, G, Kq, dk, dv,
             scale, ws.numel(), counters.numel(),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mx_spec_attention_decode")
    mx_spec_attention_decode.launches += 1
    return out


def mx_paged_spec_attention_decode(q: torch.Tensor, k_pool: F.QuantizedTensor,
                                   v_pool: Optional[F.QuantizedTensor],
                                   bt: torch.Tensor, group: int,
                                   lengths: torch.Tensor, *,
                                   scale: Optional[float] = None,
                                   v_width: Optional[int] = None
                                   ) -> torch.Tensor:
    """Paged verify attention: q ``(B, Kq, H, dk)`` against pools
    ``(P, n_stack, 128, KVH, d)`` through ``bt (B, npg)`` at layer
    ``group``; returns ``(B, Kq, H, dv)`` float32.  The table must span
    ``lengths`` (the kernel walks ``ceil(len / 128)`` of its pages)."""
    if q.device.type == "cpu":
        return plain_paged(q, k_pool, v_pool, bt, group, lengths, scale,
                           v_width)
    _device_checked(q, "mx_paged_spec_attention_decode")
    if v_pool is None:
        return _mla_paged(q, k_pool, bt, group, lengths, scale, v_width)
    B, Kq, H, dk = q.shape
    _, n_stack, KVH, wk = _check_pool(k_pool, "K")
    _, n_stack_v, KVH_v, dv = _check_pool(v_pool, "V")
    if (n_stack_v, KVH_v) != (n_stack, KVH) or wk != dk:
        raise ValueError(f"pools K {k_pool.payload['mantissa'].shape} / V "
                         f"{v_pool.payload['mantissa'].shape} do not fit q "
                         f"{tuple(q.shape)}")
    G = _gqa_rows(q, KVH, dv, "mx_paged_spec_attention_decode")
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
    qg = _aligned(q)                        # the kernel folds and scales
    out = torch.empty((B, Kq, H, dv), dtype=torch.float32, device=q.device)
    npg = int(bt_.shape[1])
    ws, counters = split_scratch(B, KVH, npg, Kq * G, G, dv, q.device)
    fn = _build.entry(SOURCE, "mx_paged_spec_attention_decode_launch",
                      _PAGED_ARGTYPES)
    kp, vp = k_pool.payload, v_pool.payload
    err = fn(qg.data_ptr(), kp["mantissa"].data_ptr(),
             kp["exponent"].data_ptr(), kp["micro"].data_ptr(),
             vp["mantissa"].data_ptr(), vp["exponent"].data_ptr(),
             vp["micro"].data_ptr(), bt_.data_ptr(), lens.data_ptr(),
             out.data_ptr(), ws.data_ptr(), counters.data_ptr(), B, npg,
             n_stack, int(group), KVH, G, Kq, dk, dv, scale, ws.numel(),
             counters.numel(),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mx_paged_spec_attention_decode")
    mx_paged_spec_attention_decode.launches += 1
    return out


def _mla_dense(q: torch.Tensor, qK: F.QuantizedTensor, lengths: torch.Tensor,
               scale: Optional[float], v_width: Optional[int]
               ) -> torch.Tensor:
    B, Kq, H, dk = q.shape
    _, T, KVH, _ = qK.shape
    if T % T_BLOCK:
        raise ValueError(f"T={T} must be a multiple of {T_BLOCK}")
    if _check_stream(qK, B, T, KVH, "latent") != dk:
        raise ValueError(f"latent width {qK.shape[-1]} != query width {dk}")
    dv = mla_checked(dk, v_width, "mx_spec_attention_decode")
    qg = _fold(q, KVH, scale)
    for name, t in (("latent", qK.payload["mantissa"]), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    lens = lengths.to(torch.int32).contiguous()
    if lens.shape != (B,):
        raise ValueError(f"lengths {tuple(lengths.shape)} for batch {B}")
    G = H // KVH
    out = torch.empty((B, KVH, Kq, G, dv), dtype=torch.float32,
                      device=q.device)
    ws, counters = mla_scratch(B, KVH, T, Kq * G, dv, q.device)
    fn = _build.entry(SOURCE, "mx_spec_attention_decode_mla_launch",
                      _MLA_DENSE_ARGTYPES)
    kp = qK.payload
    err = fn(qg.data_ptr(), kp["mantissa"].data_ptr(),
             kp["exponent"].data_ptr(), kp["micro"].data_ptr(),
             lens.data_ptr(), out.data_ptr(), ws.data_ptr(),
             counters.data_ptr(), B, T, KVH, G, Kq, dk, dv, ws.numel(),
             counters.numel(), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mx_spec_attention_decode (MLA)")
    mx_spec_attention_decode.mla_launches += 1
    return _unfold(out)


def _mla_paged(q: torch.Tensor, k_pool: F.QuantizedTensor, bt: torch.Tensor,
               group: int, lengths: torch.Tensor, scale: Optional[float],
               v_width: Optional[int]) -> torch.Tensor:
    B, Kq, H, dk = q.shape
    _, n_stack, KVH, wk = _check_pool(k_pool, "latent")
    if wk != dk:
        raise ValueError(f"latent pool {k_pool.payload['mantissa'].shape} "
                         f"does not fit q {tuple(q.shape)}")
    dv = mla_checked(dk, v_width, "mx_paged_spec_attention_decode")
    qg = _fold(q, KVH, scale)
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
    G = H // KVH
    out = torch.empty((B, KVH, Kq, G, dv), dtype=torch.float32,
                      device=q.device)
    npg = int(bt_.shape[1])
    ws, counters = mla_scratch(B, KVH, npg * PAGE_TOKENS, Kq * G, dv,
                               q.device)
    fn = _build.entry(SOURCE, "mx_paged_spec_attention_decode_mla_launch",
                      _MLA_PAGED_ARGTYPES)
    kp = k_pool.payload
    err = fn(qg.data_ptr(), kp["mantissa"].data_ptr(),
             kp["exponent"].data_ptr(), kp["micro"].data_ptr(),
             bt_.data_ptr(), lens.data_ptr(), out.data_ptr(), ws.data_ptr(),
             counters.data_ptr(), B, npg, n_stack, int(group), KVH, G, Kq,
             dk, dv, ws.numel(), counters.numel(),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mx_paged_spec_attention_decode (MLA)")
    mx_paged_spec_attention_decode.mla_launches += 1
    return _unfold(out)


#: launches of the CUDA kernels (GQA, MLA) since the counts were last reset
mx_spec_attention_decode.launches = 0
mx_spec_attention_decode.mla_launches = 0
mx_paged_spec_attention_decode.launches = 0
mx_paged_spec_attention_decode.mla_launches = 0
