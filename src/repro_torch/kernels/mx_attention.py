"""Decode attention over a dense MX8 KV cache: the wrapper around
``csrc/mx_attention.cu``.

Replaces the TPU kernel ``repro/kernels/mx_attention.py::mx_attention_decode``
(GQA mode).  On an H100 one decode query per head is bound by bytes: each
valid cached K and V value is read once (9 stored bits) against ~4 flops
per query head.  The kernel streams only the valid 128-position tiles of
each row, one block per (row, kv head), with a flash-style fp32 softmax.

The wrapper takes the plain version (:mod:`repro_torch.kernels.ref`) only
for tensors on the CPU; for CUDA tensors it launches the kernel or raises.
MLA mode (``qV=None``) exists in the plain version only and raises on CUDA.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import formats as F
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

SOURCE = "mx_attention"
T_BLOCK = 128

#: plain version of the same function (the oracle)
plain = _ref.mx_attention_decode_ref

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _check_stream(qt: F.QuantizedTensor, B: int, T: int, KVH: int,
                  name: str) -> int:
    if qt.fmt != "mx8":
        raise ValueError(f"{name} must be mx8, got {qt.fmt}")
    b, t, h, w = qt.shape
    if (b, t, h) != (B, T, KVH):
        raise ValueError(f"{name} shape {qt.shape} vs (B,T,KVH)={(B, T, KVH)}")
    want = {"mantissa": ((B, T, KVH, w), torch.int8),
            "exponent": ((B, T, KVH, w // F.MX8_GROUP), torch.uint8),
            "micro": ((B, T, KVH, w // F.MX8_GROUP), torch.uint8)}
    for f, (shape, dtype) in want.items():
        a = qt.payload[f]
        if tuple(a.shape) != shape or a.dtype != dtype or not a.is_contiguous():
            raise ValueError(f"{name} {f}: {tuple(a.shape)} {a.dtype} "
                             f"(contiguous={a.is_contiguous()}), expected "
                             f"contiguous {shape} {dtype}")
    if qt.payload["mantissa"].data_ptr() % 16:
        raise ValueError(f"{name} mantissa must be 16-byte aligned")
    return w


def mx_attention_decode(q: torch.Tensor, qK: F.QuantizedTensor,
                        qV: Optional[F.QuantizedTensor],
                        lengths: torch.Tensor, *,
                        scale: Optional[float] = None,
                        v_width: Optional[int] = None) -> torch.Tensor:
    """Fused decode attention: q ``(B, H, dk)`` against K/V ``(B, T, KVH, d)``
    masked to ``pos < lengths``; returns ``(B, H, dv)`` float32."""
    if q.device.type == "cpu":
        return plain(q, qK, qV, lengths, scale, v_width)
    if q.device.type != "cuda":
        raise ValueError(f"mx_attention_decode: unsupported device {q.device}")
    if qV is None:
        raise NotImplementedError(
            "MLA mode (qV=None) of mx_attention_decode has no CUDA kernel "
            "yet (ROADMAP.md, TPU kernels to port); its plain version runs "
            "on the CPU only")
    B, H, dk = q.shape
    _, T, KVH, _ = qK.shape
    if H % KVH or T % T_BLOCK:
        raise ValueError(f"H={H} must divide by KVH={KVH}; T={T} must be a "
                         f"multiple of {T_BLOCK}")
    G = H // KVH
    if _check_stream(qK, B, T, KVH, "K") != dk:
        raise ValueError(f"key width {qK.shape[-1]} != query width {dk}")
    dv = _check_stream(qV, B, T, KVH, "V")
    if G > 16 or G * dv > 2048:
        raise ValueError(f"G={G}, dv={dv}: the kernel takes G <= 16 and "
                         f"G*dv <= 2048")
    for name, t in (("K", qK.payload["mantissa"]),
                    ("V", qV.payload["mantissa"]), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    scale = scale if scale is not None else dk ** -0.5
    qg = (q.to(torch.float32) * scale).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty((B, H, dv), dtype=torch.float32, device=q.device)
    fn = _build.entry(SOURCE, "mx_attention_decode_launch", _ARGTYPES)
    kp, vp = qK.payload, qV.payload
    err = fn(qg.data_ptr(), kp["mantissa"].data_ptr(),
             kp["exponent"].data_ptr(), kp["micro"].data_ptr(),
             vp["mantissa"].data_ptr(), vp["exponent"].data_ptr(),
             vp["micro"].data_ptr(), lens.data_ptr(), out.data_ptr(),
             B, T, KVH, G, dk, dv,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mx_attention_decode")
    mx_attention_decode.launches += 1
    return out


#: launches of the CUDA kernel since the count was last reset
mx_attention_decode.launches = 0
