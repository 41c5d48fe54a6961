"""Decode attention over a dense MX8 KV cache: the wrapper around
``csrc/mx_attention.cu``.

Replaces the TPU kernel ``repro/kernels/mx_attention.py::mx_attention_decode``,
both modes.  GQA: on an H100 one decode query per head is bound by bytes:
each valid cached K and V value is read once (9 stored bits) against ~4
flops per query head.  The kernel splits each row's time axis into
128-position splits, one block each, and the ``G`` query heads of a kv
head into row blocks of at most 16 rows and 2048 accumulator items (one
block where they fit: grid ``(B, KVH * row blocks, T / 128)``,
:func:`split_block_rows`), stages K / V through shared memory with
``cp.async``, and combines the splits' flash-style fp32 partials in order
in the same launch (``csrc/mx_attention_split.cuh``).
:func:`split_scratch` gives it a workspace for the partials and the
per-(row, kv head, row block) counters through which the last block of
each finds out it is last; the counters are
cached per device and stay zero between launches (each pair's last block
resets its own), so a CUDA graph can replay the launch.  Kernels that share
the counters must not run concurrently on two streams.
MLA (``qV=None``, ``v_width``): one latent stream whose first ``v_width``
lanes are the values; at deepseek-v2-236b's widths it is bound by
arithmetic (128 heads per latent row) and runs ``csrc/mx_mla_tile.cuh``'s
split loop: grid ``(B, KVH * ceil(R / 16), T / 64)``, one block per
64-position split and 16 query rows, both products on the tensor cores
(the fp32 operand in three bf16 terms), the splits combined in order in
the same launch through :func:`mla_scratch`'s workspace and the same
per-device counters as the GQA loop.

The wrapper takes the plain version (:mod:`repro_torch.kernels.ref`) only
for tensors on the CPU; for CUDA tensors it launches the kernel of its mode
or raises.  ``launches`` counts GQA launches, ``mla_launches`` MLA ones.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import formats as F
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

SOURCE = "mx_attention"
T_BLOCK = 128
SPLIT = 128             # csrc/mx_attention_split.cuh: kSplit positions a block
SPLIT_MAX_ROWS = 16     # kMaxRows query rows a block
SPLIT_MAX_ITEMS = 2048  # kMaxItems accumulator items a block (rows * dv)
SPLIT_MAX_SMEM = 227 * 1024 - 1024   # kMaxSmem dynamic shared memory bytes
SM_SMEM = 228 * 1024    # shared memory of one SM (sm_90)
MIN_COUNTERS = 4096     # (row, kv head) pairs the first counter buffer holds
MLA_SPLIT = 64          # csrc/mx_mla_tile.cuh: kSplit positions a block
MLA_ROWS = 16           # kRows query rows a block
MLA_MAX_DK = 1152       # kMaxDk (shared memory)
MLA_MAX_DV = 512        # kMaxDv: 64 output columns per warp

#: plain version of the same function (the oracle)
plain = _ref.mx_attention_decode_ref

_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
_MLA_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


#: the split loops' counters per device (GQA and MLA share them); a buffer
#: outgrown stays referenced, since a captured CUDA graph may still launch
#: with its address
_COUNTERS: Dict[Tuple[str, int], List[torch.Tensor]] = {}


def _counters(n: int, device: torch.device) -> torch.Tensor:
    """The device's zeroed counters, at least ``n`` of them."""
    key = (device.type, device.index if device.index is not None
           else torch.cuda.current_device())
    held = _COUNTERS.setdefault(key, [])
    if not held or held[-1].numel() < n:
        held.append(torch.zeros(max(n, MIN_COUNTERS), dtype=torch.int32,
                                device=device))
    return held[-1]


def split_block_rows(R: int, G: int, dv: int) -> int:
    """Query rows a block of the GQA split loop takes of the ``R = n_q *
    G`` query-major rows of one kv head (``block_rows`` in
    ``csrc/mx_attention_split.cuh``): all of them where they fit 16 rows and
    2048 accumulator items; else as many whole verify positions (``G``
    rows each) as fit; else as many rows as fit."""
    cap = min(SPLIT_MAX_ROWS, SPLIT_MAX_ITEMS // dv) if dv > 0 else 0
    if R <= cap or cap < 1:
        return R
    return cap // G * G if G <= cap else cap


def split_row_blocks(R: int, G: int, dv: int) -> int:
    """Row blocks of the GQA split loop per (batch row, kv head)."""
    rb = split_block_rows(R, G, dv)
    return -(-R // rb) if rb > 0 else 1


def split_smem_bytes(R: int, dk: int, dv: int) -> int:
    """Dynamic shared memory of a GQA split-loop block of ``R`` query
    rows (``smem_layout`` in ``csrc/mx_attention_split.cuh``): the queries,
    the score quarters (sharing their region with the eight warps' P V
    partials), the probabilities, the split's values in bf16 and two
    staged sub-tiles of 64 positions."""
    def cover(w):
        return (w + 30) // 16
    ks = dk if (dk // 16) % 2 else dk + 16
    stage = 64 * (ks + dv) + 64 * 32 * (cover(dk // 16) + cover(dv // 16))
    return (4 * R * dk + 4 * R * max(4 * SPLIT, 8 * dv) + 4 * R * SPLIT
            + 2 * SPLIT * (dv + 8) + 2 * stage)


def split_blocks_per_sm(R: int, G: int, dk: int, dv: int) -> int:
    """Blocks of the GQA split loop (``R`` query rows of ``G`` heads a kv
    head) whose shared memory one SM holds at once: each block's dynamic
    shared memory, its 256 B of static arrays and the 1 KB the SM reserves
    a block."""
    rows = split_block_rows(R, G, dv)
    return SM_SMEM // (split_smem_bytes(rows, dk, dv) + 256 + 1024)


def split_checked(R: int, G: int, dk: int, dv: int, name: str) -> None:
    """Refuse (``ValueError``, never a fallback) what a block of the GQA
    split loop cannot hold: a value row wider than its 2048 accumulators,
    or a row block whose shared memory passes the 226 KB a block may opt
    into (the 227 KB of sm_90, less 1 KB for the loop's static arrays)."""
    if dk % 16 or dv % 16 or dk <= 0 or dv <= 0:
        raise ValueError(f"{name}: dk={dk}, dv={dv} must be positive "
                         "multiples of 16")
    if dv > SPLIT_MAX_ITEMS:
        raise ValueError(f"{name}: dv={dv} is wider than a block's "
                         f"{SPLIT_MAX_ITEMS} accumulators")
    rows = split_block_rows(R, G, dv)
    smem = split_smem_bytes(rows, dk, dv)
    if smem > SPLIT_MAX_SMEM:
        raise ValueError(f"{name}: a block of {rows} query rows at dk={dk}, "
                         f"dv={dv} needs {smem} B of shared memory, past the "
                         f"{SPLIT_MAX_SMEM} B a block holds")


def split_scratch(B: int, KVH: int, S: int, R: int, G: int, dv: int,
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GQA split loop's workspace for ``S`` splits and ``R = n_q * G``
    query rows of width ``dv`` per kv head (a new buffer: every split the
    kernel combines writes its partial first), and the device's zeroed
    per-(row, kv head, row block) counters."""
    ws = torch.empty(B * KVH * S * R * (dv + 2), dtype=torch.float32,
                     device=device)
    return ws, _counters(B * KVH * split_row_blocks(R, G, dv), device)


def mla_scratch(B: int, KVH: int, T: int, R: int, dv: int,
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MLA split loop's workspace for a cache of ``T`` positions (``T /
    64`` splits) and ``R`` query rows of width ``dv`` per kv head: one
    ``(m, l, acc)`` partial of 16 rows per (batch row, kv head, row block,
    split), about ``R * dv`` floats per split; and the device's zeroed
    counters, one per (batch row, kv head, row block)."""
    nrb = -(-R // MLA_ROWS)
    ldw = -(-dv // 4) * 4           # a row padded to whole float4s
    ws = torch.empty(B * KVH * nrb * (T // MLA_SPLIT) * MLA_ROWS * (ldw + 2),
                     dtype=torch.float32, device=device)
    return ws, _counters(B * KVH * nrb, device)


def _aligned(q: torch.Tensor) -> torch.Tensor:
    """q as contiguous fp32 at a 16-byte aligned address (the GQA kernels
    stage it with 16-byte cp.async)."""
    qg = q.to(torch.float32).contiguous()
    return qg.clone() if qg.data_ptr() % 16 else qg


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
        return _mla_decode(q, qK, lengths, scale, v_width)
    B, H, dk = q.shape
    _, T, KVH, _ = qK.shape
    if H % KVH or T % T_BLOCK:
        raise ValueError(f"H={H} must divide by KVH={KVH}; T={T} must be a "
                         f"multiple of {T_BLOCK}")
    G = H // KVH
    if _check_stream(qK, B, T, KVH, "K") != dk:
        raise ValueError(f"key width {qK.shape[-1]} != query width {dk}")
    dv = _check_stream(qV, B, T, KVH, "V")
    split_checked(G, G, dk, dv, "mx_attention_decode")
    for name, t in (("K", qK.payload["mantissa"]),
                    ("V", qV.payload["mantissa"]), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    scale = scale if scale is not None else dk ** -0.5
    qg = _aligned(q)                           # the kernel applies scale
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty((B, H, dv), dtype=torch.float32, device=q.device)
    ws, counters = split_scratch(B, KVH, T // SPLIT, G, G, dv, q.device)
    fn = _build.entry(SOURCE, "mx_attention_decode_launch", _ARGTYPES)
    kp, vp = qK.payload, qV.payload
    err = fn(qg.data_ptr(), kp["mantissa"].data_ptr(),
             kp["exponent"].data_ptr(), kp["micro"].data_ptr(),
             vp["mantissa"].data_ptr(), vp["exponent"].data_ptr(),
             vp["micro"].data_ptr(), lens.data_ptr(), out.data_ptr(),
             ws.data_ptr(), counters.data_ptr(), B, T, KVH, G, dk, dv,
             scale, ws.numel(), counters.numel(),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mx_attention_decode")
    mx_attention_decode.launches += 1
    return out


def mla_checked(dk: int, v_width: Optional[int], name: str) -> int:
    """The value width of an MLA-mode call, after the kernel's limits."""
    if v_width is None:
        raise ValueError(f"{name}: MLA mode (no value stream) needs v_width")
    if dk % 16 or dk > MLA_MAX_DK or not 0 < v_width <= min(dk, MLA_MAX_DV):
        raise ValueError(f"{name}: MLA kernel takes dk % 16 == 0, "
                         f"dk <= {MLA_MAX_DK}, 0 < v_width <= min(dk, "
                         f"{MLA_MAX_DV}); got dk={dk}, v_width={v_width}")
    return int(v_width)


def _mla_decode(q: torch.Tensor, qK: F.QuantizedTensor,
                lengths: torch.Tensor, scale: Optional[float],
                v_width: Optional[int]) -> torch.Tensor:
    B, H, dk = q.shape
    _, T, KVH, _ = qK.shape
    if H % KVH or T % T_BLOCK:
        raise ValueError(f"H={H} must divide by KVH={KVH}; T={T} must be a "
                         f"multiple of {T_BLOCK}")
    if _check_stream(qK, B, T, KVH, "latent") != dk:
        raise ValueError(f"latent width {qK.shape[-1]} != query width {dk}")
    dv = mla_checked(dk, v_width, "mx_attention_decode")
    for name, t in (("latent", qK.payload["mantissa"]), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    scale = scale if scale is not None else dk ** -0.5
    qg = (q.to(torch.float32) * scale).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty((B, H, dv), dtype=torch.float32, device=q.device)
    G = H // KVH
    ws, counters = mla_scratch(B, KVH, T, G, dv, q.device)
    fn = _build.entry(SOURCE, "mx_attention_decode_mla_launch", _MLA_ARGTYPES)
    kp = qK.payload
    err = fn(qg.data_ptr(), kp["mantissa"].data_ptr(),
             kp["exponent"].data_ptr(), kp["micro"].data_ptr(),
             lens.data_ptr(), out.data_ptr(), ws.data_ptr(),
             counters.data_ptr(), B, T, KVH, G, dk, dv, ws.numel(),
             counters.numel(), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mx_attention_decode (MLA)")
    mx_attention_decode.mla_launches += 1
    return out


#: launches of the CUDA kernels (GQA, MLA) since the counts were last reset
mx_attention_decode.launches = 0
mx_attention_decode.mla_launches = 0
