"""MX8 quantizers: the wrappers around ``csrc/mx_quant.cu``.

Replaces the TPU kernel ``repro/kernels/mx_quant.py::mx_quantize``, the
host memory controller's Quantization Unit of paper §5.5 (REG_WRITE).  On
an H100 it is bound by bytes (4 B read and 1.125 B written per value).
Two launches, each taking all of a layer's streams (1 or 2: K and V, or
one MLA latent):

``mx_quantize_streams`` (kernel 7) quantizes each stream in one launch,
optionally padding axis 1 with zeros (bitwise ``F.pad`` then quantize):
the model's REG_WRITE sites call it on the card, the prefill's K/V
(``models/model.py::_build_kv_cache``, both streams at once, padded to the
128-token tile) and, through :func:`mx_quantize` and
:func:`store_quantized`, the recurrent state at the end of prefill
(``models/ssm.py::_store_state``).

``mx_kv_append_quant`` quantizes a decode step's new K/V rows straight into
the dense MX8 cache at each row's length: the slot pool's ``kv_append``
(``ops/attention.py::KVAppendCuda``), byte for byte the eager quantize
followed by ``core/attention_cache.py::_update_at``.

Each wrapper takes its plain version (:mod:`repro_torch.kernels.ref`) only
for tensors on the CPU.  For CUDA tensors it launches the kernel or raises.
They take fp32 (the port's activations); the TPU kernel's ``row_block`` is
a tiling knob that changes no result and has no counterpart here.
``mx_quantize.launches`` counts kernel 7's launches (one a launch, whether
it carries one stream or two); ``mx_kv_append_quant.launches`` counts the
append's two-stream launches (K and V), ``mla_launches`` its one-stream
ones (an MLA latent).
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence

import torch

from repro_torch.core import formats as F
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

SOURCE = "mx_quant"
MAX_STREAMS = 2                         # K and V; an MLA latent is one

#: plain versions of the same functions (the oracles)
plain = _ref.mx_quantize_ref
plain_streams = _ref.mx_quantize_streams_ref
plain_append = _ref.kv_append_quant_ref

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_uint32,
                                     ctypes.c_int, ctypes.c_void_p]
_STREAMS_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [
    ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]
_APPEND_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p] \
    + [ctypes.c_int] * 3 + [ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p]

_U32 = 0xFFFFFFFF


def _check_streams(xs, what: str) -> List[torch.Tensor]:
    xs = list(xs)
    if not 1 <= len(xs) <= MAX_STREAMS:
        raise ValueError(f"{what}: {len(xs)} streams, expected 1.."
                         f"{MAX_STREAMS}")
    for i, x in enumerate(xs):
        if x.dtype != torch.float32:
            raise TypeError(f"{what}: stream {i} must be float32, got "
                            f"{x.dtype}")
    return xs


def _aligned(x: torch.Tensor) -> torch.Tensor:
    xc = x.contiguous()
    return xc.clone() if xc.data_ptr() % 16 else xc   # float4 loads


def mx_quantize_streams(xs: Sequence[torch.Tensor],
                        seeds: Optional[Sequence[int]] = None, *,
                        rounding: str = "nearest",
                        pad_to: Optional[int] = None
                        ) -> List[F.QuantizedTensor]:
    """Quantize 1 or 2 fp32 streams of the same leading shape (last axis a
    multiple of 16) to MX8 in one launch, groups along the last axis;
    stream ``i`` draws its stochastic-rounding bits from the counter hash
    of its own flat index and ``seeds[i]`` (uint32; default 0).  With
    ``pad_to``, axis 1 is padded with zeros to that length first (bitwise
    ``F.pad`` then quantize).  Returns one ``QuantizedTensor`` a stream,
    in ``core/formats.py``'s layout."""
    xs = _check_streams(xs, "mx_quantize_streams")
    seeds = [0] * len(xs) if seeds is None else list(seeds)
    if len(seeds) != len(xs):
        raise ValueError(f"{len(seeds)} seeds for {len(xs)} streams")
    if rounding not in F.ROUNDINGS:
        raise ValueError(f"unknown rounding {rounding!r}")
    lead, dev = tuple(xs[0].shape[:-1]), xs[0].device
    for i, x in enumerate(xs):
        shape = tuple(x.shape)
        if not shape or shape[-1] % F.MX8_GROUP:
            raise ValueError(f"last dim of {shape} not divisible by "
                             f"{F.MX8_GROUP}")
        if shape[:-1] != lead or x.device != dev:
            raise ValueError(f"stream {i} {shape} on {x.device} does not "
                             f"match stream 0 {tuple(xs[0].shape)} on {dev}")
    rows = lead[1] if len(lead) >= 2 else None
    if pad_to is not None and (rows is None or not rows <= pad_to):
        raise ValueError(f"pad_to={pad_to}: streams {tuple(xs[0].shape)} "
                         "need an axis 1 of at most that length")
    seeds = [int(s) & _U32 for s in seeds]
    if dev.type == "cpu":
        return plain_streams(xs, seeds, rounding, pad_to)
    if dev.type != "cuda":
        raise ValueError(f"mx_quantize_streams: unsupported device {dev}")
    xs_ = [_aligned(x) for x in xs]
    if pad_to is None:          # the flat groups: no row structure needed
        outer, rows, padded = 1, 1, 1
        row_groups = [x.numel() // F.MX8_GROUP for x in xs_]
    else:
        outer, padded = lead[0], int(pad_to)
        row_groups = [math.prod(x.shape[2:]) // F.MX8_GROUP for x in xs_]
    outs, ptrs = [], []
    for x in xs_:
        shape = tuple(x.shape)
        if pad_to is not None:
            shape = shape[:1] + (padded,) + shape[2:]
        gshape = shape[:-1] + (shape[-1] // F.MX8_GROUP,)
        q = F.QuantizedTensor("mx8", shape, {
            "mantissa": torch.empty(shape, dtype=torch.int8, device=dev),
            "exponent": torch.empty(gshape, dtype=torch.uint8, device=dev),
            "micro": torch.empty(gshape, dtype=torch.uint8, device=dev)})
        outs.append(q)
        ptrs += [q.payload[f].data_ptr()
                 for f in ("mantissa", "exponent", "micro")]
    n = len(xs_)
    fn = _build.entry(SOURCE, "mx_quant_streams_launch", _STREAMS_ARGTYPES)
    err = fn((ctypes.c_ulonglong * n)(*[x.data_ptr() for x in xs_]),
             (ctypes.c_ulonglong * (3 * n))(*ptrs),
             (ctypes.c_int * n)(*row_groups),
             (ctypes.c_uint32 * n)(*seeds), n, outer, rows, padded,
             int(rounding == "stochastic"),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mx_quantize_streams")
    mx_quantize.launches += 1
    return outs


def mx_quantize(x: torch.Tensor, seed: int = 0, *,
                rounding: str = "nearest") -> F.QuantizedTensor:
    """Quantize ``x`` (fp32, last axis a multiple of 16) to MX8, groups
    along the last axis; stochastic rounding draws its bits from the
    counter hash of the flat index and ``seed`` (uint32).  Returns a
    ``QuantizedTensor`` in ``core/formats.py``'s layout: kernel 7 with one
    stream."""
    if x.dtype != torch.float32:
        raise TypeError(f"mx_quantize takes float32, got {x.dtype}")
    return mx_quantize_streams([x], [seed], rounding=rounding)[0]


#: launches of kernel 7 since the count was last reset
mx_quantize.launches = 0


def mx_kv_append_quant(streams: Sequence[torch.Tensor],
                       caches: Sequence[F.QuantizedTensor],
                       lengths: torch.Tensor, seed: int = 0, *,
                       rounding: str = "stochastic"
                       ) -> Sequence[F.QuantizedTensor]:
    """Quantize the new fp32 rows ``streams[i] (B, n, KVH, w_i)`` to MX8
    (SR bits ``sr_bits((B, n, KVH, w_i), seed + i)``) into the dense MX8
    cache ``caches[i] (B, T, KVH, w_i)`` at tokens ``clamp(lengths[b], 0,
    T - n) + j``, in place; returns the caches.  K and V are two streams,
    an MLA latent one."""
    streams = _check_streams(streams, "mx_kv_append_quant")
    caches = list(caches)
    if len(caches) != len(streams):
        raise ValueError(f"{len(streams)} streams / {len(caches)} caches: "
                         "expected them paired")
    if rounding not in F.ROUNDINGS:
        raise ValueError(f"unknown rounding {rounding!r}")
    dev = streams[0].device
    first = None
    for i, (x, c) in enumerate(zip(streams, caches)):
        B, T, KVH, w = _check_cache(c, f"cache {i}")
        n = x.shape[1] if x.dim() == 4 else 0
        first = first or (B, T, KVH, n)
        if (tuple(x.shape) != (B, n, KVH, w) or (B, T, KVH, n) != first
                or x.device != dev or c.device != dev):
            raise ValueError(f"stream {i} {tuple(x.shape)} on {x.device} "
                             f"does not fit its cache {(B, T, KVH, w)} on "
                             f"{c.device} (want ({first[0]}, n, "
                             f"{first[2]}, {w}) on {dev}, one n and one "
                             "cache length for all streams)")
    B, T, _, n = first
    if not 1 <= n <= T:
        raise ValueError(f"{n} new rows a slot for a cache of {T}")
    if tuple(lengths.shape) != (B,) or lengths.device != dev:
        raise ValueError(f"lengths {tuple(lengths.shape)} on "
                         f"{lengths.device} do not fit batch {B} on {dev}")
    seed = int(seed) & _U32
    if dev.type == "cpu":
        return plain_append(streams, caches, lengths, seed, rounding)
    if dev.type != "cuda":
        raise ValueError(f"mx_kv_append_quant: unsupported device {dev}")
    xs = [_aligned(x) for x in streams]
    lens = lengths.to(torch.int32).contiguous()
    k = len(xs)
    ptrs = [c.payload[f].data_ptr() for c in caches
            for f in ("mantissa", "exponent", "micro")]
    fn = _build.entry(SOURCE, "mx_kv_append_quant_launch", _APPEND_ARGTYPES)
    err = fn((ctypes.c_ulonglong * k)(*[x.data_ptr() for x in xs]),
             (ctypes.c_ulonglong * (3 * k))(*ptrs),
             (ctypes.c_int * k)(*[x.shape[2] * x.shape[3] // F.MX8_GROUP
                                  for x in xs]),
             k, lens.data_ptr(), B, n, T, seed,
             int(rounding == "stochastic"),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mx_kv_append_quant")
    if k == 1:
        mx_kv_append_quant.mla_launches += 1
    else:
        mx_kv_append_quant.launches += 1
    return caches


#: launches of the append kernel since the counts were last reset
mx_kv_append_quant.launches = 0
mx_kv_append_quant.mla_launches = 0


def _check_cache(qt, name: str) -> tuple:
    if not isinstance(qt, F.QuantizedTensor) or qt.fmt != "mx8":
        raise ValueError(f"{name} must be an mx8 QuantizedTensor, got "
                         f"{getattr(qt, 'fmt', type(qt).__name__)}")
    shape = tuple(qt.payload["mantissa"].shape)
    if len(shape) != 4 or shape[-1] % F.MX8_GROUP:
        raise ValueError(f"{name}: mantissa {shape}, expected (B, T, KVH, "
                         f"w) with w a multiple of {F.MX8_GROUP}")
    B, T, KVH, w = shape
    want = {"mantissa": (shape, torch.int8),
            "exponent": ((B, T, KVH, w // F.MX8_GROUP), torch.uint8),
            "micro": ((B, T, KVH, w // F.MX8_GROUP), torch.uint8)}
    for f, (s, dtype) in want.items():
        a = qt.payload[f]
        if tuple(a.shape) != s or a.dtype != dtype or not a.is_contiguous():
            raise ValueError(f"{name} {f}: {tuple(a.shape)} {a.dtype} "
                             f"(contiguous={a.is_contiguous()}), expected "
                             f"contiguous {s} {dtype}")
    if qt.payload["mantissa"].data_ptr() % 16:
        raise ValueError(f"{name} mantissa must be 16-byte aligned")
    return B, T, KVH, w


def store_quantized(x: torch.Tensor, sq) -> F.QuantizedTensor:
    """The REG_WRITE quantizer (round to nearest) of a state config ``sq``
    (``ops.StateQuantConfig``): MX8 with the ``cuda`` backend goes through
    :func:`mx_quantize` (its plain version for a CPU tensor); every other
    format or backend through ``F.quantize``."""
    if sq.fmt == "mx8" and sq.backend == "cuda":
        return mx_quantize(x.to(torch.float32))
    return F.quantize(x, sq.fmt)
