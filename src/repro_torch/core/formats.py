"""Low-precision numeric formats for state / KV-cache quantization (PyTorch).

The PyTorch twin of ``repro/core/formats.py``: the same seven formats
(``mx8``, ``int8``, ``fp8_e4m3``, ``fp8_e5m2``, ``fp16``, ``bf16``,
``fp32``), each with round-to-nearest-even and stochastic rounding (SR),
with quantization groups along the last axis and the same payload fields.

Two numeric choices differ from the JAX package on purpose:

* Power-of-two scales are built from their bit pattern (:func:`exact_pow2`),
  so every MX8 / fp8 scale is exact -- what a hardware exponent unit does
  and what the CUDA kernels compute.  XLA:CPU's ``exp2`` is a few ulps off
  for integer arguments, so MX8 mantissas computed here agree with the JAX
  package's to a small stated mismatch rate, not bitwise; exponent and
  micro bytes agree bitwise.
* uint32 arithmetic (the SR counter hash) runs in int64 masked to 32 bits,
  because PyTorch's uint32 tensors support few operations.  The bits are
  identical to the JAX hash.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

MX8_GROUP = 16          # values per shared exponent
MX8_PAIR = 2            # values per micro-exponent
MX8_MBITS = 6           # mantissa magnitude bits (sign stored separately)
INT8_GROUP = 32         # values per scale in the int8-scaled format

FORMATS = ("fp32", "bf16", "fp16", "fp8_e4m3", "fp8_e5m2", "int8", "mx8")
ROUNDINGS = ("nearest", "stochastic")

#: average storage bits per value, used for memory/bandwidth accounting.
FORMAT_BITS: Dict[str, float] = {
    "fp32": 32.0,
    "bf16": 16.0,
    "fp16": 16.0,
    "fp8_e4m3": 8.0,
    "fp8_e5m2": 8.0,
    "int8": 8.0 + 16.0 / INT8_GROUP,
    "mx8": (1 + MX8_MBITS) + 8.0 / MX8_GROUP + 1.0 / MX8_PAIR,
}

FLOAT_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
                "fp16": torch.float16}

_FP8_MAX = {"fp8_e4m3": 448.0, "fp8_e5m2": 57344.0}
_FP8_MBITS = {"fp8_e4m3": 3, "fp8_e5m2": 2}
_FP8_EMIN = {"fp8_e4m3": -6, "fp8_e5m2": -14}   # min normal exponent
_FP8_DTYPE = {"fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}

#: bias applied to the stored MX group exponent (uint8).
MX8_EXP_BIAS = 127

_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# QuantizedTensor
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QuantizedTensor:
    """An opaque quantized array.  ``payload`` holds format-specific parts."""

    fmt: str
    shape: tuple
    payload: Dict[str, torch.Tensor]

    @property
    def nbytes_logical(self) -> float:
        """Logical storage bytes (as a real packed implementation would use)."""
        return float(math.prod(self.shape)) * FORMAT_BITS[self.fmt] / 8.0

    @property
    def device(self) -> torch.device:
        return next(iter(self.payload.values())).device

    def clone(self) -> "QuantizedTensor":
        return QuantizedTensor(self.fmt, tuple(self.shape),
                               {f: a.clone() for f, a in self.payload.items()})


# ---------------------------------------------------------------------------
# Random bits for stochastic rounding
# ---------------------------------------------------------------------------

def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def counter_hash_u32(counter: torch.Tensor, seed) -> torch.Tensor:
    """Counter-based stateless PRNG ("lowbias32"), bit-identical to the JAX
    package's hash.  Returns int64 holding uint32 values."""
    if isinstance(seed, torch.Tensor):
        mix = _mul_u32(seed.to(torch.int64) & _U32, 0x9E3779B9)
    else:
        mix = (int(seed) * 0x9E3779B9) & _U32
    x = (counter.to(torch.int64) & _U32) ^ mix
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def sr_bits(shape, seed, offset: int = 0, device=None) -> torch.Tensor:
    """Uniform uint32 bits (as int64) for SR over an array of ``shape``."""
    n = math.prod(shape)
    idx = (torch.arange(n, dtype=torch.int64, device=device) + offset) & _U32
    return counter_hash_u32(idx, seed).reshape(tuple(shape))


def sr_bits_at(shape, seed, row_base: int = 0, head_axis: int = 1,
               head_base: int = 0, heads_total=None,
               device=None) -> torch.Tensor:
    """SR bits for a block of a larger array: ``shape`` is rows
    ``row_base ..`` of its dim 0 and heads ``head_base ..`` of its dim
    ``head_axis``, which holds ``heads_total`` heads in the whole array
    (``None``: all of them).  Each element draws at its flat index in the
    whole array, in uint32 arithmetic, so a data-parallel rank's rows and a
    tensor-parallel rank's heads draw what the whole array's call draws
    for them.  Bitwise :func:`sr_bits` at the row offset when the block
    holds every head."""
    shape = tuple(shape)
    H = shape[head_axis]
    Ht = H if heads_total is None else int(heads_total)
    if head_base == 0 and Ht == H:
        return sr_bits(shape, seed, int(row_base) * math.prod(shape[1:]),
                       device)
    if not 0 <= head_base <= Ht - H:
        raise ValueError(f"heads {head_base} .. {head_base + H - 1} outside "
                         f"the whole array's {Ht}")
    lead = shape[0] * math.prod(shape[1:head_axis])
    inner = math.prod(shape[head_axis + 1:])
    a = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    # flat index of (row, ..., head, ...) in the whole array: the leading
    # dims as one counter from row_base, then the head, then the rest
    outer = a(lead) + int(row_base) * math.prod(shape[1:head_axis])
    idx = ((outer[:, None] * Ht + head_base + a(H)[None, :])[..., None]
           * inner + a(inner)) & _U32
    return counter_hash_u32(idx, seed).reshape(shape)


def _u32_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 -> uniform in [0, 1) (round-to-nearest u32 -> f32)."""
    return bits.to(torch.float32) * (2.0 ** -32)


def _round(x: torch.Tensor, rounding: str,
           bits: Optional[torch.Tensor]) -> torch.Tensor:
    if rounding == "nearest":
        return torch.round(x)  # round-half-to-even
    if bits is None:
        raise ValueError("stochastic rounding requires random bits")
    return torch.floor(x + _u32_to_unit(bits))


# ---------------------------------------------------------------------------
# exact powers of two
# ---------------------------------------------------------------------------

def exact_pow2(e: torch.Tensor) -> torch.Tensor:
    """2**e as float32, exact for integer e in [-149, 127] (subnormals too).

    Built from the bit pattern: the biased exponent field for normal
    results, a single mantissa bit below 2**-126.
    """
    e = e.to(torch.int32)
    normal = (e + 127).clamp(min=1) << 23
    sub = torch.ones_like(e) << (e + 149).clamp(0, 22)
    return torch.where(e >= -126, normal, sub).view(torch.float32)


# ---------------------------------------------------------------------------
# MX8
# ---------------------------------------------------------------------------

def _frexp_exponent(x: torch.Tensor) -> torch.Tensor:
    """e such that 2^(e-1) <= x < 2^e for normal x>0 (0 -> -126), by
    exponent-field extraction as in the JAX package and the kernels."""
    raw = x.to(torch.float32).contiguous().view(torch.int32)
    e = ((raw >> 23) & 0xFF) - 126
    return torch.where(x > 0, e, torch.full_like(e, -MX8_EXP_BIAS + 1))


def mx8_quantize(x: torch.Tensor, rounding: str = "nearest",
                 bits: Optional[torch.Tensor] = None) -> QuantizedTensor:
    """Quantize to MX8 along the last axis (length must divide MX8_GROUP)."""
    orig_shape = tuple(x.shape)
    n = x.shape[-1]
    if n % MX8_GROUP:
        raise ValueError(f"last dim {n} not divisible by {MX8_GROUP}")
    ng = n // MX8_GROUP
    g = x.to(torch.float32).reshape(*x.shape[:-1], ng, MX8_GROUP)
    gmax = g.abs().amax(dim=-1)                                  # (..., G)
    e = _frexp_exponent(gmax).clamp(-MX8_EXP_BIAS + 1, 127)      # shared exp
    p = g.reshape(*g.shape[:-1], MX8_GROUP // MX8_PAIR, MX8_PAIR)
    pmax = p.abs().amax(dim=-1)                                  # (..., G, 8)
    # micro bit: the pair fits in half the group range.  A group whose
    # exponent sits at the floor (-126: all-zero or below 2^-126) keeps
    # micro 0, as in the JAX package, whose threshold 2^-127 flushes to 0.
    micro = ((pmax < exact_pow2(e - 1)[..., None])
             & (e > -MX8_EXP_BIAS + 1)[..., None]).to(torch.int32)
    scale = exact_pow2(e[..., None] - MX8_MBITS - micro)         # (..., G, 8)
    q = p / scale[..., None]
    if bits is not None:
        bits = bits.reshape(p.shape)
    q = _round(q, rounding, bits).clamp(-63, 63).to(torch.int8)
    shifts = torch.arange(MX8_GROUP // MX8_PAIR, dtype=torch.int32,
                          device=x.device)
    micro_packed = (micro << shifts).sum(dim=-1).to(torch.uint8)
    return QuantizedTensor("mx8", orig_shape, {
        "mantissa": q.reshape(orig_shape),
        "exponent": (e + MX8_EXP_BIAS).to(torch.uint8),
        "micro": micro_packed,
    })


def mx8_dequantize(qt: QuantizedTensor) -> torch.Tensor:
    mant = qt.payload["mantissa"].to(torch.float32)
    e = qt.payload["exponent"].to(torch.int32) - MX8_EXP_BIAS     # (..., G)
    mp = qt.payload["micro"].to(torch.int32)
    shifts = torch.arange(MX8_GROUP // MX8_PAIR, dtype=torch.int32,
                          device=mp.device)
    micro = (mp[..., None] >> shifts) & 1                         # (..., G, 8)
    scale = exact_pow2(e[..., None] - MX8_MBITS - micro)
    n = qt.shape[-1]
    p = mant.reshape(*mant.shape[:-1], n // MX8_GROUP,
                     MX8_GROUP // MX8_PAIR, MX8_PAIR)
    return (p * scale[..., None]).reshape(qt.shape)


# ---------------------------------------------------------------------------
# int8 with per-group scale
# ---------------------------------------------------------------------------

def int8_quantize(x: torch.Tensor, rounding: str = "nearest",
                  bits: Optional[torch.Tensor] = None) -> QuantizedTensor:
    orig_shape = tuple(x.shape)
    n = x.shape[-1]
    if n % INT8_GROUP:
        raise ValueError(f"last dim {n} not divisible by {INT8_GROUP}")
    g = x.to(torch.float32).reshape(*x.shape[:-1], n // INT8_GROUP, INT8_GROUP)
    gmax = g.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(gmax > 0, gmax / 127.0, torch.ones_like(gmax))
    q = g / scale
    if bits is not None:
        bits = bits.reshape(g.shape)
    q = _round(q, rounding, bits).clamp(-127, 127).to(torch.int8)
    return QuantizedTensor("int8", orig_shape, {
        "q": q.reshape(orig_shape),
        "scale": scale.squeeze(-1).to(torch.float16),
    })


def int8_dequantize(qt: QuantizedTensor) -> torch.Tensor:
    q = qt.payload["q"].to(torch.float32)
    scale = qt.payload["scale"].to(torch.float32)
    n = qt.shape[-1]
    g = q.reshape(*q.shape[:-1], n // INT8_GROUP, INT8_GROUP)
    return (g * scale[..., None]).reshape(qt.shape)


# ---------------------------------------------------------------------------
# fp8 (emulated)
# ---------------------------------------------------------------------------

def _fp8_quantize_values(x: torch.Tensor, fmt: str, rounding: str,
                         bits: Optional[torch.Tensor]) -> torch.Tensor:
    fmax = _FP8_MAX[fmt]
    xf = x.to(torch.float32).clamp(-fmax, fmax)
    if rounding == "nearest":
        return xf.to(_FP8_DTYPE[fmt])
    # SR: snap to the ulp grid of the target format; the cast is then exact
    mbits, emin = _FP8_MBITS[fmt], _FP8_EMIN[fmt]
    _, e = torch.frexp(xf)
    e = torch.where(xf != 0, e, torch.full_like(e, emin))
    ulp = exact_pow2(torch.clamp(e - 1, min=emin) - mbits)
    q = torch.floor(xf / ulp + _u32_to_unit(bits)) * ulp
    return q.clamp(-fmax, fmax).to(_FP8_DTYPE[fmt])


def fp8_quantize(x: torch.Tensor, fmt: str, rounding: str = "nearest",
                 bits: Optional[torch.Tensor] = None) -> QuantizedTensor:
    return QuantizedTensor(fmt, tuple(x.shape),
                           {"x": _fp8_quantize_values(x, fmt, rounding, bits)})


# ---------------------------------------------------------------------------
# unified entry points
# ---------------------------------------------------------------------------

def quantize(x: torch.Tensor, fmt: str, rounding: str = "nearest",
             bits: Optional[torch.Tensor] = None) -> QuantizedTensor:
    """Quantize ``x`` (groups along the last axis) into ``fmt``."""
    if fmt == "mx8":
        return mx8_quantize(x, rounding, bits)
    if fmt == "int8":
        return int8_quantize(x, rounding, bits)
    if fmt in _FP8_DTYPE:
        return fp8_quantize(x, fmt, rounding, bits)
    if fmt in FLOAT_DTYPES:
        return QuantizedTensor(fmt, tuple(x.shape),
                               {"x": x.to(FLOAT_DTYPES[fmt])})
    raise ValueError(f"unknown format {fmt!r}")


def dequantize(qt: QuantizedTensor) -> torch.Tensor:
    if qt.fmt == "mx8":
        return mx8_dequantize(qt)
    if qt.fmt == "int8":
        return int8_dequantize(qt)
    return qt.payload["x"].to(torch.float32)
