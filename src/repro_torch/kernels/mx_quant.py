"""Standalone MX8 quantizer: the wrapper around ``csrc/mx_quant.cu``.

Replaces the TPU kernel ``repro/kernels/mx_quant.py::mx_quantize``, the
host memory controller's Quantization Unit of paper §5.5 (REG_WRITE).  The
model's two REG_WRITE sites call it on the card through
:func:`store_quantized`: the recurrent state at the end of prefill
(``models/ssm.py::_store_state``) and the prefill K/V
(``models/model.py::_build_kv_cache``).  On an H100 it is bound by bytes
(4 B read and 1.125 B written per value); one thread quantizes one
16-value group (see the source's header).

The wrapper takes the plain version (:func:`repro_torch.kernels.ref.
mx_quantize_ref`) only for a tensor on the CPU.  For a CUDA tensor it
launches the kernel or raises.  It takes fp32 (the port's activations);
the TPU kernel's ``row_block`` is a tiling knob that changes no result and
has no counterpart here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import formats as F
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

SOURCE = "mx_quant"

#: the plain version of the same function (the oracle)
plain = _ref.mx_quantize_ref

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_uint32,
                                     ctypes.c_int, ctypes.c_void_p]


def mx_quantize(x: torch.Tensor, seed: int = 0, *,
                rounding: str = "nearest") -> F.QuantizedTensor:
    """Quantize ``x`` (fp32, last axis a multiple of 16) to MX8, groups
    along the last axis; stochastic rounding draws its bits from the
    counter hash of the flat index and ``seed`` (uint32).  Returns a
    ``QuantizedTensor`` in ``core/formats.py``'s layout."""
    if x.dtype != torch.float32:
        raise TypeError(f"mx_quantize takes float32, got {x.dtype}")
    if rounding not in F.ROUNDINGS:
        raise ValueError(f"unknown rounding {rounding!r}")
    shape = tuple(x.shape)
    cols = shape[-1] if shape else 0
    if not shape or cols % F.MX8_GROUP:
        raise ValueError(f"last dim of {shape} not divisible by "
                         f"{F.MX8_GROUP}")
    seed = int(seed) & 0xFFFFFFFF
    dev = x.device
    if dev.type == "cpu":
        return plain(x, rounding, seed)
    if dev.type != "cuda":
        raise ValueError(f"mx_quantize: unsupported device {dev}")
    gshape = shape[:-1] + (cols // F.MX8_GROUP,)
    mant = torch.empty(shape, dtype=torch.int8, device=dev)
    expo = torch.empty(gshape, dtype=torch.uint8, device=dev)
    micro = torch.empty(gshape, dtype=torch.uint8, device=dev)
    xc = x.contiguous()
    if xc.data_ptr() % 16:                     # float4 loads need 16 B
        xc = xc.clone()
    fn = _build.entry(SOURCE, "mx_quant_launch", _ARGTYPES)
    err = fn(xc.data_ptr(), mant.data_ptr(), expo.data_ptr(),
             micro.data_ptr(), x.numel() // F.MX8_GROUP, seed,
             int(rounding == "stochastic"),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mx_quantize")
    mx_quantize.launches += 1
    return F.QuantizedTensor("mx8", shape, {"mantissa": mant,
                                            "exponent": expo,
                                            "micro": micro})


#: launches of the CUDA kernel since the count was last reset
mx_quantize.launches = 0


def store_quantized(x: torch.Tensor, sq) -> F.QuantizedTensor:
    """The REG_WRITE quantizer (round to nearest) of a state config ``sq``
    (``ops.StateQuantConfig``): MX8 with the ``cuda`` backend goes through
    :func:`mx_quantize` (its plain version for a CPU tensor); every other
    format or backend through ``F.quantize``."""
    if sq.fmt == "mx8" and sq.backend == "cuda":
        return mx_quantize(x.to(torch.float32))
    return F.quantize(x, sq.fmt)
