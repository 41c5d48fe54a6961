"""Fused MX8 state update: the wrapper around ``csrc/mx_state_update.cu``.

Replaces the TPU kernel ``repro/kernels/mx_state_update.py::mx_state_update``.
On an H100 the step is bound by bytes: the packed state is read and written
once (9 stored bits per value) against ~10 flops per value.  The kernel
touches each state byte once, in place: a thread owns one 16-value group
column across one or two rows of a head, with the head's ``k``, ``q`` and
``d`` staged once per block; ``y`` is summed in the same order as before
(see the source's header for the design and the numerics).

Slab mode (``slabs=``, ``group=``) serves the paged pool: ``qS`` is then
the whole slab pool ``(n_slabs, n_stack, H, dv, dk)`` and row ``b`` updates
``qS[slabs[b], group]`` in place, with the SR counter and operands on the
batch row -- bitwise the dense call on the gathered rows.

The wrapper takes the plain version (:mod:`repro_torch.kernels.ref`) only
for a state on the CPU.  For a CUDA state it launches the kernel or raises.
The CUDA path updates the state **in place** and returns the same
container; callers must use the returned state, never the old reference.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import formats as F
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

SOURCE = "mx_state_update"

#: plain versions of the same function (the oracles): dense, slab mode
plain = _ref.quantized_state_update_stored_ref
plain_slab = _ref.state_update_slab_ref

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
    ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p]


def _operand(x: torch.Tensor, shape, name: str,
             aligned: bool = False) -> torch.Tensor:
    """``x`` as contiguous float32; ``aligned``: also 16-byte aligned, as
    the kernel stages it with 16-byte loads (a view at an odd offset is
    copied)."""
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    x = x.to(torch.float32).contiguous()
    if aligned and x.data_ptr() % 16:
        x = x.clone()
    return x


def _check_payload(qS: F.QuantizedTensor) -> None:
    lead, dk = tuple(qS.shape[:-1]), qS.shape[-1]
    want = {"mantissa": (lead + (dk,), torch.int8),
            "exponent": (lead + (dk // F.MX8_GROUP,), torch.uint8),
            "micro": (lead + (dk // F.MX8_GROUP,), torch.uint8)}
    for f, (shape, dtype) in want.items():
        a = qS.payload[f]
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise ValueError(f"state {f}: {tuple(a.shape)} {a.dtype}, "
                             f"expected {shape} {dtype}")
        if not a.is_contiguous():
            raise ValueError(f"state {f} must be contiguous")
    if qS.payload["mantissa"].data_ptr() % 16:
        raise ValueError("state mantissa must be 16-byte aligned")


def mx_state_update(qS: F.QuantizedTensor, d: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, q: torch.Tensor, seed: int = 0, *,
                    rounding: str = "stochastic",
                    slabs: Optional[torch.Tensor] = None, group: int = 0
                    ) -> Tuple[F.QuantizedTensor, torch.Tensor]:
    """Fused quantized state update.

    qS: packed MX8 state, logical ``(B, H, dv, dk)`` -- or, with ``slabs``
    (``(B,)`` int slab ids), the slab pool ``(n_slabs, n_stack, H, dv, dk)``
    whose rows ``qS[slabs, group]`` are updated; d: ``(B, H, dk)`` or
    ``(B, H, 1)``; k, q: ``(B, H, dk)``; v: ``(B, H, dv)``; seed: uint32 SR
    seed.  Returns ``(state, y)`` with y ``(B, H, dv)`` float32.
    """
    if qS.fmt != "mx8":
        raise ValueError(f"mx_state_update takes mx8 state, got {qS.fmt}")
    if rounding not in F.ROUNDINGS:
        raise ValueError(f"unknown rounding {rounding!r}")
    seed = int(seed) & 0xFFFFFFFF
    dev = qS.device
    if dev.type == "cpu":
        if slabs is not None:
            return plain_slab(qS, slabs, group, d, k, v, q,
                              rounding=rounding, seed=seed)
        return plain(qS, d, k, v, q, rounding=rounding, seed=seed)
    if dev.type != "cuda":
        raise ValueError(f"mx_state_update: unsupported device {dev}")
    if slabs is None:
        B, H, dv, dk = qS.shape
        n_stack = 1
    else:
        if len(qS.shape) != 5:
            raise ValueError(f"slab mode takes a (n_slabs, n_stack, H, dv, "
                             f"dk) pool, got {qS.shape}")
        _, n_stack, H, dv, dk = qS.shape
        B = slabs.shape[0]
        if not 0 <= group < n_stack:
            raise ValueError(f"group {group} outside the pool's {n_stack}")
    if dk % F.MX8_GROUP or dk // F.MX8_GROUP > 256:
        raise ValueError(f"dk={dk} must be a multiple of 16, at most 4096")
    _check_payload(qS)
    for name, t in (("d", d), ("k", k), ("v", v), ("q", q)) + (
            () if slabs is None else (("slabs", slabs),)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, state on {dev}")
    if d.shape[-1] not in (1, dk):
        raise ValueError(f"d must be (B,H,1) or (B,H,{dk}), got {tuple(d.shape)}")
    d_ = _operand(d, (B, H, d.shape[-1]), "d", aligned=True)
    k_ = _operand(k, (B, H, dk), "k", aligned=True)
    q_ = _operand(q, (B, H, dk), "q", aligned=True)
    v_ = _operand(v, (B, H, dv), "v")
    slab_ = (None if slabs is None
             else slabs.to(torch.int32).contiguous())
    y = torch.empty((B, H, dv), dtype=torch.float32, device=dev)
    fn = _build.entry(SOURCE, "mx_state_update_launch", _ARGTYPES)
    p = qS.payload
    err = fn(p["mantissa"].data_ptr(), p["exponent"].data_ptr(),
             p["micro"].data_ptr(), d_.data_ptr(), k_.data_ptr(),
             v_.data_ptr(), q_.data_ptr(), y.data_ptr(),
             None if slab_ is None else slab_.data_ptr(), B * H, H, n_stack,
             int(group), dv, dk, int(d.shape[-1] == dk), seed,
             int(rounding == "stochastic"),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mx_state_update")
    if slabs is None:
        mx_state_update.launches += 1
    else:
        mx_state_update.slab_launches += 1
    return qS, y


#: launches of the CUDA kernel since the counts were last reset: dense mode
#: (``launches``) and slab mode (``slab_launches``) apart
mx_state_update.launches = 0
mx_state_update.slab_launches = 0
