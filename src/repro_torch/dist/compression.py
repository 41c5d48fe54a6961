"""Int8-compressed gradient all-reduce with error feedback (the port's copy
of ``repro/dist/compression.py``).

The multi-pod mesh (``launch/mesh.py``) makes its 'pod' axis pure data
parallelism over the slow inter-pod network, and only gradient
all-reduces cross it.  At bf16 that link moves 2 bytes a parameter a
step; quantizing the gradients to int8 with a per-tensor scale halves the
wire cost, and carrying the quantization residual into the next step
(error feedback, as in EF-SGD / 1-bit Adam) keeps the compression bias
from accumulating: what is rounded away this step is added back before
rounding the next.

Mesh-free by construction: :func:`compressed_allreduce_mean` with
``group=None`` applies the same quantize -> dequantize -> residual
pipeline without a collective (the JAX package's ``axis_name=None``).
``torch.round`` rounds half to even as ``jnp.round`` does, so ``q``,
``scale`` and the residual are bitwise the JAX package's on the same
fp32 input.  Like the JAX package's train step, the port's does not use
the compressor: it is a library function.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import tree as T

INT8_MAX = 127
_SCALE_BYTES = 4                      # one fp32 scale per tensor on the wire


def init_error_feedback(grads: Any) -> Any:
    """Zeroed residual carriers, one per gradient leaf (fp32)."""
    return T.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                            device=g.device), grads)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor max-abs int8 quantization: returns (q, scale).  Both
    divisions are by a tensor on ``x``'s device: CUDA divides by a Python
    number as a multiply by its reciprocal, which is not the correctly
    rounded quotient the CPU and the JAX package compute."""
    x = x.to(torch.float32)
    scale = torch.max(torch.abs(x)) / torch.full(
        (), INT8_MAX, dtype=torch.float32, device=x.device)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))  # all zero
    q = torch.clamp(torch.round(x / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_allreduce_mean(grads: Any, error_fb: Any, group=None
                              ) -> Tuple[Any, Any]:
    """Mean-reduce ``grads`` over the process group ``group`` through an
    int8 wire format.

    Per leaf: quantize (grad + carried residual) to int8, keep the new
    residual locally, and average the dequantized payload over the group
    (``torch.distributed.all_reduce``, then a division by its size).
    Returns (reduced grads, new error feedback).  With ``group=None`` (no
    mesh) the reduction is the identity -- the compression numerics are
    unchanged, which is what the unit tests exercise.
    """
    reds, efs = [], []
    for g, e in zip(T.leaves(grads), T.leaves(error_fb)):
        x = g.to(torch.float32) + e
        q, scale = quantize_int8(x)
        deq = dequantize_int8(q, scale)
        efs.append(x - deq)
        if group is not None:
            dist.all_reduce(deq, group=group)
            deq = deq / dist.get_world_size(group)
        reds.append(deq)
    return T.unflatten(grads, reds), T.unflatten(grads, efs)


def compressed_bytes(tree: Any) -> int:
    """The int8 payload's nominal size for ``tree``'s leaves (1 byte a
    value + the per-tensor scale); compare against 2 * size for the bf16
    baseline.  A formula, not what :func:`compressed_allreduce_mean`
    sends: that all-reduces the dequantized fp32 values (4 bytes a
    value), as the JAX package's ``pmean`` does, until the payload goes
    out as int8 plus its scale."""
    return sum(leaf.numel() + _SCALE_BYTES for leaf in T.leaves(tree))
