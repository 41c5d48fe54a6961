"""Core vocabulary of the unified SPU operator API (PyTorch port).

Mirrors ``repro/ops/base.py``: every decode-time memory-bound op is an
:class:`SpuOp` registered by ``(kind, backend, format, layout)``, with the
same plan / execute / traffic split, so ``traffic(plan)`` gives the same
byte counts as the JAX package for paired backends (``torch`` <-> ``jnp``,
``cuda`` <-> ``pallas``).

Backends in the port:

``cuda``   hand-written CUDA kernels for Hopper (``repro_torch/csrc``),
           MX8 only.  The twin of the JAX package's ``pallas`` backend.
``torch``  plain PyTorch ops for every storage format, on any device.
           The twin of ``jnp``; also the kernels' plain reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import torch

from repro_torch.core import formats as F


class SpuDeprecationWarning(DeprecationWarning):
    """Raised by the pre-registry entry points (``repro_torch.kernels.ops``,
    ``repro_torch.core.state_update.state_update_step``).

    A distinct subclass so first-party tests can run under
    ``-W error::repro_torch.ops.base.SpuDeprecationWarning`` without
    tripping on unrelated third-party DeprecationWarnings.
    """


@dataclasses.dataclass(frozen=True)
class StateQuantConfig:
    """How recurrent state (and KV caches) are stored.

    ``backend`` is a preference: dispatch goes through
    :func:`repro_torch.ops.registry.resolve_backend`, which falls back to a
    capable backend when the requested one is not registered for
    ``(kind, fmt)`` (the CUDA kernels exist only for MX8).
    """
    fmt: str = "mx8"                 # fp32|bf16|fp16|fp8_e4m3|fp8_e5m2|int8|mx8
    rounding: str = "stochastic"     # nearest|stochastic
    backend: str = "cuda"            # cuda|torch (preference, see above)

    @property
    def quantized(self) -> bool:
        return self.fmt in ("mx8", "int8", "fp8_e4m3", "fp8_e5m2")


def fmt_bits(fmt: str) -> float:
    """Logical stored bits per value of ``fmt``."""
    return F.FORMAT_BITS[fmt]


#: accounting policy for the per-step streamed tensors (as in the JAX
#: package): operands stream in bf16 in production, results leave in f32.
OPERAND_BYTES = 2.0
OUTPUT_BYTES = 4.0


@dataclasses.dataclass(frozen=True)
class TrafficBytes:
    """Logical DRAM bytes one op invocation moves, by stream."""
    state_read: float = 0.0
    state_write: float = 0.0
    operand_read: float = 0.0
    output_write: float = 0.0

    @property
    def state_total(self) -> float:
        return self.state_read + self.state_write

    @property
    def total(self) -> float:
        return (self.state_read + self.state_write
                + self.operand_read + self.output_write)

    def scaled(self, n: float) -> "TrafficBytes":
        return TrafficBytes(self.state_read * n, self.state_write * n,
                            self.operand_read * n, self.output_write * n)

    def __add__(self, o: "TrafficBytes") -> "TrafficBytes":
        return TrafficBytes(self.state_read + o.state_read,
                            self.state_write + o.state_write,
                            self.operand_read + o.operand_read,
                            self.output_write + o.output_write)


#: operand layouts: contiguous per-layer caches, or the paged serving
#: pool's page / slab pools walked through a block table
#: (``repro_torch/core/paged.py``)
LAYOUTS = ("dense", "paged")


@dataclasses.dataclass(frozen=True)
class OpPlan:
    """Immutable, hashable description of one op invocation."""
    kind: str
    backend: str
    fmt: str
    rounding: str
    dims: Tuple[Tuple[str, int], ...]
    options: Tuple[Tuple[str, Any], ...] = ()
    layout: str = "dense"

    def dim(self, name: str) -> int:
        for k, v in self.dims:
            if k == name:
                return v
        raise KeyError(f"plan for {self.kind} has no dim {name!r}; "
                       f"has {[k for k, _ in self.dims]}")

    def opt(self, name: str, default: Any = None) -> Any:
        for k, v in self.options:
            if k == name:
                return v
        return default

    @property
    def bits_per_val(self) -> float:
        return fmt_bits(self.fmt)


class SpuOp:
    """One (kind, backend, layout) operator implementation."""

    kind: str = ""
    backend: str = ""
    formats: Tuple[str, ...] = ()
    layout: str = "dense"

    def plan(self, dims: Mapping[str, int], quant: StateQuantConfig,
             **options) -> OpPlan:
        if quant.fmt not in self.formats:
            raise ValueError(
                f"op {self.kind!r} backend {self.backend!r} does not support "
                f"format {quant.fmt!r} (supports {self.formats})")
        return OpPlan(kind=self.kind, backend=self.backend, fmt=quant.fmt,
                      rounding=quant.rounding,
                      dims=tuple(sorted(dims.items())),
                      options=tuple(sorted(options.items())),
                      layout=self.layout)

    def execute(self, state: Any, inputs: Dict[str, Any],
                plan: OpPlan) -> Tuple[Any, Any]:
        raise NotImplementedError

    def traffic(self, plan: OpPlan) -> TrafficBytes:
        raise NotImplementedError


_DTYPE_FMT = {torch.float32: "fp32", torch.bfloat16: "bf16",
              torch.float16: "fp16"}


def fmt_of_state(state: Any) -> str:
    """Storage format of a state container (QuantizedTensor or tensor)."""
    if isinstance(state, F.QuantizedTensor):
        return state.fmt
    name = _DTYPE_FMT.get(state.dtype)
    if name is None:
        raise ValueError(f"unrecognized unquantized state dtype {state.dtype}")
    return name
