"""The SPU operator registry: (op kind x backend x format x layout) dispatch.

The PyTorch twin of ``repro/ops/registry.py``.  Call sites ask
:func:`resolve_backend` for a capable backend (preferring the CUDA kernels
where one is registered for the format) or demand an exact quadruple with
``strict=True``, which raises listing what *is* registered.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.ops.base import LAYOUTS, OpPlan, SpuOp, StateQuantConfig, \
    TrafficBytes

OP_KINDS = ("state_update", "attn_decode", "mla_decode", "kv_append",
            "spec_verify")

#: backend preference for capability negotiation ("auto" requests)
BACKEND_PREFERENCE = ("cuda", "torch")

_REGISTRY: Dict[Tuple[str, str, str, str], SpuOp] = {}


def register(op) -> SpuOp:
    """Register one implementation under every format it supports
    (instance or class; usable as a class decorator)."""
    inst = op() if isinstance(op, type) else op
    if inst.kind not in OP_KINDS:
        raise ValueError(f"unknown op kind {inst.kind!r}; kinds: {OP_KINDS}")
    if inst.layout not in LAYOUTS:
        raise ValueError(
            f"unknown op layout {inst.layout!r}; layouts: {LAYOUTS}")
    for fmt in inst.formats:
        key = (inst.kind, inst.backend, fmt, inst.layout)
        cur = _REGISTRY.get(key)
        if cur is not None and (type(cur).__module__, type(cur).__qualname__) \
                != (type(inst).__module__, type(inst).__qualname__):
            raise ValueError(
                f"op quadruple {key} already registered by "
                f"{type(cur).__qualname__}; refusing to overwrite with "
                f"{type(inst).__qualname__}")
        _REGISTRY[key] = inst
    return op


def registered() -> List[Tuple[str, str, str, str]]:
    """Sorted (kind, backend, fmt, layout) quadruples currently registered."""
    return sorted(_REGISTRY)


def backends_for(kind: str, fmt: str, layout: str = "dense") -> List[str]:
    """Capable backends for (kind, fmt, layout), in preference order."""
    found = {b for (k, b, f, lo) in _REGISTRY
             if k == kind and f == fmt and lo == layout}
    ordered = [b for b in BACKEND_PREFERENCE if b in found]
    return ordered + sorted(found - set(ordered))


def _describe(kind: Optional[str] = None) -> str:
    rows = [t for t in registered() if kind is None or t[0] == kind]
    if not rows:
        return "(registry is empty)"
    return ", ".join(f"{k}[{b}:{f}:{lo}]" for k, b, f, lo in rows)


def resolve_backend(kind: str, fmt: str, requested: Optional[str] = None,
                    *, layout: str = "dense", strict: bool = False) -> str:
    """Capability negotiation for one (kind, fmt, layout)."""
    capable = backends_for(kind, fmt, layout)
    if not capable:
        raise ValueError(
            f"no backend registered for op {kind!r} with format {fmt!r} "
            f"layout {layout!r}; registered ops: {_describe()}")
    if requested in (None, "auto"):
        return capable[0]
    if requested in capable:
        return requested
    if strict:
        raise ValueError(
            f"backend {requested!r} is not registered for op {kind!r} with "
            f"format {fmt!r} layout {layout!r} (capable: {capable}); "
            f"registered ops: {_describe(kind)}")
    return capable[0]


def get_op(kind: str, backend: str, fmt: str,
           layout: str = "dense") -> SpuOp:
    try:
        return _REGISTRY[(kind, backend, fmt, layout)]
    except KeyError:
        raise KeyError(
            f"op {kind!r} backend {backend!r} format {fmt!r} layout "
            f"{layout!r} is not registered; registered ops: "
            f"{_describe(kind)}") from None


def plan(kind: str, dims, quant: StateQuantConfig,
         backend: Optional[str] = None, *, layout: str = "dense",
         strict: bool = False, **options) -> OpPlan:
    """Resolve a backend for (kind, quant.fmt, layout) and build the plan."""
    b = resolve_backend(kind, quant.fmt, backend, layout=layout,
                        strict=strict)
    return get_op(kind, b, quant.fmt, layout).plan(dims, quant, **options)


def execute(state, inputs, p: OpPlan):
    """Dispatch one planned invocation to its registered implementation."""
    return get_op(p.kind, p.backend, p.fmt, p.layout).execute(state, inputs, p)


def traffic(p: OpPlan) -> TrafficBytes:
    """The registered op's own traffic descriptor for ``p``."""
    return get_op(p.kind, p.backend, p.fmt, p.layout).traffic(p)
