"""DEPRECATED shim -- kernel entry points moved to the ``repro_torch.ops``
registry (the twin of ``repro/kernels/ops.py``).

The ``backend=`` keyword dispatch that used to live here is capability
negotiation in ``repro_torch/ops/registry.py`` (op kind x backend x
format), and the implementations are registered SpuOps in
``repro_torch/ops/state_update.py`` and ``repro_torch/ops/attention.py``.
These wrappers keep external scripts working: they emit
:class:`~repro_torch.ops.base.SpuDeprecationWarning` and forward to the
registry, returning bit-identical results.
"""
from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch

from repro_torch.core import formats as F
from repro_torch.ops.base import SpuDeprecationWarning, StateQuantConfig

DEFAULT_BACKEND = "cuda"


def _warn(old: str, new: str):
    warnings.warn(f"repro_torch.kernels.ops.{old} is deprecated; use {new}",
                  SpuDeprecationWarning, stacklevel=3)


def state_update(qS: F.QuantizedTensor, d: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, q: torch.Tensor, seed, *,
                 rounding: str = "stochastic",
                 backend: str = DEFAULT_BACKEND
                 ) -> Tuple[F.QuantizedTensor, torch.Tensor]:
    """Deprecated: use repro_torch.ops.state_update_step."""
    _warn("state_update", "repro_torch.ops.state_update_step")
    from repro_torch import ops as OPS
    cfg = StateQuantConfig(fmt=qS.fmt, rounding=rounding, backend=backend)
    return OPS.state_update_step(qS, d, k, v, q, cfg, seed=seed)


def state_update_float(S: torch.Tensor, d, k, v, q, dtype=torch.bfloat16
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deprecated: use repro_torch.kernels.ref.state_update_float."""
    _warn("state_update_float", "repro_torch.kernels.ref.state_update_float")
    from repro_torch.kernels.ref import state_update_float as _f
    return _f(S, d, k, v, q, dtype=dtype)


def attention_decode(q: torch.Tensor, qK: F.QuantizedTensor,
                     qV: Optional[F.QuantizedTensor], lengths: torch.Tensor,
                     *, scale: Optional[float] = None,
                     v_width: Optional[int] = None,
                     backend: str = DEFAULT_BACKEND) -> torch.Tensor:
    """Deprecated: use repro_torch.ops.attn_decode on a KVCache."""
    _warn("attention_decode", "repro_torch.ops.attn_decode")
    from repro_torch.core.attention_cache import KVCache
    from repro_torch.ops.attention import attn_decode
    cache = KVCache(qK, qV, lengths, qK.fmt, v_width)
    cfg = StateQuantConfig(fmt=qK.fmt, rounding="nearest", backend=backend)
    return attn_decode(cache, q, cfg, scale=scale)


def quantize_mx8(x: torch.Tensor, seed=0, *, rounding: str = "nearest",
                 backend: str = DEFAULT_BACKEND) -> F.QuantizedTensor:
    """Deprecated: use repro_torch.core.formats.quantize /
    kernels.mx_quant."""
    _warn("quantize_mx8", "repro_torch.core.formats.quantize")
    if backend == "cuda":
        from repro_torch.kernels.mx_quant import mx_quantize
        return mx_quantize(x, seed, rounding=rounding)
    from repro_torch.kernels import ref as _ref
    return _ref.mx_quantize_ref(x, rounding=rounding, seed=seed)
