"""DEPRECATED shim -- the generalized state update moved to
``repro_torch.ops`` (the twin of ``repro/core/state_update.py``).

The paper's core abstraction (Eq. 2)

    S_t = d_t ⊙ S_{t-1} + k_t v_tᵀ ;   y_t = S_tᵀ q_t

is a registered SPU operator: see ``repro_torch/ops/state_update.py`` for
the implementations and ``repro_torch/ops/registry.py`` for (kind x
backend x format) dispatch.  This module stays importable so external
scripts keep working:

* ``StateQuantConfig`` / ``StateLike`` / ``init_state`` / ``state_nbytes``
  re-export the canonical ``repro_torch.ops`` objects (no warning -- they
  are configuration, not dispatch).
* ``state_update_step`` still works but emits
  :class:`~repro_torch.ops.base.SpuDeprecationWarning` and forwards to
  ``repro_torch.ops.state_update_step`` (the same registered op).
"""
from __future__ import annotations

import warnings
from typing import Tuple

import torch

from repro_torch.ops.base import (SpuDeprecationWarning,  # noqa: F401
                                  StateQuantConfig)
from repro_torch.ops.state_update import (StateLike, init_state,  # noqa: F401
                                          state_nbytes)

__all__ = ["StateQuantConfig", "StateLike", "init_state", "state_nbytes",
           "state_update_step"]


def state_update_step(state: StateLike, d: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, q: torch.Tensor,
                      cfg: StateQuantConfig, seed: int = 0
                      ) -> Tuple[StateLike, torch.Tensor]:
    """Deprecated: use :func:`repro_torch.ops.state_update_step`."""
    warnings.warn(
        "repro_torch.core.state_update.state_update_step is deprecated; use "
        "repro_torch.ops.state_update_step (registry-dispatched SPU op)",
        SpuDeprecationWarning, stacklevel=2)
    from repro_torch.ops.state_update import state_update_step as _step
    return _step(state, d, k, v, q, cfg, seed=seed)
