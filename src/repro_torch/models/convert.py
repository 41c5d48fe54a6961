"""Carry parameters from the JAX package's layout into the port's.

``params_from_jax(tree, cfg, device)`` takes the JAX parameter tree already
converted to numpy (``jax.tree.map(np.asarray, init_model(key, cfg))``):
it unstacks the ``(G, ...)`` group axis of ``groups[pos]`` into the port's
per-layer lists (MoE experts keep their ``(E, d_in, d_out)`` stacks),
lists the unstacked ``prelude`` layers, and copies ``embed`` (absent for
an audio frontend), ``frontend_proj`` (a frontend's projection), ``pos`` (a
learned position table), ``shared``, ``final_norm`` and ``lm_head`` (absent
when the embedding is tied) leaf for leaf.  Nothing here imports JAX; the
tree is plain dicts, tuples and numpy arrays.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import check_supported, resolve_device


def _to_torch(tree: Any, device, index=None) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, index) for k, v in tree.items()}
    a = np.asarray(tree)
    if index is not None:
        a = a[index]
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The port's parameter dict holding the same numbers as ``tree``."""
    check_supported(cfg)
    device = resolve_device(device)
    out = {"groups": [[_to_torch(tree["groups"][pos], device, index=g)
                       for pos in range(len(cfg.pattern))]
                      for g in range(cfg.n_groups)]}
    if cfg.prelude:
        out["prelude"] = [_to_torch(layer, device)
                          for layer in tree["prelude"]]
    for name in ("embed", "frontend_proj", "pos", "shared", "final_norm",
                 "lm_head"):
        if name in tree:
            out[name] = _to_torch(tree[name], device)
    return out
