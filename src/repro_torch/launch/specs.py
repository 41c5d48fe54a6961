"""Shape-only stand-ins for every model input: the dry run's contract (the
port's copy of ``repro/launch/specs.py``).

Each builder returns tensors on the ``meta`` device, of the shapes and
dtypes of the JAX package's ``ShapeDtypeStruct`` trees (token ids int32,
frontend inputs bf16): no storage is ever allocated, at any model size.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig, ShapeConfig


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(cfg: ModelConfig, sc: ShapeConfig,
                 dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Inputs of train / prefill steps."""
    B, S = sc.global_batch, sc.seq_len
    i32 = torch.int32
    if cfg.family == "vlm":
        S_text = S - cfg.prefix_len
        return {"patches": _meta((B, cfg.prefix_len, cfg.frontend_dim),
                                 dtype),
                "tokens": _meta((B, S_text), i32),
                "targets": _meta((B, S_text), i32)}
    if cfg.family == "audio":
        return {"frames": _meta((B, S, cfg.frontend_dim), dtype),
                "targets": _meta((B, S), i32)}
    return {"tokens": _meta((B, S), i32), "targets": _meta((B, S), i32)}


def decode_struct(cfg: ModelConfig, sc: ShapeConfig) -> Tuple:
    """(tokens, lengths, caches) for a decode step with a warm cache of
    ``sc.seq_len`` positions (capacity rounded up to the 128-token tile)."""
    B = sc.global_batch
    cap = -(-sc.seq_len // 128) * 128
    return (_meta((B,), torch.int32), _meta((B,), torch.int32),
            M.init_decode_caches(cfg, B, cap, device="meta"))


def params_struct(cfg: ModelConfig, seed: int = 0) -> Any:
    """The parameter tree on ``meta``: ``init_model`` with a CPU generator
    (a ``meta`` generator does not exist; nothing is drawn on ``meta``)."""
    return M.init_model(cfg, torch.Generator().manual_seed(seed),
                        device="meta")
