"""AdamW with global-norm clipping and a cosine schedule with warmup (the
port's copy of ``repro/train/optimizer.py``): moments in
``moment_dtype`` (fp32 by default), the step an int32 scalar tensor, and
every quantity on the parameters' device, so a step reads nothing back to
the host.  Weight decay is decoupled and skips the leaves whose name
matches the JAX package's substrings (:func:`_decay_mask`)."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import tree as T


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"


def schedule(opt: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_frac * lr``
    at ``total_steps`` (fp32, as the JAX package computes it)."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(opt.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - opt.warmup_steps)
                       / max(opt.total_steps - opt.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = opt.min_lr_frac + (1 - opt.min_lr_frac) * cos
    return opt.lr * warm * frac


def init_opt_state(params: Any, opt: OptimizerConfig) -> Dict[str, Any]:
    mdt = getattr(torch, opt.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    device = T.leaves(params)[0].device
    return {"m": T.tree_map(zeros, params), "v": T.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in T.leaves(tree)))


_NO_DECAY = ("scale", "bias", "A_log", "D", "dt_bias", "fb", "gb", "beta",
             "b")


def _decay_mask(path) -> bool:
    """Whether the leaf at ``path`` takes weight decay: the JAX package's
    rule (no decay on norms, biases and scalar gate parameters), which
    matches these substrings in ``str(path[-1])`` of its tree path --
    ``"['embed']"`` for a dict key, so ``"b"`` also spares ``embed``,
    ``wbc``, ``conv_bc_w`` and ``wgb``, and ``"D"`` spares ``D``.  The
    port names a leaf the same way from its dict key (``[i]`` from a list
    index), so the two packages decay the same leaves."""
    if not path:
        return True
    key = path[-1]
    name = f"[{key!r}]" if isinstance(key, str) else f"[{key}]"
    return not any(t in name for t in _NO_DECAY)


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: Dict[str, Any],
                 opt: OptimizerConfig, grad_norm: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: (new params, new state, {"grad_norm", "lr"}).  The
    gradients are clipped to ``clip_norm`` by their global norm before they
    enter the moments; the moments are bias-corrected; decay is decoupled
    (``p -= lr * wd * p``, on the leaves :func:`_decay_mask` picks).  Where
    the trees are a rank's shards, ``grad_norm`` is the whole tree's norm
    (``dist/sharding.py::global_norm``); by default the norm of ``grads``."""
    step = state["step"] + 1
    lr = schedule(opt, step)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    clip = torch.clamp(opt.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2 = opt.b1, opt.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    mdt = getattr(torch, opt.moment_dtype)
    new_p, new_m, new_v = [], [], []
    for (path, p), g, m, v in zip(T.leaves_with_paths(params),
                                  T.leaves(grads), T.leaves(state["m"]),
                                  T.leaves(state["v"])):
        g = g.to(torch.float32) * clip
        m_new = b1 * m.to(torch.float32) + (1 - b1) * g
        v_new = b2 * v.to(torch.float32) + (1 - b2) * torch.square(g)
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + opt.eps)
        if _decay_mask(path):
            delta = delta + opt.weight_decay * p.to(torch.float32)
        new_p.append((p.to(torch.float32) - lr * delta).to(p.dtype))
        new_m.append(m_new.to(mdt))
        new_v.append(v_new.to(mdt))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return (T.unflatten(params, new_p),
            {"m": T.unflatten(params, new_m), "v": T.unflatten(params, new_v),
             "step": step}, metrics)
