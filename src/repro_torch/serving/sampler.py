"""Token samplers for the serving engine (PyTorch port of
``repro/serving/sampler.py``): greedy, temperature, top-k and top-p, with
draws from an explicit ``torch.Generator``.  Greedy picks the first maximal
logit, as ``jnp.argmax`` does; sampled draws differ from the JAX package's
(another generator)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0       # 0 => greedy
    top_k: int = 0                 # 0 => full distribution
    top_p: float = 1.0             # 1.0 => no nucleus truncation


def _apply_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Keep the smallest prefix of the sorted distribution whose mass
    reaches ``top_p`` (the argmax always survives)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p
    keep[..., 0] = True
    thr = torch.where(keep, sorted_logits,
                      torch.full_like(sorted_logits, float("inf"))
                      ).amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < thr, float("-inf"))


def filtered_logits(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    """Temperature / top-k / top-p filtered logits (temperature > 0)."""
    logits = logits.to(torch.float32) / cfg.temperature
    if cfg.top_k > 0:
        kth = torch.topk(logits, cfg.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if cfg.top_p < 1.0:
        logits = _apply_top_p(logits, cfg.top_p)
    return logits


def filtered_probs(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    """Post-filter sampling distribution over the last axis: the
    temperature / top-k / top-p chain of :func:`sample`, stopped before the
    draw.  The speculative engine needs the distribution itself for its
    host-side rejection sampling.  Greedy (temperature <= 0) is a point
    mass on the argmax."""
    if cfg.temperature <= 0.0:
        return torch.nn.functional.one_hot(
            torch.argmax(logits, dim=-1), logits.shape[-1]).to(torch.float32)
    return torch.softmax(filtered_logits(logits, cfg), dim=-1)


def sample(logits: torch.Tensor, cfg: SamplingConfig,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits (B, V) -> tokens (B,) int64 on the logits' device."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filtered_logits(logits, cfg), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
