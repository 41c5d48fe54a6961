"""Deterministic, resumable synthetic data pipeline (the port's copy of
``repro/data/pipeline.py``; numpy only, so a batch is bitwise the JAX
package's).

  * **step-indexed**: ``batch(step)`` is a pure function of (seed, step),
    so a restarted job resumes mid-epoch with no pipeline state to
    checkpoint and the same data order.
  * **shard-aware**: each data-parallel host can materialize only its
    slice (``host``, ``n_hosts``).
  * **structured synthetic text**: tokens follow a Zipfian unigram mixed
    with a copy / induction pattern, so a language model has structure to
    learn (its loss falls well below the uniform entropy).

Batches are numpy arrays; the train step moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.2
    copy_period: int = 64      # induction-head structure


def _rng(cfg: DataConfig, step: int, host: int = 0) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, host]))


def _zipf_probs(cfg: DataConfig) -> np.ndarray:
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    p = ranks ** (-cfg.zipf_a)
    return p / p.sum()


class SyntheticLM:
    """batch(step) -> {'tokens', 'targets', 'mask'} with LM structure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._probs = _zipf_probs(cfg)

    def batch(self, step: int, host: int = 0, n_hosts: int = 1
              ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {n_hosts} hosts")
        b = cfg.global_batch // n_hosts
        rng = _rng(cfg, step, host)
        toks = rng.choice(cfg.vocab_size, size=(b, cfg.seq_len + 1),
                          p=self._probs).astype(np.int32)
        # copy structure: the second half of each period repeats the first
        P = cfg.copy_period
        half = P // 2
        for i in range((cfg.seq_len + 1) // P):
            s = i * P
            toks[:, s + half:s + P] = toks[:, s:s + half]
        return {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:],
            "mask": np.ones((b, cfg.seq_len), np.float32),
        }


def make_batch_fn(model_cfg: ModelConfig, seq_len: int, global_batch: int,
                  seed: int = 0):
    """Step-indexed batch function for any model family (the train loop's
    input): a VLM's batch adds seeded ``patches`` before ``seq_len -
    prefix_len`` text tokens, an audio model's is ``frames`` with the
    masked-prediction objective's ~8 % mask."""
    if model_cfg.family == "vlm":
        s_text = seq_len - model_cfg.prefix_len
        lm = SyntheticLM(DataConfig(s_text, global_batch,
                                    model_cfg.vocab_size, seed))

        def fn(step: int):
            b = lm.batch(step)
            rng = _rng(lm.cfg, step, host=999)
            b["patches"] = rng.standard_normal(
                (global_batch, model_cfg.prefix_len,
                 model_cfg.frontend_dim)).astype(np.float32)
            return b
        return fn
    if model_cfg.family == "audio":
        lm = SyntheticLM(DataConfig(seq_len, global_batch,
                                    model_cfg.vocab_size, seed))

        def fn(step: int):
            b = lm.batch(step)
            rng = _rng(lm.cfg, step, host=998)
            frames = rng.standard_normal(
                (global_batch, seq_len, model_cfg.frontend_dim)
            ).astype(np.float32)
            mask = (rng.random((global_batch, seq_len)) < 0.08
                    ).astype(np.float32)
            return {"frames": frames, "targets": b["targets"], "mask": mask}
        return fn
    lm = SyntheticLM(DataConfig(seq_len, global_batch,
                                model_cfg.vocab_size, seed))
    return lambda step: lm.batch(step)
