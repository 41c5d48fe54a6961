"""Train-step factory and the fault-tolerant training loop (the port's copy
of ``repro/train/train_loop.py``, on one device)."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.core import tree as T
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as O


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A pipeline batch (numpy arrays) as tensors on ``device``: token ids
    as int64, everything else as it is."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if k in ("tokens", "targets"):
            t = t.long()
        out[k] = t.to(device)
    return out


def _loss_and_grads(params, cfg: ModelConfig, batch):
    """(loss, gradient tree) of ``M.train_loss`` at ``params``; a leaf the
    loss does not reach gets a zero gradient, as under ``jax.grad``."""
    leaves = [p.detach().requires_grad_(True) for p in T.leaves(params)]
    loss = M.train_loss(T.unflatten(params, leaves), cfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), T.unflatten(params, grads)


def make_train_step(cfg: ModelConfig, opt: O.OptimizerConfig,
                    grad_accum: int = 1) -> Callable:
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics).  ``batch`` is a pipeline batch (numpy) or tensors; it moves to
    the parameters' device.  With ``grad_accum > 1`` the batch splits into
    that many microbatches along its first axis, run one after another:
    their losses and gradients are summed, then divided by ``grad_accum``
    (the JAX package's scan)."""

    def step(params, opt_state, batch):
        batch = batch_to_device(batch, M.params_device(params))
        if grad_accum == 1:
            loss, grads = _loss_and_grads(params, cfg, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % grad_accum:
                raise ValueError(f"batch {B} does not split into "
                                 f"{grad_accum} microbatches")
            n = B // grad_accum
            loss = torch.zeros((), dtype=torch.float32,
                               device=M.params_device(params))
            grads = T.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(grad_accum):
                micro = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                loss_i, grads_i = _loss_and_grads(params, cfg, micro)
                loss = loss + loss_i
                grads = T.tree_map(torch.add, grads, grads_i)
            loss = loss / grad_accum
            grads = T.tree_map(lambda g: g / grad_accum, grads)
        params, opt_state, metrics = O.adamw_update(params, grads, opt_state,
                                                    opt)
        return params, opt_state, dict(metrics, loss=loss)

    return step


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    # straggler / fault watchdog: steps slower than watchdog_factor x the
    # running median are logged; the loop itself never blocks on it
    watchdog_factor: float = 3.0


def train_loop(step_fn: Callable, params, opt_state, data_iter,
               loop: LoopConfig, checkpoint_mgr=None, start_step: int = 0,
               log=print) -> Tuple[Any, Any, list]:
    """Fault-tolerant loop: periodic atomic checkpoints, resumable data
    order (``data_iter`` is step-indexed), straggler watchdog.  A step's
    time runs until its loss is read back to the host (the JAX loop's
    ``block_until_ready``).  Returns (params, opt_state, the losses)."""
    history, times = [], []
    for step in range(start_step, loop.total_steps):
        batch = data_iter(step)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        times.append(dt)
        med = sorted(times)[len(times) // 2]
        if dt > loop.watchdog_factor * med and len(times) > 5:
            log(f"[watchdog] step {step} took {dt:.3f}s "
                f"(median {med:.3f}s) -- straggler suspected")
        if step % loop.log_every == 0:
            log(f"step {step}: loss={loss:.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} "
                f"lr={float(metrics['lr']):.2e} ({dt*1e3:.0f} ms)")
        history.append(loss)
        if checkpoint_mgr is not None \
                and (step + 1) % loop.checkpoint_every == 0:
            t0 = time.perf_counter()
            checkpoint_mgr.save(step + 1, params, opt_state)
            log(f"checkpoint step {step + 1} in "
                f"{time.perf_counter() - t0:.1f} s")
    return params, opt_state, history
