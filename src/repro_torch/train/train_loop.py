"""Train-step factory and the fault-tolerant training loop (the port's copy
of ``repro/train/train_loop.py``): on one device, or on a mesh
(``dist/sharding.py``: ZeRO-sharded data parallelism, tensor parallelism
with sequence parallelism, expert-parallel MoE)."""
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
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))
        if k in ("tokens", "targets"):
            t = t.long()
        out[k] = t.to(device)
    return out


def _loss_and_grads(params, cfg: ModelConfig, batch, weight=None,
                    par=None, whole_batch: bool = False):
    """(loss, gradient tree) of ``M.train_loss`` at ``params``, times
    ``weight`` where one is given; a leaf the loss does not reach gets a
    zero gradient, as under ``jax.grad``."""
    leaves = [p.detach().requires_grad_(True) for p in T.leaves(params)]
    loss = M.train_loss(T.unflatten(params, leaves), cfg, batch, par=par,
                        whole_batch=whole_batch)
    if weight is not None:
        loss = loss * weight
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), T.unflatten(params, grads)


def _split(batch, grad_accum: int, D: int = 1, r: int = 0):
    """Microbatch ``i`` is rows ``i * B/ga .. (i + 1) * B/ga`` of the batch
    (the JAX package's scan); data shard ``r`` of ``D`` takes its rows of
    each (the JAX package's ``to_micro``)."""
    B = next(iter(batch.values())).shape[0]
    if B % (grad_accum * D):
        raise ValueError(f"batch {B} does not split into {grad_accum} "
                         f"microbatches" + (f" over {D} data shards"
                                            if D > 1 else ""))
    n = B // grad_accum
    per = n // D
    return [{k: v[i * n + r * per:i * n + (r + 1) * per]
             for k, v in batch.items()} for i in range(grad_accum)]


def _microbatches(batch, device, par, grad_accum: int):
    """(the microbatches this rank runs, the weight of each one's loss,
    whether the rank holds the whole batch).

    Without ``par``: the batch (or its :func:`_split`), weights None.
    With ``par`` a rank takes its rows of each microbatch, so masked means
    take the same rows as JAX's; a batch of DTensors in its layout at
    ``grad_accum == 1`` is already the rank's rows (every row, where the
    data axes do not divide the batch and its layout replicates it),
    otherwise it is gathered first.  JAX's loss is the masked mean over
    the global batch, so a rank's loss is weighted by its share of the
    microbatch's mask count (1.0 on one rank)."""
    if par is None:
        batch = batch_to_device(batch, device)
        micro = [batch] if grad_accum == 1 else _split(batch, grad_accum)
        return micro, [None] * grad_accum, True
    from repro_torch.dist import sharding as SH
    D, r = par.batch_size_divisor, par.data_index()
    whole = D == 1
    if not any(isinstance(x, SH.DTensor) for x in T.leaves(batch)):
        micro = _split(batch_to_device(batch, device), grad_accum, D, r)
    elif grad_accum == 1 and all(
            tuple(x.placements) == SH.batch_shardings(x, par).placements
            for x in T.leaves(batch)):
        micro = [SH.gather(batch, par.batch_axes)]
        B = next(iter(T.leaves(batch))).shape[0]
        whole = SH.split_rows(micro[0]["targets"].shape[0], B, par) is None
    else:
        micro = _split(SH.gather(batch), grad_accum, D, r)
    counts = torch.stack([
        (mb["mask"].to(torch.float32).sum() if "mask" in mb else
         torch.tensor(float(mb["targets"].numel()), device=device))
        for mb in micro])
    return (micro, counts / torch.clamp(_over_data(counts, par), min=1.0),
            whole)


def _over_data(t: torch.Tensor, par) -> torch.Tensor:
    """``t`` (each rank's own) summed over the data axes of ``par``."""
    from repro_torch.dist import sharding as SH
    mesh, data = par.mesh, set(par.data_axes)
    return SH.DTensor.from_local(t, mesh, tuple(
        SH.Partial() if n in data else SH.Replicate()
        for n in mesh.mesh_dim_names), run_check=False).full_tensor()


def sharded_loss_and_grads(params, cfg: ModelConfig, batch, par,
                           grad_accum: int = 1):
    """(the global loss, the gradients as local shards in ``params``'
    layouts) of one step over ``par``'s mesh: each rank takes its
    tensor-parallel cut of ``params`` (DTensors: ``dist/sharding.py::
    cut_params``), runs the microbatches of its rows
    (:func:`_microbatches`, each loss weighted so that the ranks' sum is
    the global masked mean) forward and backward through the
    tensor-parallel step (``M.train_loss(..., par)``: every gradient whole
    for the cut on each model rank), and sums the gradients over the data
    axes into the parameter layout (``reduce_grads``)."""
    from repro_torch.dist import sharding as SH
    device = torch.device(par.mesh.device_type)
    micro, weights, whole = _microbatches(batch, device, par, grad_accum)
    local = SH.cut_params(params, cfg, par)
    loss, grads = _accumulate(local, cfg, micro, weights, par, whole)
    del local
    return (_over_data(loss, par),
            SH.reduce_grads(grads, params, cfg, par))


def _accumulate(params, cfg, micro, weights, par, whole_batch=False):
    """(loss, gradients) of the microbatches ``micro``: summed, then
    divided by their count (the JAX package's scan)."""
    if len(micro) == 1:
        return _loss_and_grads(params, cfg, micro[0], weights[0], par,
                               whole_batch)
    device = micro[0]["targets"].device
    loss = torch.zeros((), dtype=torch.float32, device=device)
    grads = T.tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=device), params)
    for mb, w in zip(micro, weights):
        loss_i, grads_i = _loss_and_grads(params, cfg, mb, w, par,
                                          whole_batch)
        loss = loss + loss_i
        grads = T.tree_map(torch.add, grads, grads_i)
    n = len(micro)
    return loss / n, T.tree_map(lambda g: g / n, grads)


def make_train_step(cfg: ModelConfig, opt: O.OptimizerConfig, par=None,
                    grad_accum: int = 1) -> Callable:
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics).  ``batch`` is a pipeline batch (numpy) or tensors; it moves to
    the parameters' device.  With ``grad_accum > 1`` the batch splits into
    that many microbatches along its first axis, run one after another:
    their losses and gradients are summed, then divided by ``grad_accum``
    (the JAX package's scan).

    With ``par`` (a ``dist.sharding.Parallel``) the step runs over a mesh,
    eagerly: parameters and AdamW moments are DTensors in the parameter
    layout (ZeRO), the step counter replicated; the batch too may be.
    Each rank computes on its tensor-parallel cut of the parameters and
    its rows (:func:`sharded_loss_and_grads`), then runs AdamW on its
    shards with the global gradient norm.  On a one-rank mesh that is the
    single-device step's arithmetic exactly."""
    if par is not None:
        from repro_torch.dist import sharding as SH

    def step(params, opt_state, batch):
        if par is None:
            micro, weights, _ = _microbatches(
                batch, M.params_device(params), None, grad_accum)
            loss, grads = _accumulate(params, cfg, micro, weights, None)
            params, opt_state, metrics = O.adamw_update(params, grads,
                                                        opt_state, opt)
            return params, opt_state, dict(metrics, loss=loss)
        loss, grads = sharded_loss_and_grads(params, cfg, batch, par,
                                             grad_accum)
        new_p, new_s, metrics = O.adamw_update(
            SH.local_shards(params), grads, SH.local_shards(opt_state), opt,
            grad_norm=SH.global_norm(grads, params))
        return (SH.like(new_p, params), SH.like(new_s, opt_state),
                dict(metrics, loss=loss))

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
