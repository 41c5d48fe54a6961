"""Tensor parallelism's pieces that the models use: which layers a model
axis splits, a rank's share of them, the forward path's one collective,
and the cut of a weight.  It imports nothing of the models: each mixer
keeps its own cut next to the code that reshapes by heads
(``models/attention.py::tp_shard`` / ``mla_tp_shard``,
``models/ssm.py::TP_SHARDS``, ``models/layers.py::ffn_tp_shard``), and ``dist/sharding.py::tp_params``
walks a parameter tree and calls them.

``par`` is a ``dist.sharding.Parallel`` (``tp``, ``model_index`` and
``model_group`` are all these functions read) or None.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def layer_par(n: int, par):
    """``par`` where its model axis splits a layer of ``n`` heads (kv heads
    of a GQA layer, query heads of an MLA layer, the heads of a Mamba-2,
    GLA-family or mLSTM layer, a dense FFN's columns): tp > 1 divides
    ``n``.  Else None: the layer is whole on every rank, JAX's own
    fallback for an indivisible head count (``repro/models/ssm.py``'s
    ``shard_heads``)."""
    if par is None or par.tp == 1 or n % par.tp:
        return None
    return par


def tp_range(n: int, par) -> Tuple[int, int]:
    """``(first, count)``: this rank's share of a layer's ``n`` heads or
    columns (all ``n`` where :func:`layer_par` is None)."""
    lp = layer_par(n, par)
    if lp is None:
        return 0, n
    count = n // lp.tp
    return lp.model_index * count, count


def local_share(n: int, par) -> Tuple[int, int, Optional[object]]:
    """``(count, first, lp)``: this rank's share of a layer's ``n`` heads,
    its first head, and ``par`` where the model axis splits them (else
    None: all ``n``, from 0)."""
    lp = layer_par(n, par)
    first, count = tp_range(n, lp)
    return count, first, lp


def tp_sum(x: torch.Tensor, par) -> torch.Tensor:
    """The forward path's one collective: ``x`` summed over the model
    group, one all-reduce (a row-parallel product's partial sums; the
    gated norm's sums of squares).  The identity without ``par`` or at tp
    = 1.  Every rank of the group gets the same bits."""
    if par is None or par.tp == 1:
        return x
    from repro_torch.dist.compat import funcol
    return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), "sum",
                                                par.model_group))


def expert_parallel(cfg, par: Optional[object]) -> bool:
    """Whether ``apply_moe`` runs expert-parallel over the model axis."""
    return (par is not None and getattr(cfg, "moe", None) is not None
            and par.tp > 1 and cfg.moe.n_experts % par.tp == 0)


def narrow(w: torch.Tensor, dim: int, first: int,
           count: int) -> torch.Tensor:
    """Entries ``first`` to ``first + count - 1`` of ``w`` along ``dim``,
    as a contiguous copy: dropping the whole tensor frees it."""
    return w.narrow(dim, first, count).clone(
        memory_format=torch.contiguous_format)
