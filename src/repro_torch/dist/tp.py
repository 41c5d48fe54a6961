"""Tensor parallelism's pieces that the models use: which layers a model
axis splits, a rank's share of them, the collectives around a split
region, and the cut of a weight.  It imports nothing of the models: each
mixer keeps its own cut next to the code that reshapes by heads
(``models/attention.py::tp_shard`` / ``mla_tp_shard``,
``models/ssm.py::TP_SHARDS``, ``models/layers.py::ffn_tp_shard``), and
``dist/sharding.py::tp_params`` walks a parameter tree and calls them.

``par`` is a ``dist.sharding.Parallel`` (``tp``, ``model_index``,
``model_group``, ``seq`` and, for the data rows, ``data_axes``,
``batch_size_divisor`` and ``data_index`` are all these functions read)
or None.

The collectives are Megatron's, each with the backward its site needs, so
that training on a rank's cut gives every leaf its whole gradient, the
same on every model rank (a shard where the weight is cut, the whole
where it is not):

* :func:`tp_sum` -- *g*, a row-parallel product's partial sums, consumed
  replicated: forward all-reduce, backward identity.  Under sequence
  parallelism (``par.seq``) its sequence form: forward reduce-scatter of
  the positions, backward all-gather.
* :func:`tp_sum_split` -- a sum whose consumers are split (the gated
  norm's sum of squares, the mLSTM's gate pre-activations): forward
  all-reduce, backward all-reduce.
* :func:`tp_copy` -- *f*, a replicated value entering split consumers:
  forward identity, backward all-reduce.
* :func:`tp_enter` -- a layer's normed input: *f* on the branch that
  feeds column-parallel weights; under sequence parallelism the input
  was gathered by :func:`seq_gather` (whose backward sums the ranks'
  partial gradients), and the branch that feeds whole weights keeps its
  gradient on model rank 0 alone, so that sum counts it once.
* :func:`seq_gather` / :func:`seq_whole` / :func:`seq_local` -- the
  residual stream's positions over the model axis (Megatron-SP).
* :func:`rows_whole` / :func:`rows_local` -- a batch's rows over the data
  axes (an MoE that routes the whole batch).

Every all-gather is c10d's into one buffer (``compat.all_gather_single``),
on every backend: gloo's functional all-gather of a CUDA tensor crashes
the process (PyTorch 2.11), c10d's does not.  With ``par`` None, or at
tp = 1, each is the identity.
"""
from __future__ import annotations

import dataclasses
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


def _split(par) -> bool:
    """Whether ``par`` splits anything over its model axis."""
    return par is not None and par.tp > 1


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    from repro_torch.dist.compat import funcol
    return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), "sum",
                                                group))


def _pad(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    """``x`` at part ``i`` of ``n`` along ``dim``, zeros elsewhere."""
    shape = list(x.shape)
    shape[dim] *= n
    out = x.new_zeros(shape)
    out.narrow(dim, i * x.shape[dim], x.shape[dim]).copy_(x)
    return out


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` of ``group`` put together along ``dim`` in the
    group's rank order: one all-gather into a buffer of the parts stacked
    along dim 0, moved into place."""
    from repro_torch.dist.compat import all_gather_single
    import torch.distributed as dist
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    all_gather_single(out, x, group=group)
    if dim == 0:
        return out
    shape = list(x.shape)
    shape[dim] *= n
    return out.view((n,) + tuple(x.shape)).movedim(0, dim).reshape(shape)


def _gather(x: torch.Tensor, dim: int, groups) -> torch.Tensor:
    """The parts of ``x`` along ``dim`` put together over ``groups``
    (mesh axes, major to minor, as ``Parallel.data_index`` numbers a
    rank's part): gathered over the minor axis first."""
    for g in reversed(groups):
        x = _all_gather(x, dim, g)
    return x


def _part(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    """Part ``i`` of ``n`` of ``x`` along ``dim``, as its own tensor."""
    s = x.shape[dim] // n
    return narrow(x, dim, i * s, s)


def model_gather(x: torch.Tensor, dim: int, par) -> torch.Tensor:
    """A rank's part of a tensor split along ``dim`` over the model axis,
    put together (the same bits on every rank); the backward keeps the
    rank's part of the (replicated) gradient."""
    return _Gather.apply(x, dim, par.tp, par.model_index,
                         (par.model_group,), False)


class _SumOut(torch.autograd.Function):
    """g: forward all-reduce, backward identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBoth(torch.autograd.Function):
    """A sum read by split consumers: all-reduce both ways."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _SumGrad(torch.autograd.Function):
    """f: forward identity, backward all-reduce over ``par``'s model
    group."""

    @staticmethod
    def forward(ctx, x, par):
        ctx.par = par
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.par.model_group), None


class _RankZeroGrad(torch.autograd.Function):
    """Forward identity; the gradient kept on model rank 0 alone (zeros
    elsewhere), so a sum over the model axis counts a whole gradient
    once."""

    @staticmethod
    def forward(ctx, x, keep):
        ctx.keep = keep
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None


class _Gather(torch.autograd.Function):
    """Parts along ``dim`` put together; the backward either sums the
    ranks' gradients and keeps this rank's part (``summed``: each rank's
    gradient is partial) or keeps this rank's part of its own (each
    rank's gradient is whole)."""

    @staticmethod
    def forward(ctx, x, dim, n, i, groups, summed):
        ctx.args = (dim, n, i, groups, summed)
        return _gather(x, dim, groups)

    @staticmethod
    def backward(ctx, g):
        dim, n, i, groups, summed = ctx.args
        if summed:
            from repro_torch.dist.compat import funcol
            (group,) = groups
            g = funcol.wait_tensor(funcol.reduce_scatter_tensor(
                g.contiguous(), "sum", dim, group))
            return g, None, None, None, None, None
        return _part(g, dim, n, i), None, None, None, None, None


class _Scatter(torch.autograd.Function):
    """The part of ``x`` along ``dim`` that this rank keeps: summed over
    the ranks first (``summed``: a reduce-scatter, its backward an
    all-gather) or its own part of a whole ``x`` (its backward the
    gradient put together from every rank's part, as the whole ``x``
    feeds each rank alike: an all-gather; or zero-padded, where only
    this rank's part reaches the loss: ``local``)."""

    @staticmethod
    def forward(ctx, x, dim, n, i, groups, summed, local):
        ctx.args = (dim, n, i, groups, local)
        if summed:
            from repro_torch.dist.compat import funcol
            (group,) = groups
            return funcol.wait_tensor(funcol.reduce_scatter_tensor(
                x.contiguous(), "sum", dim, group))
        return _part(x, dim, n, i)

    @staticmethod
    def backward(ctx, g):
        dim, n, i, groups, local = ctx.args
        g = _pad(g, dim, n, i) if local else _gather(g, dim, groups)
        return g, None, None, None, None, None, None


def tp_sum(x: torch.Tensor, par) -> torch.Tensor:
    """A row-parallel product's partial sums ``x`` summed over the model
    group (Megatron's g): one all-reduce, every rank of the group the same
    bits; the backward passes the (replicated) gradient through.  Under
    sequence parallelism (``par.seq``) the sum's reduce-scatter over the
    positions (dim 1): each rank keeps its ``S / tp``.  The identity
    without ``par`` or at tp = 1."""
    if not _split(par):
        return x
    if getattr(par, "seq", False):
        return _Scatter.apply(x, 1, par.tp, par.model_index,
                              (par.model_group,), True, False)
    return _SumOut.apply(x, par.model_group)


def tp_sum_split(x: torch.Tensor, par) -> torch.Tensor:
    """A sum over the model group whose consumers are split (each rank
    reads it for its own channels or heads: the gated norm's sum of
    squares, the mLSTM's gate pre-activations): all-reduce forward and
    backward, as each rank's gradient holds its consumers' terms alone."""
    if not _split(par):
        return x
    return _SumBoth.apply(x, par.model_group)


def tp_copy(x: torch.Tensor, par) -> torch.Tensor:
    """A value the same on every model rank entering split consumers
    (Megatron's f): the identity forward, its gradient -- each rank's
    holds its consumers' terms alone -- all-reduced backward.  Mamba-2's
    B / C stream, MLA's latents, GLA's gate bottleneck, a whole weight
    read by split heads, a norm's scale over a rank's positions."""
    if not _split(par):
        return x
    return _SumGrad.apply(x, par)


def tp_enter(x: torch.Tensor, par) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the input of a layer's column-parallel weights, the input of its
    whole ones) of its normed input ``x``: :func:`tp_copy` on the first;
    under sequence parallelism ``x`` came from :func:`seq_gather`, whose
    backward sums the ranks' gradients, so the first is ``x`` and the
    second's gradient, whole on every rank, is kept on model rank 0
    alone."""
    if not _split(par):
        return x, x
    if getattr(par, "seq", False):
        return x, _RankZeroGrad.apply(x, par.model_index == 0)
    return _SumGrad.apply(x, par), x


def seq_par(par, S: int):
    """``par`` in its sequence-parallel form (``seq``: the residual
    stream holds a rank's ``S / tp`` positions, JAX's ``_seq_shard``)
    where its model axis splits and divides ``S``; else None."""
    if not _split(par) or S <= 1 or S % par.tp:
        return None
    return dataclasses.replace(par, seq=True)


def seq_gather(x: torch.Tensor, par) -> torch.Tensor:
    """A rank's positions (dim 1) of a normed input put together before a
    split layer (f's sequence form): the backward reduce-scatters the
    ranks' partial gradients."""
    return _Gather.apply(x, 1, par.tp, par.model_index, (par.model_group,),
                         True)


def seq_whole(x: torch.Tensor, par) -> torch.Tensor:
    """A rank's positions put together for a layer every model rank runs
    whole (the sLSTM, an MoE, a mixer whose heads tp does not divide; the
    final norm): each rank's gradient is then whole, and the backward
    keeps its own positions."""
    return _Gather.apply(x, 1, par.tp, par.model_index, (par.model_group,),
                         False)


def seq_local(x: torch.Tensor, par) -> torch.Tensor:
    """A rank's positions of a whole sequence ``x`` that is the same on
    every model rank (the embeddings, a whole layer's output): the
    backward puts the ranks' gradients of their positions together."""
    return _Scatter.apply(x, 1, par.tp, par.model_index, (par.model_group,),
                          False, False)


def _data(par) -> Tuple[int, int, tuple]:
    return (par.batch_size_divisor, par.data_index(),
            tuple(par.group(a) for a in par.data_axes))


def rows_whole(x: torch.Tensor, par) -> torch.Tensor:
    """A rank's rows (dim 0) of a batch split in equal blocks over the
    data axes, put together: the whole batch on every data rank.  Only
    the rank's rows reach its loss, so the backward keeps them."""
    n, i, groups = _data(par)
    return _Gather.apply(x, 0, n, i, groups, False)


def rows_local(x: torch.Tensor, par) -> torch.Tensor:
    """The rank's rows of a whole batch that every data rank computed:
    the backward zero-pads its rows' gradient."""
    n, i, groups = _data(par)
    return _Scatter.apply(x, 0, n, i, groups, False, True)


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
