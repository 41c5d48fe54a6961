"""One device computing its products as the ranks of a model axis do.

:func:`split_sums` runs a model without ``par`` (tp = 1) whose sharded
products are cut as ``tp`` ranks cut them: a row-parallel product (``wo``,
the FFN's down rows, Mamba-2's out projection, the mLSTM's gate and down
sums) as each rank's contiguous share of the summed dim, the shares added
in rank order, as ``dist.tp.tp_sum``'s all-reduce adds them; the column
products (attention's q / k / v, Mamba-2's z / x / dt, the GLA family's,
the dense FFNs') a rank's columns at a time; Mamba-2's gated-norm sum of
squares a rank's channels at a time, and the GLA family's per-head norm a
rank's heads at a time.  Everything else, its
stochastic rounding included, stays the whole layer's.  A sharded run
that is bitwise this emulation drifts from one device by the order of
those sums alone.  The model code knows nothing of it: the weights carry
the split (:class:`_Split`), and the two norms are swapped for the
block's length.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch
from torch.utils import _pytree

from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM


#: the functions ``a @ w`` and ``torch.matmul(a, w)`` reach a subclass by
_MATMUL = (torch.matmul, torch.Tensor.matmul)


class _Split(torch.Tensor):
    """A weight whose products ``a @ w`` are computed as ``tp`` ranks
    compute them: ``rows`` (a row-parallel weight: each rank's share of
    ``a``'s last dim and ``w``'s first, the products added in rank order)
    or columns (each rank's columns of ``w`` multiplied alone, set side by
    side).  Every other op sees the plain weight."""

    @staticmethod
    def __new__(cls, w: torch.Tensor, tp: int, rows: bool):
        t = torch.Tensor._make_subclass(cls, w)
        t._plain, t._tp, t._rows = w, tp, rows
        return t

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func in _MATMUL and len(args) == 2
                and isinstance(args[1], _Split) and not kwargs
                and not isinstance(args[0], _Split)):
            return args[1]._product(args[0])
        args, kwargs = _pytree.tree_map(
            lambda x: x._plain if isinstance(x, _Split) else x,
            (args, kwargs))
        with torch._C.DisableTorchFunctionSubclass():
            return func(*args, **kwargs)

    def _product(self, a: torch.Tensor) -> torch.Tensor:
        w, tp = self._plain, self._tp
        if self._rows:
            k = w.shape[0] // tp
            out = None
            for r in range(tp):
                part = (a.narrow(-1, r * k, k).contiguous()
                        @ w.narrow(0, r * k, k).contiguous())
                out = part if out is None else out + part
            return out
        n = w.shape[-1] // tp
        return torch.cat([a @ w[..., r * n:(r + 1) * n].contiguous()
                          for r in range(tp)], -1)


def _wrap(p: dict, tp: int, units: int, rows=(), cols=()) -> dict:
    """``p`` with its ``rows`` and ``cols`` weights split over ``tp``
    ranks, where ``tp`` divides ``units`` (the heads or columns whose
    count decides the split, ``dist.tp.layer_par``'s rule; else the layer
    stays whole, as the sharded run keeps it)."""
    if units % tp:
        return p
    out = dict(p)
    for names, is_rows in ((rows, True), (cols, False)):
        for k in names:
            if k in out:
                out[k] = _Split(out[k], tp, is_rows)
    return out


def _split_params(tree, cfg, tp: int):
    """The parameter tree with every emulated product's weight split."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_split_params(x, cfg, tp) for x in tree)
    if not isinstance(tree, dict):
        return tree
    p = {k: _split_params(v, cfg, tp) for k, v in tree.items()}
    if "wg_out" in p:                                   # the GLA family
        return _wrap(p, tp, SSM._gla_dims(cfg)[0], rows=("wo",),
                     cols=("wq", "wk", "wv", "wgb", "wf", "wg_out"))
    if "out_proj" in p:                                 # Mamba-2
        return _wrap(p, tp, SSM._m2_dims(cfg)[1], rows=("out_proj",),
                     cols=("wz", "wx", "wdt"))
    if "down" in p:                                     # mLSTM
        return _wrap(p, tp, SSM._mlstm_dims(cfg)[1],
                     rows=("wi", "wf", "down"))
    if "wq" in p and "wo" in p:                         # attention
        return _wrap(p, tp, cfg.n_kv_heads, rows=("wo",),
                     cols=("wq", "wk", "wv"))
    if "wi" in p and "wo" in p and "router" not in p:   # a dense FFN
        return _wrap(p, tp, p["wo"].shape[0], rows=("wo",),
                     cols=("wi", "wg"))
    return p


@contextlib.contextmanager
def split_sums(params, cfg, tp: int) -> Iterator[dict]:
    """Within the block, ``params`` of ``cfg`` as tp = 1 runs them with
    ``tp`` ranks' products (the module's docstring): yields the tree to
    run the model with (``par`` None)."""
    gla = bool({"gla", "retnet", "hgrn2"} & set(cfg.pattern))
    gated, head = L.rmsnorm_gated, L.head_rmsnorm

    def rmsnorm_gated(x, scale, gate, eps=1e-5, par=None):
        if par is not None or SSM._m2_dims(cfg)[1] % tp:
            return gated(x, scale, gate, eps, par)
        xf = (x * torch.nn.functional.silu(gate.to(torch.float32))).to(
            torch.float32)
        ms = None
        for c in xf.chunk(tp, -1):
            part = c.contiguous().square().sum(-1, keepdim=True)
            ms = part if ms is None else ms + part
        ms = ms / xf.shape[-1]
        return (xf * torch.rsqrt(ms + eps)
                * scale.to(torch.float32)).to(x.dtype)

    def head_rmsnorm(x, eps=1e-5):
        # the GLA family's (B, H, S, dv): a rank's heads at a time
        if not gla or x.shape[1] % tp:
            return head(x, eps)
        return torch.cat([head(c.contiguous(), eps)
                          for c in x.chunk(tp, 1)], 1)

    L.rmsnorm_gated, L.head_rmsnorm = rmsnorm_gated, head_rmsnorm
    try:
        yield _split_params(params, cfg, tp)
    finally:
        L.rmsnorm_gated, L.head_rmsnorm = gated, head
