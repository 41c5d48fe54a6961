"""A serving engine's decode rows over the data ranks of a mesh.

The engines run one host scheduler on every rank, on the same requests,
so every rank makes the same decisions; only the model's work is split.
Rows are dealt in contiguous blocks: data rank ``j`` of ``dp`` owns rows
``j * B / dp .. (j + 1) * B / dp - 1`` of the ``B`` decode rows and
computes only those, its stochastic rounding counted from its first row
of the whole batch (``ops.sr_rows_from``).  The ``(B, ...)`` logits are
then put together on every rank (:meth:`DataRows.gather`), so every rank
samples the whole batch with the same generator and draws the same
tokens.  Where ``dp`` does not divide ``B`` every data rank computes the
whole batch, JAX's own fallback for an indivisible batch
(``repro/dist/sharding.py::cache_shardings``).  So does every data rank of
an MoE model whose experts the model axis does not split: JAX's
``apply_moe`` routes the whole batch with the whole batch's capacity then,
and a rank's rows alone would fill the experts otherwise.

Collectives run over the data group, all of them broadcasts: the logits
one broadcast a data rank, a row's result, moved pages.
"""
from __future__ import annotations

import contextlib
from typing import FrozenSet, Optional

import torch

from repro_torch.dist import tp as TP


class DataRows:
    """The split of ``B`` decode rows over the data axes of ``par`` (a
    ``dist.sharding.Parallel``; None or one data rank: every row here) for
    the model ``cfg``."""

    def __init__(self, par, B: int, cfg=None):
        self.B = int(B)
        self.dp = 1 if par is None else int(par.batch_size_divisor)
        self.index = 0 if self.dp == 1 else par.data_index()
        moe_whole = (getattr(cfg, "moe", None) is not None
                     and not TP.expert_parallel(cfg, par))
        #: whether this rank computes a block of the rows (else all of them)
        self.split = self.dp > 1 and self.B % self.dp == 0 and not moe_whole
        per = self.B // self.dp if self.split else self.B
        self.lo = self.index * per if self.split else 0
        self.hi = self.lo + per
        self._group = None
        if self.dp > 1:
            axes = tuple(par.data_axes)
            self._group = (par.group(axes[0]) if len(axes) == 1
                           else par.mesh[axes]._flatten().get_group())

    @property
    def n_local(self) -> int:
        """Rows this rank computes."""
        return self.hi - self.lo

    def owners(self, row: int) -> FrozenSet[int]:
        """The data ranks that compute ``row``."""
        if not self.split:
            return frozenset(range(self.dp))
        return frozenset((row // (self.B // self.dp),))

    def computes(self, row: int) -> bool:
        return self.index in self.owners(row)

    def sr_rows(self):
        """The block this rank steps its rows in: its stochastic rounding
        counted from its first row of the whole batch."""
        if not self.split:
            return contextlib.nullcontext()
        from repro_torch import ops as OPS
        return OPS.sr_rows_from(self.lo)

    def _src(self, j: int) -> int:
        import torch.distributed as dist
        return dist.get_global_rank(self._group, j)

    def broadcast(self, x: torch.Tensor, j: int) -> torch.Tensor:
        """``x`` of data rank ``j`` on every data rank (in place into ``x``
        elsewhere, which gives the shape and dtype)."""
        import torch.distributed as dist
        x = x.contiguous()
        dist.broadcast(x, src=self._src(j), group=self._group)
        return x

    def from_owner(self, x: Optional[torch.Tensor], row: int, shape,
                   dtype, device) -> torch.Tensor:
        """What the owner of ``row`` computed (``x``: this rank's result,
        None where it computed nothing), on every data rank."""
        if self.dp == 1 or not self.split:
            return x
        j = min(self.owners(row))
        buf = x if j == self.index else torch.empty(shape, dtype=dtype,
                                                    device=device)
        return self.broadcast(buf, j)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows ``x`` (its ``n_local`` leading rows) put
        together with every other data rank's: the whole batch, in row
        order, the same bits on every rank."""
        if not self.split:
            return x
        x = x.contiguous()
        parts = []
        for j in range(self.dp):
            buf = x if j == self.index else torch.empty_like(x)
            parts.append(self.broadcast(buf, j))
        return torch.cat(parts)
