"""Draft sources for speculative decoding (PyTorch port of
``repro/serving/spec/draft.py``).

A draft source proposes up to ``k`` likely next tokens per request; the
engine verifies them in one ``spec_verify`` pass of the target model and
accepts the matching prefix.  Two sources live behind one protocol:

:class:`NGramDraft`
    Self-drafting: match the request's recent token suffix against its own
    history and propose the continuation that followed the longest matching
    n-gram last time.  No second model, no extra memory -- works for every
    architecture and shines on repetitive text.

:class:`ModelDraft`
    A small attention-only draft model decoded greedily token by token
    through its own small :class:`~repro_torch.serving.memory.PagedStatePool`
    on the target's device.  The draft pool is separate from the target
    pool (the two models' cache leaves have different shapes) but is
    slab/page-accounted the same way and torn down through the same leak
    check.  Rejected drafts roll back by resetting the host-side consumed
    counter: stale KV rows beyond it are masked by the next call's lengths
    and overwritten in place.

Both are deterministic and drive nothing of the target model's step.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Protocol, Sequence

import numpy as np
import torch


class DraftSource(Protocol):
    """What the engine needs from a draft source.

    ``propose`` receives the request's full decoded context (prompt +
    emitted tokens) and never sees verification results directly -- accepted
    tokens simply show up in the next call's context, which is also how
    rollback of rejected drafts happens for stateless sources.
    """

    def admit(self, rid: int, prompt: Sequence[int]) -> bool:
        """Take on a request (allocate draft-side state).  False = the
        source cannot serve it now; the engine decodes it normally."""
        ...

    def release(self, rid: int) -> None:
        """Drop a request's draft-side state (finish/abort/failure)."""
        ...

    def suspend(self, rid: int) -> None:
        """The request was preempted: drop reconstructible draft state now,
        keep serving the rid after the engine resumes it."""
        ...

    def propose(self, rid: int, context: Sequence[int],
                k: int) -> List[int]:
        """Up to ``k`` drafted continuations of ``context`` (may be [])."""
        ...


class NGramDraft:
    """Suffix-match self-drafting (no draft model).

    For gram lengths 3, 2, 1 (longest first): find the most recent earlier
    occurrence of the context's trailing gram and propose the ``k`` tokens
    that followed it.  Stateless per request -- admit/release/suspend only
    gate a membership set, so preemption and abort are trivially clean.
    """

    def __init__(self, max_gram: int = 3):
        if max_gram < 1:
            raise ValueError(f"max_gram must be >= 1, got {max_gram}")
        self.max_gram = max_gram
        self._rids: set = set()

    def admit(self, rid: int, prompt: Sequence[int]) -> bool:
        self._rids.add(rid)
        return True

    def release(self, rid: int) -> None:
        self._rids.discard(rid)

    def suspend(self, rid: int) -> None:
        pass                      # nothing cached outside the context

    def propose(self, rid: int, context: Sequence[int],
                k: int) -> List[int]:
        if rid not in self._rids or k <= 0:
            return []
        ctx = list(context)
        n = len(ctx)
        for g in range(min(self.max_gram, n - 1), 0, -1):
            tail = ctx[n - g:]
            # most recent earlier occurrence of the trailing gram
            for start in range(n - g - 1, -1, -1):
                if ctx[start:start + g] == tail:
                    out = ctx[start + g:start + g + k]
                    if out:
                        return out
        return []


class ModelDraft:
    """Small-model drafting through a private paged pool.

    The draft model decodes greedily, one token at a time, over its own
    :class:`PagedStatePool`.  Per request it tracks how many context tokens
    its cache has consumed; each ``propose`` first catches up on tokens the
    target accepted since the last call (rejected drafts are *behind* the
    counter and simply get overwritten), then rolls out ``k`` greedy
    drafts.  After the rollout the counter is reset to the verified context
    length, which is the whole rollback story.

    Restricted to attention-only draft architectures -- recurrent draft
    state cannot be rolled back by a host counter reset.  Weights are
    random from ``seed`` unless ``params`` are given; they live on
    ``device`` (the card unless the caller asks for the CPU).  A draft
    model with a smaller vocabulary than the target reads a token past its
    table as its last entry, as the JAX package's clamping gather does
    (its drafts stay valid target tokens).
    """

    def __init__(self, cfg, params=None, *, max_requests: int = 8,
                 max_len: int = 4096, seed: int = 0, device=None):
        from repro_torch.core.paged import pages_for
        from repro_torch.models import model as M
        from repro_torch.serving.memory import PagedStatePool
        bad = [k for k in tuple(cfg.pattern) + tuple(cfg.prelude or ())
               if k != "attn"]
        if bad:
            raise ValueError(f"draft model must be attention-only, "
                             f"{cfg.name} has {bad}")
        self.cfg = cfg
        self._M = M
        self.device = (M.resolve_device(device) if params is None
                       else M.params_device(params))
        self.params = (M.init_model(
            cfg, torch.Generator(device=self.device).manual_seed(seed),
            device=self.device) if params is None else params)
        self.pool = PagedStatePool(
            cfg, n_pages=1 + max_requests * pages_for(max_len),
            n_slabs=1 + max_requests, device=self.device)
        self._pages_for = pages_for
        self.consumed: Dict[int, int] = {}     # rid -> cached context length
        self._step = 0

    # -- DraftSource protocol -------------------------------------------

    def admit(self, rid: int, prompt: Sequence[int]) -> bool:
        if rid in self.consumed:
            return True
        npg = self._pages_for(len(prompt))
        if not self.pool.can_admit(npg):
            return False
        # drafting is best-effort: a failed claim means "no drafts this
        # round" (the engine decodes normally), not a request to escalate
        if not self.pool.register(rid, npg):  # lint: disable=PL206
            return False
        pr = torch.as_tensor(self._clip(prompt), device=self.device)[None]
        _, row = self._M.prefill(self.params, self.cfg, {"tokens": pr})
        self.pool.insert_prefill(rid, row)
        self.consumed[rid] = len(prompt)
        return True

    def release(self, rid: int) -> None:
        if rid in self.consumed:
            self.pool.release(rid)
            del self.consumed[rid]

    def suspend(self, rid: int) -> None:
        # preemption: the draft cache is reconstructible from the context,
        # so free the pages now and re-admit lazily on the next propose
        self.release(rid)

    def propose(self, rid: int, context: Sequence[int],
                k: int) -> List[int]:
        if k <= 0:
            return []
        if rid not in self.consumed:       # suspended earlier: re-admit
            if not self.admit(rid, list(context)):
                return []
        ctx = list(context)
        if self.consumed[rid] > len(ctx):
            # the engine rewound this request: our cache is ahead of the
            # truth, rebuild it
            self.release(rid)
            if not self.admit(rid, ctx):
                return []
        drafts: List[int] = []
        # catch up on accepted-but-unconsumed context, then roll out k
        # greedy drafts; both are the same B=1 decode loop.  When nothing
        # is pending, re-decode the last context row (same position, so
        # the overwrite is harmless) to recover its next-token prediction.
        start = min(self.consumed[rid], len(ctx) - 1)
        length = start
        tok = None
        for t in ctx[start:]:
            tok = self._decode_one(rid, t, length)
            if tok is None:
                return []
            length += 1
        for i in range(k):
            drafts.append(tok)
            if i + 1 == k:
                break
            tok = self._decode_one(rid, tok, length)
            if tok is None:
                break
            length += 1
        self.consumed[rid] = len(ctx)
        return drafts

    # -- internals ------------------------------------------------------

    def _decode_one(self, rid: int, token: int,
                    length: int) -> Optional[int]:
        need = length // 128 + 1
        while need > len(self.pool.page_table[rid]):
            # best-effort (see admit): no page -> no draft, never escalate
            if not self.pool.grow(rid, 1):  # lint: disable=PL206
                return None
        self._step += 1
        lg = self.pool.decode(self.params, [rid], self._clip([token]),
                              np.array([length], np.int32),
                              seed=self._step)
        return int(torch.argmax(lg[0]))

    def _clip(self, tokens) -> np.ndarray:
        return np.clip(np.asarray(tokens, np.int64), 0,
                       self.cfg.vocab_size - 1)

    def sanitizer_check_leaks(self, what: str = "draft teardown") -> None:
        self.pool.sanitizer_check_leaks(what)
