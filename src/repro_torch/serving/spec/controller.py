"""Acceptance-aware draft-length controller (PyTorch port of
``repro/serving/spec/controller.py``; host-side, no tensors).

Verification cost is one fused pass regardless of how many drafts ride in
it (the verify step always runs at ``spec_k + 1`` positions,
padding with garbage), but every *drafted* token costs draft-source work
and every *rejected* one is pure waste.  The controller therefore modulates
only how many drafts are requested per row, from that row's recent
acceptance history -- the step shape never changes.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Tuple


class KController:
    """Per-request draft length from a sliding acceptance window.

    Deterministic: ``k = clip(floor(mean accepted per speculative step)
    + 1, 1, k_max)`` over the last ``window`` steps, starting at ``k_max``
    (optimistic -- a fresh request has no evidence against drafting).
    A request that stops accepting decays to ``k = 1`` within a window;
    one that accepts everything climbs back just as fast.
    """

    def __init__(self, k_max: int, window: int = 8):
        assert k_max >= 1 and window >= 1
        self.k_max = int(k_max)
        self.window = int(window)
        self._hist: Dict[int, Deque[Tuple[int, int]]] = {}

    def k_for(self, rid: int) -> int:
        hist = self._hist.get(rid)
        if not hist:
            return self.k_max
        accepted = sum(a for _, a in hist)
        mean = accepted / len(hist)
        return max(1, min(self.k_max, int(mean) + 1))

    def observe(self, rid: int, proposed: int, accepted: int) -> None:
        """Record one speculative step's outcome for ``rid``.

        Steps with no drafts carry no acceptance evidence (nothing was
        risked) and are not recorded.
        """
        if proposed <= 0:
            return
        hist = self._hist.setdefault(rid, deque(maxlen=self.window))
        hist.append((proposed, accepted))

    def forget(self, rid: int) -> None:
        self._hist.pop(rid, None)
