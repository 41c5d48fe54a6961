"""Controlled numerical reproduction of paper Fig. 4 / Table 2: the PyTorch
port's copy of ``repro/analysis/formats_study.py``.

No pretrained checkpoints or WikiText-2 are available offline, so the
perplexity tables are reproduced at their *mechanism* level: long-horizon
state accumulation under each (format x rounding) pair, measured as relative
error against the fp32 state.  The orderings mirror the paper: fp8 under RNE
diverges (swamping), stochastic rounding rescues it, int8/MX8/fp16 track.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch import ops as OPS
from repro_torch.core import formats as F
from repro_torch.models import model as M

#: every (format, rounding) pair the study runs by default
DEFAULT_FORMATS = (("mx8", "nearest"), ("mx8", "stochastic"),
                   ("int8", "nearest"), ("int8", "stochastic"),
                   ("fp8_e4m3", "nearest"), ("fp8_e4m3", "stochastic"),
                   ("fp8_e5m2", "nearest"), ("fp8_e5m2", "stochastic"),
                   ("fp16", "nearest"))


def swamping_draws(T: int, dk: int = 32, dv: int = 32,
                   generator: Optional[torch.Generator] = None,
                   device=None) -> Tuple[torch.Tensor, ...]:
    """The study's standard-normal draws (k, v, q), each (T, 1, 1, dim),
    from an explicit generator (seed 7 when none is given), on the card
    unless ``device`` asks for the CPU."""
    device = M.resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(7)
    return tuple(torch.randn((T, 1, 1, n), generator=generator,
                             device=device)
                 for n in (dk, dv, dk))


def swamping_inputs(draws, device=None) -> Tuple[torch.Tensor, ...]:
    """The study's Eq. 2 operands from its draws: the decay ``d`` (1, 1, dk)
    and the per-step ``k``, ``v``, ``q`` (T, 1, 1, dim) -- small increments
    with a persistent direction, the hard case -- on the card unless
    ``device`` asks for the CPU."""
    device = M.resolve_device(device)
    kn, vn, qn = (torch.as_tensor(a, dtype=torch.float32).to(device)
                  for a in draws)
    d = torch.full((1, 1, kn.shape[-1]), 0.9995, device=device)
    return d, (0.5 + 0.1 * kn) * 0.02, 0.5 + 0.1 * vn, qn


def run_swamping_study(T: int = 300, dk: int = 32, dv: int = 32,
                       formats: Optional[Sequence[Tuple[str, str]]] = None,
                       *, draws=None, device=None, backend: str = "torch"
                       ) -> Dict[Tuple[str, str], float]:
    """Paper Fig. 4's mechanism as a controlled experiment.

    Long accumulation of per-step increments that are SMALL relative to the
    state magnitude -- the regime of a decayed recurrent state.  Narrow
    mantissas (e4m3/e5m2) swamp: increments below half an ulp vanish under
    round-to-nearest and the state goes stale/biased.  Stochastic rounding
    preserves them in expectation.  Returns {(fmt, rounding): rel_error}.

    ``draws`` holds the standard-normal draws (k, v, q), three numpy arrays
    or tensors of shape (T, 1, 1, dk / dv / dk); step ``t`` reads row ``t``
    of each (the JAX study draws them with ``PRNGKey(7t+1 .. 7t+3)``).
    Without them the study draws from a seeded generator
    (:func:`swamping_draws`).  ``backend`` is the state update's backend:
    ``"torch"`` for every format, or ``"cuda"``, which runs mx8 through the
    fused state-update kernel (dense mode, one (1, 1, dv, dk) head) on a
    CUDA ``device``; the other formats have only the torch backend.  The
    study runs on the card unless ``device`` asks for the CPU, and raises
    when there is no card.
    """
    B, H = 1, 1
    device = M.resolve_device(device)
    if draws is None:
        draws = swamping_draws(T, dk, dv, device=device)
    d, ks, vs, qn = swamping_inputs(draws, device)
    if ks.shape[0] < T:
        raise ValueError(f"draws hold {ks.shape[0]} steps, the study {T}")
    errs = {}
    for fmt, rounding in formats or DEFAULT_FORMATS:
        cfg = OPS.StateQuantConfig(fmt=fmt, rounding=rounding,
                                   backend=backend)
        qS = OPS.init_state(B, H, dk, dv, cfg, device=device)
        Sf = torch.zeros((B, H, dv, dk), device=device)
        for t in range(T):
            qS, _ = OPS.state_update_step(qS, d, ks[t], vs[t], qn[t], cfg,
                                          seed=t)
            Sf, _ = OPS.state_update_float(Sf, d, ks[t], vs[t], qn[t],
                                           dtype=torch.float32)
        Sq = (F.dequantize(qS) if isinstance(qS, F.QuantizedTensor)
              else qS.to(torch.float32))
        errs[(fmt, rounding)] = float(torch.linalg.norm(Sq - Sf)
                                      / torch.linalg.norm(Sf))
    return errs
