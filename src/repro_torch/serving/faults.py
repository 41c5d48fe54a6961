"""Deterministic fault injection for the serving stack (PyTorch port of
``repro/serving/faults.py``: the same grammar, triggers and PCG64 draws,
so a plan fires on the same checks as the JAX package's).

A :class:`FaultPlan` is a seeded, reproducible schedule of failures the
engine and pools *ask about* at well-defined injection sites.  It is the
attack half of the resilience layer (:mod:`repro_torch.serving.resilience` is
the defense half): chaos runs construct a plan from a spec string, every
``should_fire`` decision is a pure function of (spec, seed, call order),
and re-running the same workload with the same plan reproduces the same
faults byte for byte.

Spec grammar (one clause per site, ``;``-separated)::

    "alloc:step=7;host_pin:p=0.05;nan:rid=3;blob_corrupt:nth=2;slow_step:ms=500"

    site   := alloc | host_pin | blob_corrupt | prefetch_commit | nan
            | slow_step
    clause := site [":" key "=" value ("," key "=" value)*]

Trigger keys (combinable; all present triggers must agree):

    ``step=N``   fire while the engine's step counter is ``N``
    ``nth=K``    fire on the K-th check of this site (1-based)
    ``p=F``      fire each check with probability ``F`` (seeded PCG64)
    ``rid=R``    only fire for request id ``R``
    ``n=C``      cap total fires at ``C`` (default: 1 for deterministic
                 triggers ``step``/``nth``/``rid``, unlimited for ``p``)
    ``ms=M``     payload (``slow_step``: injected stall in milliseconds)

Injection sites (who checks, what a fire means):

    ``alloc``            page/slab allocation in the paged pool
                         (register / grow / resume / promote) reports a
                         transient failure -- callers retry + escalate
    ``host_pin``         pinning a spill blob in the host tier fails
                         transiently -- the spill path retries, then
                         force-pins (live state is never dropped)
    ``blob_corrupt``     a host blob (spill or store demotion) gets one
                         byte flipped *after* its checksum was recorded --
                         detected at resume/promote, recovered by
                         re-prefill / store eviction
    ``prefetch_commit``  a staged prefetch fails to commit -- the staging
                         pages are returned and resume falls back to the
                         synchronous path
    ``nan``              one active request's post-step logits become NaN
                         -- the guard quarantines exactly that request
    ``slow_step``        the engine sleeps ``ms`` before the step -- the
                         wall-clock watchdog must flag it

All checks are no-ops costing one ``is None`` test when no plan is
installed; a plan is installed via ``ServeConfig(fault_plan=...)`` or the
``REPRO_FAULTS`` environment variable.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np

__all__ = ["FaultPlan", "FaultSpecError", "SITES"]

#: the injection sites a plan may name, in documentation order
SITES = ("alloc", "host_pin", "blob_corrupt", "prefetch_commit", "nan",
         "slow_step")

#: environment variable holding a fault spec (chaos runs under CI)
ENV_VAR = "REPRO_FAULTS"


class FaultSpecError(ValueError):
    """A fault spec string that does not parse / names unknown sites."""


@dataclasses.dataclass
class _SiteRule:
    """One parsed clause: the triggers for a single site."""
    site: str
    step: Optional[int] = None
    nth: Optional[int] = None
    p: Optional[float] = None
    rid: Optional[int] = None
    n: Optional[int] = None            # max fires (None = unlimited)
    ms: float = 0.0                    # payload (slow_step)
    # runtime state
    checks: int = 0
    fires: int = 0

    def cap(self) -> Optional[int]:
        if self.n is not None:
            return self.n
        # deterministic one-shot triggers default to a single fire;
        # probabilistic rules keep firing until capped explicitly
        if self.p is None and (self.step is not None or self.nth is not None
                               or self.rid is not None):
            return 1
        return None


_INT_KEYS = ("step", "nth", "rid", "n")
_FLOAT_KEYS = ("p", "ms")


def _parse_clause(clause: str) -> _SiteRule:
    head, _, rest = clause.partition(":")
    site = head.strip()
    if site not in SITES:
        raise FaultSpecError(
            f"unknown fault site {site!r} (known: {', '.join(SITES)})")
    rule = _SiteRule(site)
    if rest.strip():
        for kv in rest.split(","):
            key, sep, val = kv.partition("=")
            key, val = key.strip(), val.strip()
            if not sep or not val:
                raise FaultSpecError(f"bad trigger {kv!r} in {clause!r}")
            if key in _INT_KEYS:
                setattr(rule, key, int(val))
            elif key in _FLOAT_KEYS:
                setattr(rule, key, float(val))
            else:
                raise FaultSpecError(
                    f"unknown trigger key {key!r} in {clause!r} "
                    f"(known: {', '.join(_INT_KEYS + _FLOAT_KEYS)})")
    if rule.p is not None and not (0.0 <= rule.p <= 1.0):
        raise FaultSpecError(f"p={rule.p} out of [0, 1] in {clause!r}")
    return rule


class FaultPlan:
    """A parsed, seeded fault schedule.

    The plan is consulted through :meth:`should_fire` at each injection
    site; every consult is deterministic given the construction arguments
    and the sequence of prior consults (probabilistic triggers draw from a
    private ``PCG64(seed)`` stream).  ``injected`` tallies fires per site
    so chaos harnesses can report exactly what they unleashed.
    """

    def __init__(self, spec: str, seed: int = 0):
        spec = (spec or "").strip()
        clauses = [c for c in spec.split(";") if c.strip()]
        if not clauses:
            raise FaultSpecError("empty fault spec")
        self.spec = spec
        self.seed = int(seed)
        self.rules: Dict[str, _SiteRule] = {}
        for c in clauses:
            rule = _parse_clause(c.strip())
            if rule.site in self.rules:
                raise FaultSpecError(f"duplicate site {rule.site!r}")
            self.rules[rule.site] = rule
        self._rng = np.random.Generator(np.random.PCG64(self.seed))
        self._step = -1
        #: site -> number of faults actually fired
        self.injected: Dict[str, int] = {s: 0 for s in self.rules}

    # ------------- construction helpers -------------

    @classmethod
    def from_env(cls, seed: int = 0,
                 env: Optional[dict] = None) -> Optional["FaultPlan"]:
        """Plan from ``REPRO_FAULTS`` (None when unset/empty)."""
        spec = (env if env is not None else os.environ).get(ENV_VAR, "")
        return cls(spec, seed=seed) if spec.strip() else None

    @classmethod
    def maybe(cls, spec: Optional[str], seed: int = 0,
              use_env: bool = True) -> Optional["FaultPlan"]:
        """The engine-side constructor: explicit spec wins, else the
        environment, else None (faults disabled, zero overhead)."""
        if spec:
            return cls(spec, seed=seed)
        return cls.from_env(seed=seed) if use_env else None

    # ------------- the injection-site protocol -------------

    def set_step(self, step: int) -> None:
        """Engine hook: the current step counter (for ``step=N`` rules)."""
        self._step = int(step)

    def should_fire(self, site: str, rid: Optional[int] = None) -> bool:
        """One consult at ``site`` (optionally for a request): True means
        the caller must inject the fault now.  Counts the fire."""
        rule = self.rules.get(site)
        if rule is None:
            return False
        rule.checks += 1
        cap = rule.cap()
        if cap is not None and rule.fires >= cap:
            return False
        if rule.rid is not None and (rid is None or int(rid) != rule.rid):
            return False
        if rule.step is not None and self._step != rule.step:
            return False
        if rule.nth is not None and rule.checks != rule.nth:
            return False
        if rule.p is not None and not (self._rng.random() < rule.p):
            return False
        rule.fires += 1
        self.injected[site] += 1
        return True

    def param(self, site: str, key: str, default: float = 0.0) -> float:
        """A payload parameter of a site's clause (e.g. slow_step ms)."""
        rule = self.rules.get(site)
        if rule is None:
            return default
        return float(getattr(rule, key, default))

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    def __repr__(self) -> str:
        return f"FaultPlan({self.spec!r}, seed={self.seed})"
