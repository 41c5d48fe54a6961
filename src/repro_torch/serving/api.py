"""Request-lifecycle serving API (PyTorch port of ``repro/serving/api.py``),
slot-pool backend.

    eng = Engine(params, cfg, ServeConfig(backend="slots", batch=4))
    h = eng.submit(prompt, max_new_tokens=32)
    for tok in h:                      # drives eng.step() under the hood
        print(tok)

``Engine.submit()`` returns a :class:`RequestHandle` that streams tokens as
they are sampled each ``step()``, exposes the terminal status (``done`` /
``aborted`` / ``truncated``) and can ``abort()`` mid-decode.  The paged
backend -- and with it fork, sessions and the prefix cache -- is the next
slice of the port (ROADMAP.md, slice 2: paged serving).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.models.config import ModelConfig
from repro_torch.obs import Observability
from repro_torch.serving.engine import (EngineConfig, Request, ServingEngine,
                                        TERMINAL_STATUSES)
from repro_torch.serving.sampler import SamplingConfig

__all__ = ["ServeConfig", "Engine", "RequestHandle", "Request"]

PAGED_TODO = ("backend='paged' is not ported yet: ROADMAP.md, slice 2 "
              "(paged serving: core/paged.py, ops/paged_ops.py, "
              "serving/memory, PagedServingEngine); use backend='slots'")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving configuration.  The port serves ``backend="slots"``: a fixed
    ``batch x cache_capacity`` cache pool.  (The JAX package's default,
    ``"paged"``, is not ported yet.)"""
    backend: str = "slots"             # "slots" | "paged" (not ported)
    batch: int = 4                     # decode rows (slots)
    cache_capacity: int = 256          # max context per slot
    sampling: SamplingConfig = SamplingConfig()
    seed: int = 0

    def __post_init__(self):
        if self.backend not in ("paged", "slots"):
            raise ValueError(f"backend must be 'paged' or 'slots', "
                             f"got {self.backend!r}")

    def engine_config(self) -> EngineConfig:
        if self.backend != "slots":
            raise NotImplementedError(PAGED_TODO)
        return EngineConfig(slots=self.batch,
                            cache_capacity=self.cache_capacity,
                            sampling=self.sampling, seed=self.seed)


class RequestHandle:
    """A live view of one submitted request."""

    def __init__(self, engine: "Engine", req: Request):
        self._engine = engine
        self._req = req
        self._cursor = 0

    @property
    def rid(self) -> int:
        return self._req.rid

    @property
    def status(self) -> str:
        return self._req.status

    @property
    def finished(self) -> bool:
        return self._req.status in TERMINAL_STATUSES

    @property
    def output(self) -> List[int]:
        return list(self._req.output)

    def new_tokens(self) -> List[int]:
        """Tokens sampled since the last call (empty if none yet)."""
        out = self._req.output[self._cursor:]
        self._cursor += len(out)
        return out

    def __iter__(self) -> Iterator[int]:
        """Stream tokens, driving ``Engine.step()`` while none are pending."""
        while True:
            for tok in self.new_tokens():
                yield tok
            if self.finished:
                break
            if not self._engine.step():
                break
        for tok in self.new_tokens():
            yield tok

    def result(self) -> Request:
        """Drive the engine until this request is terminal; returns it."""
        while not self.finished and self._engine.step():
            pass
        return self._req

    def abort(self) -> bool:
        return self._engine.abort(self)


class Engine:
    """The serving facade (slot-pool backend)."""

    def __init__(self, params, cfg: ModelConfig,
                 scfg: ServeConfig = ServeConfig(),
                 obs: Optional[Observability] = None):
        self.scfg = scfg
        self._eng = ServingEngine(params, cfg, scfg.engine_config(),
                                  obs=obs)
        self._rids = itertools.count()

    @property
    def backend(self) -> str:
        return self._eng.backend

    @property
    def engine(self) -> ServingEngine:
        return self._eng

    @property
    def obs(self) -> Observability:
        return self._eng.obs

    def prometheus_text(self) -> str:
        return self.obs.prometheus_text()

    def submit(self, prompt, *, max_new_tokens: int = 16,
               eos_id: Optional[int] = None) -> RequestHandle:
        """Queue a new request; returns its streaming handle."""
        req = Request(rid=next(self._rids),
                      prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens, eos_id=eos_id)
        self._eng.submit(req)
        return RequestHandle(self, req)

    def abort(self, handle) -> bool:
        rid = handle.rid if isinstance(handle, RequestHandle) else int(handle)
        return self._eng.abort(rid)

    def step(self) -> bool:
        """One event-loop iteration (admit + one batched decode step)."""
        return self._eng.step()

    def has_work(self) -> bool:
        return self._eng.has_work()

    def run(self, max_steps: int = 10_000) -> List[Request]:
        return self._eng.run(max_steps=max_steps)

    def stats(self) -> Dict[str, float]:
        return self._eng.stats()
