"""``repro_torch.obs`` -- observability for the port's serving stack
(PyTorch port of ``repro/obs``).

One :class:`Observability` object per engine bundles the four pieces the
stack threads through itself:

  * :class:`~repro_torch.obs.metrics.MetricsRegistry` -- labeled counters /
    gauges / histograms; ``Engine.stats()`` is a schema-stable view over
    it and ``prometheus_text()`` renders it for scraping;
  * :class:`~repro_torch.obs.trace.TraceBuffer` -- a bounded ring of
    per-step structured events (steps, admissions, evictions, forks,
    per-bank traffic counters), exportable as Chrome-trace JSON (Perfetto)
    or JSONL;
  * :class:`~repro_torch.obs.lifecycle.LifecycleTracker` -- per-request
    phase spans (queued -> prefill -> decode -> spilled -> terminal) with
    exact TTFT / TPOT / queue-delay / preemption-cost per request;
  * :class:`~repro_torch.obs.recompile.RecompileWatcher` -- wraps the
    steppers and records every new abstract argument signature (the set of
    shapes a captured step would need one graph each for) with the leaves
    that changed.

Usage (the serving engines do all of this internally):

    obs = Observability()
    fn = obs.wrap_step(step, "engine.decode")
    ...
    obs.save_trace("out.json")          # load in https://ui.perfetto.dev
    print(obs.prometheus_text())
"""
from __future__ import annotations

from repro_torch.obs.lifecycle import (PHASES, LifecycleTracker, PhaseSpan,
                                       RequestRecord)
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.recompile import (RecompileEvent, RecompileWatcher,
                                       WatchedFunction)
from repro_torch.obs.schema import trace_features, validate_chrome_trace
from repro_torch.obs.trace import TraceBuffer

__all__ = [
    "Observability",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "TraceBuffer",
    "LifecycleTracker", "RequestRecord", "PhaseSpan", "PHASES",
    "RecompileWatcher", "RecompileEvent", "WatchedFunction",
    "validate_chrome_trace", "trace_features",
]


class Observability:
    """The per-engine bundle: metrics + trace + lifecycle + recompiles."""

    def __init__(self, trace_capacity: int = 65536):
        self.metrics = MetricsRegistry()
        self.tracer = TraceBuffer(capacity=trace_capacity)
        self.lifecycle = LifecycleTracker(self.tracer, self.metrics)
        self.recompiles = RecompileWatcher(self.tracer, self.metrics)

    def wrap_step(self, fn, name: str) -> WatchedFunction:
        """Put the recompile watcher around a stepper (the twin of the JAX
        package's ``Observability.wrap_jit``, which wraps a ``jax.jit``
        callable)."""
        return self.recompiles.wrap(fn, name)

    def save_trace(self, path: str) -> None:
        """Chrome-trace JSON (or JSONL for ``*.jsonl`` paths)."""
        self.tracer.save(path)

    def prometheus_text(self) -> str:
        return self.metrics.prometheus_text()
