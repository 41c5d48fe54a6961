"""``repro_torch.obs`` -- observability for the port's serving stack.

This slice carries the two pieces ``Engine.stats()`` reads: the labeled
metrics registry (counters / gauges / histograms, Prometheus text) and the
per-request lifecycle spans (TTFT, queue delay, per-token latency).  The
structured trace buffer and the recompile watcher of the JAX package's
``repro/obs`` follow in the observability slice (ROADMAP.md); until then
``stats()["recompiles"]`` reads 0.
"""
from __future__ import annotations

from repro_torch.obs.lifecycle import (PHASES, LifecycleTracker, PhaseSpan,
                                       RequestRecord)
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = [
    "Observability", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "LifecycleTracker", "RequestRecord", "PhaseSpan", "PHASES",
]


class Observability:
    """The per-engine bundle: metrics registry + lifecycle tracker."""

    def __init__(self):
        self.metrics = MetricsRegistry()
        self.lifecycle = LifecycleTracker(tracer=None, metrics=self.metrics)

    def prometheus_text(self) -> str:
        return self.metrics.prometheus_text()
