"""Labeled metrics registry: counters, gauges, histograms.

One ``MetricsRegistry`` per engine holds every serving-side number the
stack emits -- the engines' ``stats()`` dicts are schema-stable *views*
over it, and ``prometheus_text()`` renders the same families for
scrape-style consumption (``repro_torch.launch.serve --metrics``).

Design constraints, in order:

  * **cheap on the hot path** -- ``counter(...).inc()`` in the decode loop
    must cost a dict lookup and a float add, nothing more;
  * **percentile-exact at serving scale** -- histograms retain raw samples
    (decimated 2x whenever the reservoir fills, so memory is bounded while
    long runs keep a uniform subsample) and compute percentiles with
    ``np.percentile``, matching what the engines previously computed from
    ad-hoc lists bit-for-bit until the first decimation;
  * **schema-stable** -- a metric read before any write reports 0.0, so
    views built over the registry never key-error on an idle engine.

A copy of the JAX package's ``repro/obs/metrics.py`` (no JAX in it), kept
in the port so that ``repro_torch`` imports nothing of ``repro``.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]

#: default histogram reservoir; at 2x decimation a week-long run still
#: holds a uniform ~8k-sample view of the distribution
HISTOGRAM_CAP = 8192


class Counter:
    """Monotonic float counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter increment must be >= 0, got {v}")
        self.value += v


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def dec(self, v: float = 1.0) -> None:
        self.value -= v


class Histogram:
    """Sample-retaining histogram with bounded memory.

    Keeps every ``stride``-th observation; when the reservoir hits
    ``cap`` it is decimated 2x and the stride doubles, so the retained
    samples stay a uniform subsample of the full series.  ``count`` and
    ``sum`` are always exact.
    """

    __slots__ = ("count", "sum", "_samples", "_stride", "_phase", "cap")

    def __init__(self, cap: int = HISTOGRAM_CAP):
        self.count = 0
        self.sum = 0.0
        self.cap = cap
        self._samples: List[float] = []
        self._stride = 1
        self._phase = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self._phase += 1
        if self._phase >= self._stride:
            self._phase = 0
            self._samples.append(v)
            if len(self._samples) >= self.cap:
                self._samples = self._samples[::2]
                self._stride *= 2

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    @property
    def samples(self) -> List[float]:
        return list(self._samples)

    def percentile(self, q: float) -> float:
        if not self._samples:
            return 0.0
        return float(np.percentile(self._samples, q))

    def summary(self) -> Dict[str, float]:
        return {
            "count": float(self.count), "sum": self.sum, "mean": self.mean,
            "p50": self.percentile(50), "p90": self.percentile(90),
            "p99": self.percentile(99),
            "max": float(max(self._samples)) if self._samples else 0.0,
        }


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Families of labeled metrics, created on first touch.

    ``registry.counter("requests_total", status="done").inc()`` -- the
    family ``requests_total`` is fixed to kind=counter and label set
    ``("status",)`` at first use; a later touch with a different kind or
    label set is a bug and raises.
    """

    def __init__(self):
        # name -> (kind, label_names, {label_values_tuple: metric})
        self._families: Dict[str, Tuple[str, Tuple[str, ...], Dict]] = {}

    # ------------- touch-or-create -------------

    def _get(self, kind: str, name: str, labels: Dict[str, str]):
        label_names = tuple(sorted(labels))
        fam = self._families.get(name)
        if fam is None:
            fam = (kind, label_names, {})
            self._families[name] = fam
        if fam[0] != kind:
            raise ValueError(f"metric {name!r} is a {fam[0]}, not a {kind}")
        if fam[1] != label_names:
            raise ValueError(f"metric {name!r} has labels {fam[1]}, "
                             f"got {label_names}")
        key = tuple(str(labels[k]) for k in label_names)
        child = fam[2].get(key)
        if child is None:
            child = _KINDS[kind]()
            fam[2][key] = child
        return child

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels)

    # ------------- read side -------------

    def value(self, name: str, **labels) -> float:
        """Current value of a counter/gauge; 0.0 if never touched."""
        fam = self._families.get(name)
        if fam is None:
            return 0.0
        key = tuple(str(labels[k]) for k in fam[1])
        child = fam[2].get(key)
        return child.value if child is not None else 0.0

    def family_samples(self, name: str) -> List[float]:
        """Concatenated retained samples across all children of a
        histogram family (e.g. ``step_s`` over both compile labels)."""
        fam = self._families.get(name)
        if fam is None:
            return []
        out: List[float] = []
        for child in fam[2].values():
            out.extend(child._samples)
        return out

    def family_total(self, name: str) -> float:
        """Summed value across all children of a counter/gauge family --
        e.g. ``tier_hit_total`` over every ``kind=...`` label."""
        fam = self._families.get(name)
        if fam is None or fam[0] == "histogram":
            return 0.0
        return float(sum(c.value for c in fam[2].values()))

    def family_count(self, name: str) -> float:
        fam = self._families.get(name)
        if fam is None:
            return 0.0
        return float(sum(c.count for c in fam[2].values()))

    def as_dict(self) -> Dict[str, float]:
        """Flat ``name{label="v"} -> value`` snapshot (histograms summarize
        as ``name_count`` / ``name_sum``)."""
        out: Dict[str, float] = {}
        for name, (kind, label_names, children) in sorted(
                self._families.items()):
            for key, child in sorted(children.items()):
                lbl = ",".join(f'{k}="{v}"'
                               for k, v in zip(label_names, key))
                suffix = "{" + lbl + "}" if lbl else ""
                if kind == "histogram":
                    out[f"{name}_count{suffix}"] = float(child.count)
                    out[f"{name}_sum{suffix}"] = child.sum
                else:
                    out[f"{name}{suffix}"] = child.value
        return out

    def summaries(self) -> Dict[str, Dict[str, float]]:
        """Histogram summaries keyed by ``name{labels}`` -- what
        a benchmark can embed in its report."""
        out: Dict[str, Dict[str, float]] = {}
        for name, (kind, label_names, children) in sorted(
                self._families.items()):
            if kind != "histogram":
                continue
            for key, child in sorted(children.items()):
                lbl = ",".join(f'{k}="{v}"'
                               for k, v in zip(label_names, key))
                full = name + ("{" + lbl + "}" if lbl else "")
                out[full] = child.summary()
        return out

    # ------------- prometheus text exposition -------------

    def prometheus_text(self) -> str:
        """The registry in Prometheus text exposition format (histograms
        render as summaries: quantile children + _count/_sum)."""
        lines: List[str] = []
        for name, (kind, label_names, children) in sorted(
                self._families.items()):
            pname = _prom_name(name)
            ptype = "summary" if kind == "histogram" else kind
            lines.append(f"# TYPE {pname} {ptype}")
            for key, child in sorted(children.items()):
                base = list(zip(label_names, key))
                if kind == "histogram":
                    for q in (0.5, 0.9, 0.99):
                        lbl = _prom_labels(base + [("quantile", str(q))])
                        lines.append(f"{pname}{lbl} "
                                     f"{child.percentile(q * 100):g}")
                    lbl = _prom_labels(base)
                    lines.append(f"{pname}_count{lbl} {child.count}")
                    lines.append(f"{pname}_sum{lbl} {child.sum:g}")
                else:
                    lines.append(
                        f"{pname}{_prom_labels(base)} {child.value:g}")
        return "\n".join(lines) + ("\n" if lines else "")


def _prom_name(name: str) -> str:
    out = "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)
    return out if not out[:1].isdigit() else "_" + out


def _prom_labels(pairs: Iterable[Tuple[str, str]]) -> str:
    pairs = list(pairs)
    if not pairs:
        return ""
    inner = ",".join(f'{_prom_name(k)}="{v}"' for k, v in pairs)
    return "{" + inner + "}"
