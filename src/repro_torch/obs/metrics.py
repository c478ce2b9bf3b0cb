"""Labeled counter/gauge/histogram registry — one interface for the
simulator's scattered operational counters.

Before this module, every layer grew its own tally: ``SimulationCache``
kept ``hits``/``misses`` attributes, the cluster loop kept HoL and
failure/reshape locals, and both CLIs re-implemented ``--self-profile``
stage timers.  They all still *compute* their numbers locally (hot loops
stay allocation-free), but they now publish into one process-wide
:class:`MetricsRegistry`, so "what happened in this process" is a single
queryable snapshot — the same reason production systems standardize on a
Prometheus-style registry instead of per-module globals.

Model (deliberately tiny, prometheus-shaped):

* :class:`Counter`   — monotone float, ``inc(v)``;
* :class:`Gauge`     — last-write-wins float, ``set(v)``;
* :class:`Histogram` — fixed-bucket counts + sum/count/min/max,
  ``observe(v)`` — enough for stage-latency distributions without
  keeping every sample.

Families are keyed by metric name; children by their sorted label tuple::

    from repro_torch.obs.metrics import REGISTRY
    REGISTRY.counter("sim_cache_hits_total").inc()
    REGISTRY.counter("cluster_hol_events_total", policy="fifo").inc(3)
    REGISTRY.histogram("stage_seconds", cli="cluster",
                       stage="events").observe(1.25)
    REGISTRY.snapshot()   # {"cluster_hol_events_total{policy=fifo}": 3.0, ...}

:class:`StageTimer` is the shared ``--self-profile`` implementation both
CLIs use (one code path instead of two copy-pasted ``mark()`` closures):
it records per-stage wall seconds as registry histograms AND returns the
plain ``{stage: seconds}`` dict the JSON exports embed.
"""
from __future__ import annotations

import json
import time
from bisect import bisect_right
from typing import Any, Dict, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _render_key(name: str, labels: LabelKey) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotone counter child (one label set of one family)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counters only go up, got inc({v})")
        self.value += v


class Gauge:
    """Last-write-wins value child."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def dec(self, v: float = 1.0) -> None:
        self.value -= v


#: default histogram bucket upper bounds (seconds-flavored, log-spaced)
DEFAULT_BUCKETS = (0.001, 0.01, 0.1, 1.0, 10.0, 100.0)


class Histogram:
    """Fixed-bucket histogram child: counts per le-bucket + aggregates."""

    __slots__ = ("bounds", "bucket_counts", "count", "sum", "min", "max")

    def __init__(self, bounds: Sequence[float] = DEFAULT_BUCKETS):
        self.bounds = tuple(sorted(bounds))
        self.bucket_counts = [0] * (len(self.bounds) + 1)  # +inf tail
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        self.bucket_counts[bisect_right(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "sum": self.sum, "mean": self.mean,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "buckets": {("+inf" if i == len(self.bounds)
                             else repr(self.bounds[i])): c
                            for i, c in enumerate(self.bucket_counts) if c}}


class MetricsRegistry:
    """Name+labels -> child instrument store with one snapshot interface."""

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        #: name -> (kind, {label key -> child})
        self._families: Dict[str, Tuple[str, Dict[LabelKey, Any]]] = {}

    def _child(self, kind: str, name: str, labels: Dict[str, Any],
               **ctor: Any):
        fam = self._families.get(name)
        if fam is None:
            fam = (kind, {})
            self._families[name] = fam
        elif fam[0] != kind:
            raise TypeError(f"metric {name!r} already registered as "
                            f"{fam[0]}, requested {kind}")
        key = _label_key(labels)
        child = fam[1].get(key)
        if child is None:
            child = self._KINDS[kind](**ctor)
            fam[1][key] = child
        return child

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._child("counter", name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._child("gauge", name, labels)

    def histogram(self, name: str, buckets: Sequence[float] = DEFAULT_BUCKETS,
                  **labels: Any) -> Histogram:
        return self._child("histogram", name, labels, bounds=buckets)

    # -- reading --------------------------------------------------------
    def get(self, name: str, **labels: Any) -> Optional[Any]:
        """The child for this exact (name, labels), or None (never creates)."""
        fam = self._families.get(name)
        if fam is None:
            return None
        return fam[1].get(_label_key(labels))

    def value(self, name: str, **labels: Any) -> float:
        """Counter/gauge value (0.0 when absent); histograms return sum."""
        child = self.get(name, **labels)
        if child is None:
            return 0.0
        return child.sum if isinstance(child, Histogram) else child.value

    def snapshot(self) -> Dict[str, Any]:
        """Flat ``{rendered name: value-or-histogram-dict}`` of everything."""
        out: Dict[str, Any] = {}
        for name, (kind, children) in sorted(self._families.items()):
            for key, child in sorted(children.items()):
                rk = _render_key(name, key)
                out[rk] = (child.to_dict() if kind == "histogram"
                           else child.value)
        return out

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def clear(self) -> None:
        self._families.clear()

    def __len__(self) -> int:
        return sum(len(children) for _k, children in self._families.values())


#: the process-wide registry every instrumented layer publishes into
REGISTRY = MetricsRegistry()


class StageTimer:
    """The one ``--self-profile`` implementation (satellite of ISSUE 8).

    Both CLIs previously carried a private ``mark()`` closure over a
    ``prof`` dict; this is that closure, once, publishing each stage's
    wall seconds as a ``stage_seconds`` histogram labeled by CLI so
    repeated runs in one process accumulate a distribution::

        timer = StageTimer("cluster")
        ...capture work...
        timer.mark("capture")
        ...
        timer.stage_seconds     # {"capture": 1.25, ...} for JSON exports
        timer.render()          # the --self-profile stderr table

    Timing is always on (a ``perf_counter`` per stage boundary is free);
    ``--self-profile`` only controls whether the table is *printed*, so
    the JSON exports can carry ``stage_seconds`` unconditionally.
    """

    def __init__(self, cli: str, registry: Optional[MetricsRegistry] = None):
        self.cli = cli
        self.registry = REGISTRY if registry is None else registry
        self.stage_seconds: Dict[str, float] = {}
        self._last = time.perf_counter()

    def mark(self, stage: str) -> float:
        """Close the stage that just ran; returns its wall seconds."""
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self.stage_seconds[stage] = self.stage_seconds.get(stage, 0.0) + dt
        self.registry.histogram("stage_seconds", cli=self.cli,
                                stage=stage).observe(dt)
        return dt

    @property
    def total_seconds(self) -> float:
        return sum(self.stage_seconds.values())

    def render(self) -> str:
        """The ``--self-profile`` table (one line per stage + total)."""
        total = self.total_seconds
        lines = ["self-profile (wall-clock):"]
        for stage, sec in self.stage_seconds.items():
            share = sec / total * 100 if total > 0 else 0.0
            lines.append(f"  {stage:<8s} {sec:8.3f} s  {share:5.1f}%")
        lines.append(f"  {'total':<8s} {total:8.3f} s")
        return "\n".join(lines)
