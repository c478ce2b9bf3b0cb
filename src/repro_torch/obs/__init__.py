"""repro_torch.obs — the observability modules the simulator core needs.

* :mod:`repro_torch.obs.trace`      — hierarchical span tracer (the
  simulator's own wall-clock flight recorder, instrumented through engine /
  fastsched / topology);
* :mod:`repro_torch.obs.metrics`    — labeled counter/gauge/histogram
  registry, plus :class:`~repro_torch.obs.metrics.StageTimer`;
* :mod:`repro_torch.obs.export`     — the Chrome Trace Event Format helper
  set and the shared ASCII shade ramp;
* :mod:`repro_torch.obs.thresholds` — the single source of truth for every
  "how hot is pathological" cutoff.

These four are dependency-free and imported eagerly: the engine imports
them at module load.  The time-lapse, manifest, diff and doctor layers of
the reference package are not ported yet, so no lazy names are exposed.
"""
from __future__ import annotations

from repro_torch.obs.export import (SHADES, counter_event, duration_event,
                                    instant_event, shade, thread_meta,
                                    trace_json)
from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge, Histogram,
                                     MetricsRegistry, StageTimer)
from repro_torch.obs.thresholds import DEFAULT_THRESHOLDS, Thresholds
from repro_torch.obs.trace import SELF_PID, SpanRecord, SpanTracer, TRACER

__all__ = [
    "TRACER", "SpanTracer", "SpanRecord", "SELF_PID",
    "REGISTRY", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "StageTimer",
    "SHADES", "shade", "thread_meta", "duration_event", "counter_event",
    "instant_event", "trace_json",
    "Thresholds", "DEFAULT_THRESHOLDS",
]
