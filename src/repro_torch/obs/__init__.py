"""repro_torch.obs — cross-layer observability: spans, metrics, time-lapse, diff.

The paper's central methodological tool is AerialVision: per-interval
time-lapse plots that exposed cuDNN's "many varying phases" and
partition-bank camping where aggregate counters showed nothing (§IV-V).
This package is that methodology applied to the whole simulator stack:

* :mod:`repro_torch.obs.trace`     — hierarchical span tracer (the simulator's
  own wall-clock flight recorder, instrumented through engine /
  fastsched / cluster / topology / faults);
* :mod:`repro_torch.obs.regions`   — regions of the port's model code
  (:func:`region`): profiler ranges in eager steps, a region table of
  node boundaries in each captured CUDA graph, and the markers that find
  a traced replay's device events;
* :mod:`repro_torch.obs.routing`   — a mixture-of-experts FFN's routing
  counts (routed, dropped, experts filled) by compiled step;
* :mod:`repro_torch.obs.metrics`   — labeled counter/gauge/histogram registry
  absorbing the previously scattered counters, plus the shared
  :class:`~repro_torch.obs.metrics.StageTimer` both CLIs use;
* :mod:`repro_torch.obs.export`    — the one Chrome Trace Event Format helper
  set (and the shared ASCII shade ramp), so engine, fleet, span, and
  time-lapse tracks compose into one trace file;
* :mod:`repro_torch.obs.timelapse` — AerialVision-style fixed-interval series
  (unit occupancy, channel-camping index, link utilization, queue
  depth) derived from existing timelines, reconciling to report totals;
* :mod:`repro_torch.obs.manifest` / :mod:`repro_torch.obs.diff` — run manifests and
  the ``python -m repro_torch.obs diff`` regression attributor;
* :mod:`repro_torch.obs.thresholds` — the single source of truth for every
  "how hot is pathological" cutoff (camping, imbalance, exposure);
* :mod:`repro_torch.obs.detectors` / :mod:`repro_torch.obs.whatif` /
  :mod:`repro_torch.obs.doctor` — pluggable pathology detectors, the
  counterfactual what-if pricer (tape replay with patched step prices),
  and the ranked-findings doctor built on both;
* :mod:`repro_torch.obs.sentinel` — the CI regression gate
  (``python -m repro_torch.obs sentinel``, exit 0/3/2) and the
  ``BENCH_doctor.json`` trajectory.

Import structure note: ``trace``/``metrics``/``export``/``regions`` import
nothing of the port beyond each other (``regions`` and ``routing`` import
torch) and are imported eagerly — the engine and cluster layers, the
models and the compiled steps import them at module load.  ``timelapse``/``manifest``/``diff`` reach
back *into* those layers (analysis/cluster), so they are exposed lazily
via module ``__getattr__`` to keep the import graph acyclic.
"""
from __future__ import annotations

from repro_torch.obs.export import (SHADES, counter_event, duration_event,
                                    instant_event, shade, thread_meta, trace_json)
from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge, Histogram,
                                     MetricsRegistry, StageTimer)
from repro_torch.obs.thresholds import DEFAULT_THRESHOLDS, Thresholds
from repro_torch.obs.trace import SELF_PID, SpanRecord, SpanTracer, TRACER
from repro_torch.obs.regions import region

#: lazily-resolved symbols -> defining submodule (these import analysis /
#: cluster, which import the engine, which imports repro_torch.obs.trace — an
#: eager import here would be circular)
_LAZY = {
    "TimeLapse": "repro_torch.obs.timelapse",
    "LapseInterval": "repro_torch.obs.timelapse",
    "CAMPED_THRESHOLD": "repro_torch.obs.timelapse",
    "RunManifest": "repro_torch.obs.manifest",
    "engine_manifest": "repro_torch.obs.manifest",
    "cluster_manifest": "repro_torch.obs.manifest",
    "ManifestDiff": "repro_torch.obs.diff",
    "MetricDelta": "repro_torch.obs.diff",
    "diff_manifests": "repro_torch.obs.diff",
    "metric_layer": "repro_torch.obs.diff",
    "resample_lapse_doc": "repro_torch.obs.diff",
    "Finding": "repro_torch.obs.detectors",
    "run_engine_detectors": "repro_torch.obs.detectors",
    "run_cluster_detectors": "repro_torch.obs.detectors",
    "WhatIf": "repro_torch.obs.whatif",
    "whatif_engine": "repro_torch.obs.whatif",
    "whatif_all": "repro_torch.obs.whatif",
    "DoctorReport": "repro_torch.obs.doctor",
    "diagnose_engine": "repro_torch.obs.doctor",
    "diagnose_cluster": "repro_torch.obs.doctor",
    "diagnose_demo": "repro_torch.obs.doctor",
    "SentinelReport": "repro_torch.obs.sentinel",
    "MetricVerdict": "repro_torch.obs.sentinel",
    "sentinel_compare": "repro_torch.obs.sentinel",
    "trajectory_entry": "repro_torch.obs.sentinel",
    "append_trajectory": "repro_torch.obs.sentinel",
    "parse_tolerances": "repro_torch.obs.sentinel",
}


def __getattr__(name: str):
    mod_name = _LAZY.get(name)
    if mod_name is None:
        raise AttributeError(f"module 'repro_torch.obs' has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod_name), name)


def __dir__():
    return sorted(list(globals()) + list(_LAZY))


__all__ = [
    "TRACER", "SpanTracer", "SpanRecord", "SELF_PID", "region",
    "REGISTRY", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "StageTimer",
    "SHADES", "shade", "thread_meta", "duration_event", "counter_event",
    "instant_event", "trace_json",
    "Thresholds", "DEFAULT_THRESHOLDS",
    "TimeLapse", "LapseInterval", "CAMPED_THRESHOLD",
    "RunManifest", "engine_manifest", "cluster_manifest",
    "ManifestDiff", "MetricDelta", "diff_manifests", "metric_layer",
    "resample_lapse_doc",
    "Finding", "run_engine_detectors", "run_cluster_detectors",
    "WhatIf", "whatif_engine", "whatif_all",
    "DoctorReport", "diagnose_engine", "diagnose_cluster", "diagnose_demo",
    "SentinelReport", "MetricVerdict", "sentinel_compare",
    "trajectory_entry", "append_trajectory", "parse_tolerances",
]
