"""Exporters: JSON, chrome://tracing, and a terminal ASCII timeline.

Three renderings of the same :class:`~repro_torch.analysis.AnalysisReport`:

* :func:`to_json` — everything (summary, intervals, phases, channels) as one
  JSON document for notebooks / dashboards;
* :func:`to_chrome_trace` — Trace Event Format (load in ``chrome://tracing``
  or Perfetto): per-op duration events on one lane per unit, the detected
  phases as a ``phases`` lane, and per-bucket occupancy counter tracks;
* :func:`ascii_timeline` — the in-terminal AerialVision plot: one shaded row
  per unit plus a phase strip, so the LeNet repro_torch can show its phases in CI
  logs.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.analysis.intervals import IntervalProfile, UNITS
from repro_torch.analysis.phases import Phase
from repro_torch.core.trace import op_events
# the shade ramp and Trace Event constructors live in repro_torch.obs.export now
# (shared with the fleet and time-lapse renderers); SHADES/shade stay
# re-exported here for compatibility
from repro_torch.obs.export import (SHADES, counter_event, duration_event, shade,
                              thread_meta, trace_json)

# chrome-trace thread id for the phase lane (op lanes: core.trace.LANES)
_PHASE_TID = 10


#: one-letter key used by the ASCII phase strip
PHASE_GLYPHS = {
    "compute-bound": "C",
    "bandwidth-bound": "B",
    "ici-exposed": "I",
    "launch-overhead-bound": "L",
    "idle": ".",
}


def to_json(analysis, indent: int = None,
            stage_seconds: Optional[Dict[str, float]] = None) -> str:
    """Serialize a full :class:`~repro_torch.analysis.AnalysisReport` to JSON.

    ``stage_seconds`` (from :class:`repro_torch.obs.metrics.StageTimer`) embeds
    the CLI's wall-clock self-profile in the document.
    """
    prof: IntervalProfile = analysis.profile
    doc = {
        "summary": analysis.report.summary(),
        "hw": analysis.report.hw.name,
        "num_buckets": len(prof.intervals),
        "reconcile_max_rel_error": prof.reconcile(),
        "intervals": [{
            "t0": iv.t0, "t1": iv.t1,
            "occupancy": {u: iv.occupancy(u) for u in UNITS},
            "busy_seconds": dict(iv.busy_seconds),
            "overhead_seconds": iv.overhead_seconds,
            "flops": iv.flops, "hbm_bytes": iv.hbm_bytes,
            "ici_bytes": iv.ici_bytes, "ops_retired": iv.ops_retired,
        } for iv in prof.intervals],
        "phases": [{
            "t0": p.t0, "t1": p.t1, "label": p.label,
            "dominant_unit": p.dominant_unit, "occupancy": p.occupancy,
            "flops": p.flops, "hbm_bytes": p.hbm_bytes,
            "ici_bytes": p.ici_bytes, "ops_retired": p.ops_retired,
        } for p in analysis.phases],
        "channels": {
            "channel_bytes": analysis.channels.channel_bytes,
            "imbalance": analysis.channels.imbalance,
            "camping_bytes": analysis.channels.camping_bytes,
            "hot_channel": analysis.channels.hot_channel,
            "hot_contributors": analysis.channels.hot_contributors,
        },
    }
    if analysis.links is not None:
        doc["links"] = {
            "link_bytes": analysis.links.link_bytes,
            "imbalance": analysis.links.imbalance,
            "camped": analysis.links.camped,
            "hot_link": analysis.links.hot_link,
            "hot_contributors": analysis.links.hot_contributors,
            "link_busy_seconds": analysis.report.link_busy_seconds,
        }
    if stage_seconds is not None:
        doc["stage_seconds"] = dict(stage_seconds)
    return json.dumps(doc, indent=indent)


def to_chrome_trace(analysis, extra_events: Optional[List[dict]] = None) -> str:
    """Trace Event Format JSON: ops + phase lane + occupancy counters.

    ``extra_events`` lets the CLI splice additional tracks (time-lapse
    counters on pid 0, simulator self-spans on pid 1) into the same file.
    """
    events = []
    for tid, lane in [(0, "mxu"), (1, "vpu"), (2, "hbm"), (3, "ici"),
                      (4, "overhead"), (_PHASE_TID, "phases")]:
        events.append(thread_meta(lane, tid))
    events.extend(op_events(analysis.report))
    for p in analysis.phases:
        events.append(duration_event(
            p.label, "phase", p.t0, p.seconds, tid=_PHASE_TID,
            args={"dominant_unit": p.dominant_unit,
                  "occupancy": p.occupancy, "flops": p.flops}))
    for iv in analysis.profile.intervals:
        events.append(counter_event(
            "occupancy", "interval", iv.t0,
            {u: round(iv.occupancy(u), 4) for u in UNITS}))
    # per-link counter track: one sample per collective op, so Perfetto
    # shows WHICH fabric links each transfer landed on over time
    for e in analysis.report.timeline:
        if e.unit == "ici" and getattr(e, "link_bytes", None):
            events.append(counter_event(
                "link_bytes", "link", e.start,
                {l: round(b * e.scale, 1)
                 for l, b in sorted(e.link_bytes.items())}))
    return trace_json(events, extra_events or [])


def ascii_timeline(analysis, width: int = 72) -> str:
    """Terminal rendering: phase strip + per-unit occupancy heat rows."""
    prof = analysis.profile
    if not prof.intervals:
        return "(empty timeline)"
    n = len(prof.intervals)
    stride = max(-(-n // width), 1)   # ceil: never render wider than `width`
    cols = range(0, n, stride)

    def cell_phase(i: int) -> str:
        t = prof.intervals[i].t0
        for p in analysis.phases:
            if p.t0 <= t < p.t1:
                return PHASE_GLYPHS.get(p.label, "?")
        return PHASE_GLYPHS["idle"]

    lines = [f"{'phase':>5s} |{''.join(cell_phase(i) for i in cols)}|"]
    for unit in UNITS:
        cells = []
        for i in cols:
            window = prof.intervals[i:i + stride]
            v = sum(iv.occupancy(unit) for iv in window) / len(window)
            cells.append(shade(v))
        lines.append(f"{unit:>5s} |{''.join(cells)}|")
    lines.append(f"      0s {'-' * max(len(list(cols)) - 10, 4)} "
                 f"{prof.end_time:.3e}s")
    lines.append("      phase key: " + "  ".join(
        f"{g}={lab}" for lab, g in PHASE_GLYPHS.items()))
    return "\n".join(lines)
