"""Shared Chrome Trace Event Format plumbing + the ASCII shade ramp.

Before this module, :mod:`repro_torch.analysis.export`, :mod:`repro_torch.cluster.
export`, and :mod:`repro_torch.core.trace` each hand-rolled the same raw event
dicts (``ph: M/X/C/i``, ``ts``/``dur`` in microseconds, the 0.01 µs
minimum-visible duration).  Those call sites now build events through the
four constructors here, which is what lets engine op lanes, fleet device
tracks, simulator-self spans (:mod:`repro_torch.obs.trace`), and time-lapse
counter tracks (:mod:`repro_torch.obs.timelapse`) compose into **one** trace
file: identical field conventions, distinct ``pid``/``tid`` namespaces.

pid convention: ``pid 0`` = simulated time (engine ops, fleet slices,
time-lapse counters); ``pid 1`` (:data:`~repro_torch.obs.trace.SELF_PID`) =
simulator wall-clock (spans).  Chrome/Perfetto renders pids as separate
process groups, so the two clock domains never visually interleave.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

#: minimum rendered duration in µs — chrome://tracing drops true-zero slices
MIN_DUR_US = 0.01

#: occupancy shade ramp shared by every ASCII renderer (0.0 -> ' ',
#: 1.0 -> '@'); analysis phase rows, fleet device rows, and time-lapse
#: heat strips all draw from this one ramp
SHADES = " .:-=+*#%@"


def shade(value: float) -> str:
    """Map an occupancy fraction in [0, 1] to one :data:`SHADES` glyph."""
    idx = int(max(value, 0.0) * (len(SHADES) - 1))
    return SHADES[min(idx, len(SHADES) - 1)]


def thread_meta(name: str, tid: int, pid: int = 0) -> Dict[str, Any]:
    """``ph: M`` metadata event naming a track (thread) in the viewer."""
    return {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": name}}


def duration_event(name: str, cat: str, start_s: float, dur_s: float,
                   tid: int, pid: int = 0,
                   args: Optional[Dict[str, Any]] = None,
                   **extra: Any) -> Dict[str, Any]:
    """``ph: X`` complete event; seconds in, µs out, floor-clamped dur.

    ``extra`` passes through rarely-used raw fields (e.g. ``cname``)."""
    ev: Dict[str, Any] = {"name": name, "cat": cat, "ph": "X",
                          "ts": start_s * 1e6,
                          "dur": max(dur_s * 1e6, MIN_DUR_US),
                          "pid": pid, "tid": tid}
    if args is not None:
        ev["args"] = args
    ev.update(extra)
    return ev


def counter_event(name: str, cat: str, t_s: float,
                  values: Dict[str, Any], pid: int = 0,
                  tid: Optional[int] = None) -> Dict[str, Any]:
    """``ph: C`` counter sample (one stacked-area track per name)."""
    ev: Dict[str, Any] = {"name": name, "cat": cat, "ph": "C",
                          "ts": t_s * 1e6, "pid": pid, "args": values}
    if tid is not None:
        ev["tid"] = tid
    return ev


def instant_event(name: str, cat: str, t_s: float, tid: int, pid: int = 0,
                  args: Optional[Dict[str, Any]] = None,
                  scope: str = "g") -> Dict[str, Any]:
    """``ph: i`` instant marker (global scope by default: full-height line)."""
    ev: Dict[str, Any] = {"name": name, "cat": cat, "ph": "i", "s": scope,
                          "ts": t_s * 1e6, "pid": pid, "tid": tid}
    if args is not None:
        ev["args"] = args
    return ev


def trace_json(events: List[dict], *more: List[dict]) -> str:
    """Wrap event lists (concatenated in order) as a Trace Event JSON doc.

    This is the compose point: ``trace_json(op_events, span_events,
    lapse_events)`` yields one file with every track."""
    merged: List[dict] = list(events)
    for lst in more:
        merged.extend(lst)
    return json.dumps({"traceEvents": merged, "displayTimeUnit": "ns"})
