"""Fleet-level exporters: chrome://tracing JSON, full-report JSON, ASCII.

The fleet renderings reuse the conventions of :mod:`repro_torch.analysis.export`
one level up the stack: the Chrome trace uses the same Trace Event Format
(one *track per device* instead of per functional unit, job slices as
``ph: X`` duration events, queue depth as a ``ph: C`` counter), and the
ASCII view shades per-device occupancy with the same
:data:`~repro_torch.analysis.export.SHADES` ramp the phase timeline uses — so a
cluster report reads like a zoomed-out phase analysis.

Failure runs add three things to the Chrome trace: ``ph: i`` instant
markers at every device/link failure instant, grey ``down`` slices on the
failed device's own track covering its repair window, and a ``fabric``
track carrying link-outage slices — so a goodput regression can be eyeballed
as "that gang died here and re-restored twice".
"""
from __future__ import annotations

import json
from typing import List, Optional, Tuple

from repro_torch.cluster.events import ClusterReport
from repro_torch.obs.export import (SHADES, counter_event, duration_event,
                                    instant_event, shade, thread_meta, trace_json)

#: counter-track tid, placed after the per-device lanes
_QUEUE_TID_OFFSET = 1000
#: fabric (link outage) track tid
_FABRIC_TID = 1001


def _queue_depth_events(report: ClusterReport) -> List[Tuple[float, int]]:
    """(time, +1/-1) waiting-job deltas, sorted.

    A job waits from arrival to its first slice, and — when preempted —
    over every gap between consecutive slices (the requeue).  At equal
    times the +1 sorts first, so the running depth never dips negative.
    """
    by_job: dict = {}
    for s in report.slices:
        by_job.setdefault(s.job_id, []).append((s.t0, s.t1))
    deltas: List[Tuple[float, int]] = []
    for j in report.jobs:
        prev_end = j.arrival_s
        for t0, t1 in sorted(by_job.get(j.job_id, [])):
            if t0 > prev_end:                      # waiting over [prev_end, t0]
                deltas.append((prev_end, +1))
                deltas.append((t0, -1))
            prev_end = max(prev_end, t1)
    return sorted(deltas, key=lambda d: (d[0], -d[1]))


def fleet_chrome_trace(report: ClusterReport,
                       extra_events: Optional[List[dict]] = None) -> str:
    """Trace Event Format: one track per device + a queue-depth counter.

    ``extra_events`` lets the CLI splice additional tracks (cluster
    time-lapse counters on pid 0, simulator self-spans on pid 1) into the
    same file.
    """
    device_ids = sorted(report.per_device_busy)
    tid = {d: i for i, d in enumerate(device_ids)}
    events: List[dict] = []
    for d, i in tid.items():
        events.append(thread_meta(d, i))
    by_id = {j.job_id: j for j in report.jobs}
    for s in report.slices:
        rec = by_id.get(s.job_id)
        events.append(duration_event(
            (f"{s.job_class}:{s.job_id}" if s.kind == "run"
             else f"{s.kind}:{s.job_class}"),
            s.kind, s.t0, s.t1 - s.t0,
            tid=tid.get(s.device_id, len(tid)),
            args={"job_class": s.job_class, "steps": s.steps,
                  "ckpt_s": s.ckpt_s, "lost_s": s.lost_s,
                  "price_factor": s.price_factor,
                  "user": rec.user if rec else "",
                  "queue_delay_s": rec.queue_delay_s if rec else 0.0}))
    # failure story: instant markers, per-device down windows, fabric track
    for m in report.failure_marks:
        events.append(instant_event(
            f"FAIL {m['target']} {m['key']}", "failure", m["t"],
            tid=tid.get(m["key"], _FABRIC_TID)))
    for dev, intervals in report.down_intervals.items():
        for t0, t1 in intervals:
            events.append(duration_event(
                "down", "down", t0, t1 - t0,
                tid=tid.get(dev, _FABRIC_TID), cname="grey"))
    if report.link_down_intervals:
        events.append(thread_meta("fabric", _FABRIC_TID))
        for key, intervals in sorted(report.link_down_intervals.items()):
            for t0, t1 in intervals:
                events.append(duration_event(
                    f"link {key} down", "down", t0, t1 - t0,
                    tid=_FABRIC_TID, cname="grey"))
    depth = 0
    for t, delta in _queue_depth_events(report):
        depth += delta
        events.append(counter_event("queue_depth", "queue", t,
                                    {"jobs_waiting": depth}))
    return trace_json(events, extra_events or [])


def to_json(report: ClusterReport, indent: int = None) -> str:
    """Full report (summary + per-job records + slices) as one document."""
    doc = {
        "summary": report.summary(),
        "reconcile_busy_rel_error": report.reconcile_busy(),
        "hol_blocked_jobs": list(report.hol_blocked_jobs),
        "per_device_busy": report.per_device_busy,
        "jobs": [{
            "job_id": j.job_id, "job_class": j.job_class, "user": j.user,
            "device_id": j.device_id, "arrival_s": j.arrival_s,
            "start_s": j.start_s, "finish_s": j.finish_s,
            "service_s": j.service_s, "queue_delay_s": j.queue_delay_s,
            "requeue_wait_s": j.requeue_wait_s,
            "total_queue_delay_s": j.total_queue_delay_s,
            "latency_s": j.latency_s, "num_steps": j.num_steps,
            "preemptions": j.preemptions, "cold_starts": j.cold_starts,
            "oversubscribed": j.oversubscribed, "failures": j.failures,
            "restores": j.restores, "lost_work_s": j.lost_work_s,
            "reshapes": j.reshapes,
        } for j in report.jobs],
        "slices": [{
            "device_id": s.device_id, "job_id": s.job_id,
            "job_class": s.job_class, "t0": s.t0, "t1": s.t1,
            "kind": s.kind, "steps": s.steps, "ckpt_s": s.ckpt_s,
            "lost_s": s.lost_s, "price_factor": s.price_factor,
        } for s in report.slices],
        "time_accounting": report.time_accounting(),
        "down_intervals": report.down_intervals,
        "link_down_intervals": report.link_down_intervals,
        "failure_marks": report.failure_marks,
        "stage_seconds": dict(report.stage_seconds),
    }
    return json.dumps(doc, indent=indent)


def fleet_ascii(report: ClusterReport, width: int = 72) -> str:
    """Terminal fleet view: queue-depth strip + one occupancy row per device.

    Same visual grammar as the phase timeline's heat rows (the
    :data:`SHADES` ramp), one row per device instead of per unit.
    """
    if not report.slices or report.makespan_s <= 0:
        return "(empty fleet timeline)"
    dt = report.makespan_s / width
    device_ids = sorted(report.per_device_busy)

    # queue-depth strip: max waiting jobs per column, digits (9+ -> '*')
    depth_cols = [0] * width
    depth, di = 0, 0
    deltas = _queue_depth_events(report)
    for col in range(width):
        t1 = (col + 1) * dt
        peak = depth
        while di < len(deltas) and deltas[di][0] < t1:
            depth += deltas[di][1]
            peak = max(peak, depth)
            di += 1
        depth_cols[col] = peak
    strip = "".join("*" if d > 9 else (str(d) if d else ".")
                    for d in depth_cols)
    lines = [f"{'queue':>13s} |{strip}|"]

    for d in device_ids:
        busy = [0.0] * width
        for s in report.slices:
            if s.device_id != d:
                continue
            c0 = min(int(s.t0 / dt), width - 1)
            c1 = min(int(s.t1 / dt), width - 1)
            for col in range(c0, c1 + 1):
                lo, hi = col * dt, (col + 1) * dt
                busy[col] += max(min(s.t1, hi) - max(s.t0, lo), 0.0)
        lines.append(f"{d:>13s} |{''.join(shade(b / dt) for b in busy)}|")
    lines.append(f"{'':>13s}  0s {'-' * max(width - 24, 4)} "
                 f"{report.makespan_s:.3f}s")
    lines.append(f"{'':>13s}  queue row: waiting jobs; device rows: "
                 f"occupancy ({SHADES[1]}=idle..{SHADES[-1]}=busy)")
    return "\n".join(lines)
