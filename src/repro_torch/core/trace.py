"""Timeline export: chrome://tracing JSON + CSV.

``op_events`` is the single source of the per-op Trace Event schema; the
richer exporter in :mod:`repro_torch.analysis.export` layers phase and occupancy
tracks on top of the same events.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.engine import SimReport
from repro_torch.obs.export import duration_event, trace_json

#: chrome-trace thread id per bottleneck unit
LANES: Dict[str, int] = {"mxu": 0, "vpu": 1, "hbm": 2, "ici": 3,
                         "overhead": 4}


def op_events(report: SimReport) -> List[dict]:
    """One ``ph: X`` duration event per timeline entry, laned by unit."""
    events = []
    for e in report.timeline:
        events.append(duration_event(
            f"{e.opcode}:{e.name}"
            + (f" x{int(e.scale)}" if e.scale > 1 else ""),
            e.unit, e.start, e.duration * e.scale,
            tid=LANES.get(e.unit, 5),
            args={"flops": e.flops, "hbm_bytes": e.hbm_bytes,
                  "ici_bytes": e.ici_bytes, "scale": e.scale,
                  "overhead_s": e.overhead_s, "exposed_s": e.exposed_s,
                  "comp": e.comp}))
    return events


def to_chrome_trace(report: SimReport) -> str:
    return trace_json(op_events(report))


def to_csv(report: SimReport) -> str:
    rows = ["name,opcode,unit,start_s,duration_s,scale,flops,hbm_bytes,ici_bytes"]
    for e in report.timeline:
        rows.append(f"{e.name},{e.opcode},{e.unit},{e.start:.4e},"
                    f"{e.duration:.4e},{e.scale},{e.flops:.4e},"
                    f"{e.hbm_bytes:.4e},{e.ici_bytes:.4e}")
    return "\n".join(rows)
