"""AerialVision analogue (paper §V, Figures 9-25): time-bucketed utilization
timelines over simulated execution.

Where the paper plots per-DRAM-bank efficiency and per-shader IPC per cycle,
we bucket the engine timeline and report:

* per-HBM-channel occupancy (channel model: contiguous ops stripe across all
  channels; gather/scatter/dynamic-* concentrate on a subset -> the paper's
  *bank camping* analogue, "channel camping");
* per-unit (MXU / VPU / HBM-bound / ICI) busy fraction per bucket -> the
  "shader IPC" phase plots;
* FLOP-retire rate per bucket -> "global IPC";
* phase segmentation: contiguous buckets with the same dominant unit.

Outputs CSV rows + a terminal ASCII heatmap (the paper's PDF plots, rendered
for a repo).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.engine import SimReport, TimelineEntry
from repro_torch.core.hw import HardwareSpec, V5E
# camping classifier + channel split are single-sourced in
# repro_torch.memory.channels; re-exported here for backward compatibility (this
# module defined them before the memory subsystem existed)
from repro_torch.memory.channels import (CAMPING_FRACTION, CAMPING_OPS,
                                   is_camping_op, legacy_channel_bytes)


@dataclass
class Bucket:
    t0: float
    t1: float
    unit_busy: Dict[str, float] = field(default_factory=dict)
    flops: float = 0.0
    hbm_bytes: float = 0.0
    channel_bytes: Optional[List[float]] = None


@dataclass
class VisionReport:
    buckets: List[Bucket]
    phases: List[Tuple[float, float, str]]    # (t0, t1, dominant unit)
    camping_index: float     # max-channel/mean-channel traffic (1.0 = balanced)

    def to_csv(self) -> str:
        n_ch = len(self.buckets[0].channel_bytes) if self.buckets else 0
        hdr = ["t0", "t1", "flops", "hbm_bytes", "mxu", "vpu", "hbm", "ici"]
        hdr += [f"ch{i}" for i in range(n_ch)]
        rows = [",".join(hdr)]
        for b in self.buckets:
            row = [f"{b.t0:.3e}", f"{b.t1:.3e}", f"{b.flops:.3e}",
                   f"{b.hbm_bytes:.3e}"]
            row += [f"{b.unit_busy.get(u, 0.0):.3f}"
                    for u in ("mxu", "vpu", "hbm", "ici")]
            row += [f"{c:.3e}" for c in (b.channel_bytes or [])]
            rows.append(",".join(row))
        return "\n".join(rows)

    def ascii_heatmap(self, width: int = 72) -> str:
        """Per-unit busy-fraction heatmap over time (the AerialVision plot)."""
        if not self.buckets:
            return "(empty timeline)"
        shades = " .:-=+*#%@"
        lines = []
        stride = max(len(self.buckets) // width, 1)
        for unit in ("mxu", "vpu", "hbm", "ici"):
            cells = []
            for i in range(0, len(self.buckets), stride):
                window = self.buckets[i:i + stride]
                v = sum(b.unit_busy.get(unit, 0.0) for b in window) / len(window)
                cells.append(shades[min(int(v * (len(shades) - 1)), len(shades) - 1)])
            lines.append(f"{unit:>4s} |{''.join(cells)}|")
        total = self.buckets[-1].t1
        lines.append(f"     0s {'-' * (width - 14)} {total:.3e}s")
        return "\n".join(lines)


def analyze(report: SimReport, hw: HardwareSpec = V5E,
            num_buckets: int = 200) -> VisionReport:
    if not report.timeline:
        return VisionReport([], [], 1.0)
    # expand scaled entries (while bodies) by tiling them across their span
    end_time = max(e.start + e.duration * e.scale for e in report.timeline)
    end_time = max(end_time, report.total_seconds, 1e-12)
    width = end_time / num_buckets
    buckets = [Bucket(i * width, (i + 1) * width,
                      channel_bytes=[0.0] * hw.hbm_channels)
               for i in range(num_buckets)]
    chan_totals = [0.0] * hw.hbm_channels

    for e in report.timeline:
        span = e.duration * e.scale
        if span <= 0:
            continue
        t0, t1 = e.start, e.start + span
        b0 = min(int(t0 / width), num_buckets - 1)
        b1 = min(int(t1 / width), num_buckets - 1)
        # channel shares: the engine's placement-derived split when present
        # (memory model), else the same single-sourced legacy model the
        # analysis.channels detector uses — the two views must agree on
        # which channels an op camps
        vec = e.channel_bytes
        if not (vec is not None and len(vec) == hw.hbm_channels
                and sum(vec) > 0):
            vec = legacy_channel_bytes(e.opcode, e.name, 1.0, hw.hbm_channels)
        vsum = sum(vec)
        shares = [(ch, v / vsum) for ch, v in enumerate(vec) if v > 0] \
            if vsum > 0 else []
        for bi in range(b0, b1 + 1):
            b = buckets[bi]
            o0, o1 = max(t0, b.t0), min(t1, b.t1)
            frac = max(o1 - o0, 0.0) / span
            b.unit_busy[e.unit] = min(
                b.unit_busy.get(e.unit, 0.0) + (o1 - o0) / width, 1.0)
            b.flops += e.flops * e.scale * frac
            bytes_here = e.hbm_bytes * e.scale * frac
            b.hbm_bytes += bytes_here
            for ch, share in shares:
                b.channel_bytes[ch] += bytes_here * share
                chan_totals[ch] += bytes_here * share

    mean_ch = sum(chan_totals) / max(len(chan_totals), 1)
    camping_index = (max(chan_totals) / mean_ch) if mean_ch > 0 else 1.0

    # phase segmentation by dominant unit
    phases: List[Tuple[float, float, str]] = []
    cur_unit, cur_t0 = None, 0.0
    for b in buckets:
        unit = max(b.unit_busy, key=b.unit_busy.get) if b.unit_busy else "idle"
        if unit != cur_unit:
            if cur_unit is not None:
                phases.append((cur_t0, b.t0, cur_unit))
            cur_unit, cur_t0 = unit, b.t0
    if cur_unit is not None:
        phases.append((cur_t0, buckets[-1].t1, cur_unit))
    return VisionReport(buckets, phases, camping_index)
