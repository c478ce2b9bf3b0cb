"""Interval profiler: bin the engine timeline into N equal time buckets.

The paper's Figures 4/5 plot per-cycle-window statistics (global IPC,
per-shader IPC, DRAM efficiency) over the lifetime of each cuDNN API call
because *"there are many varying phases"* inside one call that aggregate
counters hide.  This module is the TPU analogue: every
:class:`~repro_torch.core.engine.TimelineEntry` is smeared over its wall-clock span
``[start, start + duration*scale)`` and apportioned to fixed-width buckets,
yielding per-bucket MXU/VPU/HBM/ICI busy time, FLOP-retire rate and
instruction (HLO-op) throughput.

Conservation property (tested): summing any quantity over all intervals
reproduces the :class:`~repro_torch.core.engine.SimReport` whole-run totals, so the
bucketed view is a strict refinement of ``SimReport.summary()`` — not a
re-estimate.  This holds on OVERLAPPED timelines too: the dataflow scheduler
may run several units concurrently (a bucket's summed busy time can exceed
its width even at scale=1), but each entry's busy seconds land in exactly
the buckets its span covers, so the sums are untouched by overlap.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from repro_torch.core.engine import RESOURCES, SimReport

#: resources shown in per-bucket displays, in display order (a subset of the
#: engine's RESOURCES: the issue slot is reported via ``overhead_seconds``
#: and the launch-overhead phase label rather than its own occupancy row)
UNITS = ("mxu", "vpu", "hbm", "ici")


@dataclass
class Interval:
    """One time bucket of the profiled run.

    ``busy_seconds`` can exceed the bucket width inside trip-count-scaled
    regions (a while body recorded once but representing ``scale``
    iterations); :meth:`occupancy` is therefore clamped for display while the
    raw seconds keep the conservation property exact.
    """

    index: int
    t0: float
    t1: float
    busy_seconds: Dict[str, float] = field(default_factory=dict)
    overhead_seconds: float = 0.0     # launch/issue cost inside this bucket
    flops: float = 0.0
    hbm_bytes: float = 0.0
    ici_bytes: float = 0.0
    ops_retired: float = 0.0          # scale-weighted HLO ops finishing here

    @property
    def width(self) -> float:
        return self.t1 - self.t0

    def occupancy(self, unit: str) -> float:
        """Busy fraction of this bucket for ``unit``, clamped to [0, 1]."""
        if self.width <= 0:
            return 0.0
        return min(self.busy_seconds.get(unit, 0.0) / self.width, 1.0)

    @property
    def flops_per_s(self) -> float:
        return self.flops / self.width if self.width > 0 else 0.0

    @property
    def ops_per_s(self) -> float:
        """Instruction throughput — the paper's "global IPC" analogue."""
        return self.ops_retired / self.width if self.width > 0 else 0.0

    @property
    def dominant_unit(self) -> str:
        if not self.busy_seconds or sum(self.busy_seconds.values()) <= 0:
            return "idle"
        return max(UNITS, key=lambda u: self.busy_seconds.get(u, 0.0))


@dataclass
class IntervalProfile:
    """The bucketed timeline plus the report it was derived from."""

    report: SimReport
    intervals: List[Interval]

    @property
    def end_time(self) -> float:
        return self.intervals[-1].t1 if self.intervals else 0.0

    def totals(self) -> Dict[str, float]:
        """Sums over buckets — must reconcile with ``report.summary()``."""
        out = {
            "total_flops": sum(iv.flops for iv in self.intervals),
            "total_hbm_bytes": sum(iv.hbm_bytes for iv in self.intervals),
            "total_ici_bytes": sum(iv.ici_bytes for iv in self.intervals),
            "launch_overhead_seconds": sum(iv.overhead_seconds
                                           for iv in self.intervals),
        }
        for u in RESOURCES:
            out[f"unit_{u}_seconds"] = sum(iv.busy_seconds.get(u, 0.0)
                                           for iv in self.intervals)
        return out

    def reconcile(self) -> float:
        """Max relative error between bucket sums and report totals.

        The acceptance bar for the whole subsystem: < 1%.  Applies to FULL
        reports: a ``window=`` report's buckets deliberately cover only the
        detailed ops, while ``summary()`` totals include fast-forwarded
        work, so the two are expected to diverge there.
        """
        ref = self.report.summary()
        got = self.totals()
        worst = 0.0
        for key, val in got.items():
            expect = ref.get(key, 0.0)
            if expect <= 0:
                continue
            worst = max(worst, abs(val - expect) / expect)
        return worst


def profile_intervals(report: SimReport, num_buckets: int = 120
                      ) -> IntervalProfile:
    """Bin ``report.timeline`` into ``num_buckets`` equal-width intervals.

    Each entry's per-iteration cost is scaled by its trip count and spread
    uniformly over its span; zero-duration entries (pure-overhead ops) are
    attributed wholly to the bucket containing their start time.
    """
    if num_buckets <= 0:
        raise ValueError(f"num_buckets must be positive, got {num_buckets}")
    if not report.timeline:
        return IntervalProfile(report, [])
    end = max(e.start + e.duration * e.scale for e in report.timeline)
    end = max(end, report.total_seconds, 1e-12)
    width = end / num_buckets
    ivs = [Interval(i, i * width, (i + 1) * width) for i in range(num_buckets)]

    for e in report.timeline:
        span = e.duration * e.scale
        if span <= 0:
            bi = min(int(e.start / width), num_buckets - 1)
            ivs[bi].ops_retired += e.scale
            continue
        t0, t1 = e.start, e.start + span
        b0 = min(int(t0 / width), num_buckets - 1)
        b1 = min(int(t1 / width), num_buckets - 1)
        for bi in range(b0, b1 + 1):
            iv = ivs[bi]
            frac = max(min(t1, iv.t1) - max(t0, iv.t0), 0.0) / span
            if frac <= 0 and not (b0 == b1):
                continue
            if b0 == b1:
                frac = 1.0   # guard FP loss when the entry fits one bucket
            iv.busy_seconds[e.unit] = (iv.busy_seconds.get(e.unit, 0.0)
                                       + span * frac)
            iv.overhead_seconds += e.overhead_s * e.scale * frac
            iv.flops += e.flops * e.scale * frac
            iv.hbm_bytes += e.hbm_bytes * e.scale * frac
            iv.ici_bytes += e.ici_bytes * e.scale * frac
            iv.ops_retired += e.scale * frac
    return IntervalProfile(report, ivs)
