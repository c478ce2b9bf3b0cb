"""Phase segmentation: turn the bucketed timeline into labeled phases.

The paper's headline observation (§V) is that one cuDNN API call is not one
uniform kernel but a *sequence of phases* — stretches that are compute-bound,
then DRAM-bound, then dominated by kernel-launch overhead — and that naming
those phases is what makes the bottleneck actionable.  This module detects
phase boundaries from shifts in the dominant hardware unit between buckets
and attaches one of four labels:

* ``compute-bound``          — MXU or VPU busy time dominates;
* ``bandwidth-bound``        — HBM traffic is the bottleneck;
* ``ici-exposed``            — collective time not hidden behind compute;
* ``launch-overhead-bound``  — per-op issue cost is the majority of the busy
  time (tiny ops: the paper's Fig. 7 LRN/CGEMM launch-overhead discussion);
* ``idle``                   — nothing scheduled in the bucket.

The dataflow scheduler may run several units concurrently inside one bucket
(compute/collective overlap, multi-stream dispatch); the dominant-unit vote
still picks the unit with the most busy time, and the ``ici-exposed`` label
only wins a bucket when collective time actually outweighs the compute it
could hide behind — consistent with ``SimReport.exposed_seconds``.

Runs of identically-labeled buckets become :class:`Phase` records; runs
shorter than ``min_intervals`` are absorbed into their longer neighbor so
quantization noise at bucket edges does not fragment the segmentation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from repro_torch.analysis.intervals import Interval, IntervalProfile, UNITS

#: dominant-unit -> phase label
UNIT_LABELS = {
    "mxu": "compute-bound",
    "vpu": "compute-bound",
    "hbm": "bandwidth-bound",
    "ici": "ici-exposed",
}

#: issue cost must exceed this fraction of bucket busy time to be "the" story
OVERHEAD_THRESHOLD = 0.5


@dataclass
class Phase:
    """One contiguous, same-bottleneck stretch of the simulated run."""

    t0: float
    t1: float
    label: str                    # one of the module-docstring labels
    dominant_unit: str            # unit that most buckets in the phase vote for
    occupancy: Dict[str, float]   # mean busy fraction per unit over the phase
    flops: float                  # FLOPs retired inside the phase
    hbm_bytes: float
    ici_bytes: float
    ops_retired: float
    n_intervals: int

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def label_interval(iv: Interval) -> str:
    """Classify one bucket (see module docstring for the label set)."""
    total_busy = sum(iv.busy_seconds.values())
    if total_busy <= 0:
        return "idle"
    if iv.overhead_seconds >= OVERHEAD_THRESHOLD * total_busy:
        return "launch-overhead-bound"
    return UNIT_LABELS.get(iv.dominant_unit, "idle")


def segment_phases(profile: IntervalProfile, min_intervals: int = 2
                   ) -> List[Phase]:
    """Segment ``profile`` into labeled phases.

    Boundary = any bucket whose label differs from its predecessor's; runs
    shorter than ``min_intervals`` buckets merge into the longer neighbor
    (debounce), then adjacent same-label runs re-collapse.
    """
    ivs = profile.intervals
    if not ivs:
        return []

    runs: List[List[Interval]] = []
    labels: List[str] = []
    for iv in ivs:
        lab = label_interval(iv)
        if labels and labels[-1] == lab:
            runs[-1].append(iv)
        else:
            runs.append([iv])
            labels.append(lab)

    # debounce: absorb short runs into the longer neighbor, then re-collapse
    changed = True
    while changed and len(runs) > 1:
        changed = False
        for i, run in enumerate(runs):
            if len(run) >= min_intervals:
                continue
            left = len(runs[i - 1]) if i > 0 else -1
            right = len(runs[i + 1]) if i + 1 < len(runs) else -1
            j = i - 1 if left >= right else i + 1
            if j < i:
                runs[j].extend(run)
            else:
                runs[j][:0] = run
            del runs[i], labels[i]
            changed = True
            break
        # collapse neighbors that became same-labeled
        i = 1
        while i < len(runs):
            if labels[i] == labels[i - 1]:
                runs[i - 1].extend(runs[i])
                del runs[i], labels[i]
            else:
                i += 1

    phases = []
    for lab, run in zip(labels, runs):
        span = sum(iv.width for iv in run)
        occ = {u: (sum(iv.busy_seconds.get(u, 0.0) for iv in run) / span
                   if span > 0 else 0.0) for u in UNITS}
        dom = max(occ, key=occ.get) if any(occ.values()) else "idle"
        phases.append(Phase(
            t0=run[0].t0, t1=run[-1].t1, label=lab, dominant_unit=dom,
            occupancy=occ,
            flops=sum(iv.flops for iv in run),
            hbm_bytes=sum(iv.hbm_bytes for iv in run),
            ici_bytes=sum(iv.ici_bytes for iv in run),
            ops_retired=sum(iv.ops_retired for iv in run),
            n_intervals=len(run)))
    return phases


def phase_table(phases: List[Phase]) -> str:
    """Render phases as the terminal table the LeNet repro_torch prints."""
    hdr = (f"{'#':>2} {'label':<22} {'start':>10} {'dur':>10} "
           f"{'mxu%':>5} {'vpu%':>5} {'hbm%':>5} {'ici%':>5} "
           f"{'GFLOP':>8} {'ops':>7}")
    lines = [hdr, "-" * len(hdr)]
    for i, p in enumerate(phases):
        lines.append(
            f"{i:>2} {p.label:<22} {p.t0 * 1e6:>8.1f}us {p.seconds * 1e6:>8.1f}us "
            + " ".join(f"{min(p.occupancy.get(u, 0.0), 1.0) * 100:>5.1f}"
                       for u in UNITS)
            + f" {p.flops / 1e9:>8.3f} {p.ops_retired:>7.0f}")
    return "\n".join(lines)
