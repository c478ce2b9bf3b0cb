"""repro_torch.analysis — AerialVision for the TPU simulator (paper §V).

The engine (:mod:`repro_torch.core.engine`) answers *how long* a workload takes;
this package answers *why*, the way the paper's AerialVision plots do for
GPGPU-Sim: it post-processes ``SimReport.timeline`` into time-bucketed,
per-unit views and names the phases.

Components
----------
* :mod:`repro_torch.analysis.intervals` — bin the timeline into N buckets with
  per-bucket MXU/VPU/HBM/ICI occupancy and instruction/FLOP throughput
  (the paper's per-cycle-window IPC plots, Fig. 4/5);
* :mod:`repro_torch.analysis.phases`    — detect phase boundaries from shifts in
  the dominant unit and label each phase compute-bound / bandwidth-bound /
  ici-exposed / launch-overhead-bound;
* :mod:`repro_torch.analysis.channels`  — aggregate the engine's per-op channel
  splits (``TimelineEntry.channel_bytes``, placed by :mod:`repro_torch.memory`)
  and report the imbalance (the partition-camping detector, Fig. 22-25);
* :mod:`repro_torch.analysis.links`     — the same detector for the ICI fabric:
  aggregate the engine's per-collective link splits
  (``TimelineEntry.link_bytes``, lowered by :mod:`repro_torch.topology`) and flag
  *link camping* (one mesh axis' links gating the fabric);
* :mod:`repro_torch.analysis.export`    — JSON / chrome://tracing / terminal ASCII
  renderings of all of the above.

Usage
-----
::

    from repro_torch.core import Simulator
    sim = Simulator()                         # the h100 spec by default
    cap = sim.capture(step_fn, *example_args)
    rep = sim.performance(cap)

    ar = sim.analysis(rep, num_buckets=120)   # or rep.analysis()
    print(ar.phase_table())                   # labeled phase breakdown
    print(ar.ascii_timeline())                # terminal heatmap + phase strip
    print(ar.channels.table())                # per-HBM-channel traffic bars
    open("trace.json", "w").write(ar.to_chrome_trace())  # chrome://tracing

CLI::

    PYTHONPATH=src python -m repro_torch.analysis lenet --device cpu \\
        --buckets 120 --chrome-trace /tmp/lenet_trace.json

The modules are copies of the reference package's ``repro.analysis`` with
the import prefix changed; ``tests/test_torch_analysis.py`` holds their
output to the reference's bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from repro_torch.analysis.channels import (CAMPING_OPS, ChannelReport,
                                     channel_traffic)
from repro_torch.analysis.export import ascii_timeline, to_chrome_trace, to_json
from repro_torch.analysis.intervals import (Interval, IntervalProfile, UNITS,
                                      profile_intervals)
from repro_torch.analysis.links import (LINK_CAMPING_THRESHOLD, LinkReport,
                                  link_traffic)
from repro_torch.analysis.phases import (Phase, label_interval, phase_table,
                                   segment_phases)
from repro_torch.core.engine import SimReport
from repro_torch.core.hw import HardwareSpec


@dataclass
class AnalysisReport:
    """Bundled phase-analysis views of one :class:`SimReport`."""

    report: SimReport
    profile: IntervalProfile
    phases: List[Phase]
    channels: ChannelReport
    #: per-ICI-link traffic view (the fabric camping detector); None only on
    #: reports built by pre-topology callers that bypass :func:`analyze`
    links: Optional[LinkReport] = None

    def phase_table(self) -> str:
        return phase_table(self.phases)

    def ascii_timeline(self, width: int = 72) -> str:
        return ascii_timeline(self, width)

    def to_json(self, indent: Optional[int] = None,
                stage_seconds=None) -> str:
        return to_json(self, indent=indent, stage_seconds=stage_seconds)

    def to_chrome_trace(self, extra_events=None) -> str:
        return to_chrome_trace(self, extra_events=extra_events)

    def reconcile(self) -> float:
        """Max relative error of bucket sums vs ``report.summary()``."""
        return self.profile.reconcile()


def analyze(report: SimReport, num_buckets: int = 120,
            hw: Optional[HardwareSpec] = None,
            min_phase_intervals: int = 2) -> AnalysisReport:
    """One-call pipeline: intervals -> phases -> channels -> links."""
    profile = profile_intervals(report, num_buckets)
    phases = segment_phases(profile, min_intervals=min_phase_intervals)
    channels = channel_traffic(report, hw)
    links = link_traffic(report)
    return AnalysisReport(report, profile, phases, channels, links)


__all__ = [
    "AnalysisReport", "analyze",
    "Interval", "IntervalProfile", "profile_intervals", "UNITS",
    "Phase", "segment_phases", "label_interval", "phase_table",
    "ChannelReport", "channel_traffic", "CAMPING_OPS",
    "LinkReport", "link_traffic", "LINK_CAMPING_THRESHOLD",
    "to_json", "to_chrome_trace", "ascii_timeline",
]
