"""ICI link report: the fabric analogue of the HBM channel-camping detector.

The paper's partition-camping analysis (§V) shows aggregate DRAM bandwidth
hiding per-partition saturation; the same failure mode exists on the
interconnect: an aggregate "ICI busy" number looks healthy while one mesh
axis' links saturate (every collective in the program lands on the same
ring) and the others idle.  Since :mod:`repro_torch.topology` landed, the ENGINE
produces the canonical per-collective link split: every ici
:class:`~repro_torch.core.engine.TimelineEntry` carries ``link_bytes`` derived
from its lowered transfer schedule.  This module only *aggregates* — the
same division of labor as :mod:`repro_torch.analysis.channels`, whose machinery
(imbalance = hottest / mean, hot-contributor attribution, ASCII bar table)
it reuses structurally.

*Link camping* is flagged when the imbalance crosses
:data:`LINK_CAMPING_THRESHOLD`: a minority of links carries most of the
traffic, so adding fabric bandwidth uniformly would NOT speed the workload —
re-mapping the collectives (different axes / replica groups) would.

Legacy reports whose collectives carry no link split (``topology_model=
False`` runs, hand-built timelines) fall back to one flat pseudo-link so the
:class:`LinkReport` API works on both.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.engine import SimReport, TimelineEntry

#: imbalance (hottest-link bytes / mean-link bytes) above which the fabric
#: counts as link-camped — hoisted to the shared pathology-threshold config
#: (``repro_torch.obs.thresholds``) so this table, the timelapse "!" markers and
#: the doctor's link detector all agree on one bar.
from repro_torch.obs.thresholds import LINK_CAMPING_THRESHOLD  # noqa: E402

#: pseudo-link name for legacy entries that carry no per-link split
FLAT_LINK = "ici:flat"


@dataclass
class LinkReport:
    """Per-ICI-link traffic totals for one simulated run."""

    link_bytes: Dict[str, float]      # bytes per directed link
    imbalance: float                  # max / mean link bytes (1.0 balanced)
    total_bytes: float
    hot_link: str                     # name of the hottest link ("" if none)
    hot_contributors: List[Tuple[str, float]]  # (op name, bytes on hot link)

    @property
    def camped(self) -> bool:
        """True when a minority of links gates the fabric (link camping)."""
        return self.imbalance > LINK_CAMPING_THRESHOLD

    @property
    def num_links(self) -> int:
        return len(self.link_bytes)

    def table(self, width: int = 40, max_rows: int = 16) -> str:
        """ASCII per-link bar chart (the fabric analogue of the per-channel
        plot); hottest links first."""
        if not self.link_bytes:
            return "ICI link traffic: (no collectives on the timeline)"
        rows = sorted(self.link_bytes.items(), key=lambda kv: -kv[1])
        peak = rows[0][1]
        lines = [f"ICI link traffic  imbalance={self.imbalance:.2f}  "
                 f"{'CAMPED' if self.camped else 'balanced'}  "
                 f"({self.num_links} links)"]
        for name, b in rows[:max_rows]:
            bar = "#" * int(width * (b / peak)) if peak > 0 else ""
            hot = " <- hot" if name == self.hot_link and self.camped else ""
            lines.append(f"  {name:>12s} |{bar:<{width}}| "
                         f"{b / 1e6:8.2f} MB{hot}")
        if len(rows) > max_rows:
            lines.append(f"  ... ({len(rows) - max_rows} more links)")
        if self.hot_contributors:
            lines.append("  hottest-link contributors: "
                         + ", ".join(f"{n} ({b / 1e6:.2f} MB)"
                                     for n, b in self.hot_contributors[:3]))
        return "\n".join(lines)


def _entry_link_bytes(e: TimelineEntry) -> Optional[Dict[str, float]]:
    """This entry's trip-scaled per-link bytes: the engine's lowered split
    when present, else everything on the flat pseudo-link."""
    if e.unit != "ici":
        return None
    vec = getattr(e, "link_bytes", None)
    if vec:
        return {l: b * e.scale for l, b in vec.items()}
    if e.ici_bytes > 0:
        return {FLAT_LINK: e.ici_bytes * e.scale}
    return None


def link_traffic(report: SimReport) -> LinkReport:
    """Aggregate every collective's link split into per-link totals."""
    per_link: Dict[str, float] = {}
    per_op: List[Tuple[TimelineEntry, Dict[str, float]]] = []
    for e in report.timeline:
        vec = _entry_link_bytes(e)
        if not vec:
            continue
        for l, b in vec.items():
            per_link[l] = per_link.get(l, 0.0) + b
        per_op.append((e, vec))

    total = sum(per_link.values())
    if not per_link:
        return LinkReport({}, 1.0, 0.0, "", [])
    mean = total / len(per_link)
    hot = max(per_link, key=per_link.get)
    imbalance = per_link[hot] / mean if mean > 0 else 1.0

    contributors: Dict[str, float] = {}
    for e, vec in per_op:
        b = vec.get(hot, 0.0)
        if b > 0:
            contributors[e.name] = contributors.get(e.name, 0.0) + b
    top = sorted(contributors.items(), key=lambda kv: -kv[1])[:8]
    return LinkReport(per_link, imbalance, total, hot, top)
