"""HBM channel report: the paper's DRAM *partition camping* detector, for TPU.

The paper's strongest microarchitectural finding (§V, Fig. 22-25) is that some
cuDNN kernels concentrate their DRAM traffic on a few memory partitions —
"partition/bank camping" — so the aggregate DRAM-bandwidth counter looks
healthy while individual channels saturate.

Since the :mod:`repro_torch.memory` subsystem landed, the ENGINE produces the
canonical per-op channel split: every :class:`~repro_torch.core.engine.TimelineEntry`
scheduled under the memory model carries ``channel_bytes`` derived from its
buffer placements (the live-range allocator's addresses under the interleave).
This module therefore only *aggregates* — it sums the engine's vectors into a
per-channel total and names the hottest channel's contributors.  Legacy
reports whose entries carry no placement (hand-built timelines, or runs with
``memory_model=False``) fall back to :func:`repro_torch.memory.channels.
legacy_channel_bytes`, the same single-sourced model with a name-hash anchor,
so the :class:`ChannelReport` API and ASCII table work on both.

``imbalance`` = hottest-channel bytes / mean-channel bytes; 1.0 is perfectly
balanced, and anything well above ~1.5 means a minority of channels gates the
effective bandwidth.  The detector reads only per-op BYTES (never start
times), so it is unaffected by how much the dataflow scheduler overlaps the
timeline.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.core.engine import SimReport, TimelineEntry
from repro_torch.core.hw import HardwareSpec
# the camping classifier + channel split are single-sourced in repro_torch.memory
from repro_torch.memory.channels import (CAMPING_FRACTION, CAMPING_OPS,
                                   is_camping_op, legacy_channel_bytes)


@dataclass
class ChannelReport:
    """Per-HBM-channel traffic totals for one simulated run."""

    channel_bytes: List[float]        # bytes per channel, index = channel id
    imbalance: float                  # max / mean channel bytes (1.0 balanced)
    camping_bytes: float              # bytes issued by camping-pattern ops
    total_bytes: float
    hot_channel: int                  # index of the hottest channel
    hot_contributors: List[Tuple[str, float]]  # (op name, bytes on hot chan)

    @property
    def camping_fraction_of_traffic(self) -> float:
        return self.camping_bytes / self.total_bytes if self.total_bytes else 0.0

    def table(self, width: int = 40) -> str:
        """ASCII per-channel bar chart (the paper's per-DRAM-partition plot)."""
        peak = max(self.channel_bytes) if self.channel_bytes else 0.0
        lines = [f"HBM channel traffic  imbalance={self.imbalance:.2f}  "
                 f"camping traffic={self.camping_fraction_of_traffic * 100:.1f}%"]
        for ch, b in enumerate(self.channel_bytes):
            bar = "#" * int(width * (b / peak)) if peak > 0 else ""
            hot = " <- hot" if ch == self.hot_channel and self.imbalance > 1.05 \
                else ""
            lines.append(f"  ch{ch:02d} |{bar:<{width}}| {b / 1e6:8.2f} MB{hot}")
        if self.hot_contributors:
            lines.append("  hottest-channel contributors: "
                         + ", ".join(f"{n} ({b / 1e6:.2f} MB)"
                                     for n, b in self.hot_contributors[:3]))
        return "\n".join(lines)


def _entry_channel_bytes(e: TimelineEntry, n_ch: int) -> List[float]:
    """This entry's trip-scaled per-channel bytes: the engine's placement-
    derived split when present (and sized for this spec), else the legacy
    name-anchored model."""
    vec = getattr(e, "channel_bytes", None)
    if vec is not None and len(vec) == n_ch:
        return [v * e.scale for v in vec]
    return legacy_channel_bytes(e.opcode, e.name, e.hbm_bytes * e.scale, n_ch)


def channel_traffic(report: SimReport, hw: Optional[HardwareSpec] = None
                    ) -> ChannelReport:
    """Aggregate every timeline op's channel split into per-channel totals."""
    hw = hw or report.hw
    n_ch = hw.hbm_channels
    per_ch = [0.0] * n_ch
    camping_bytes = 0.0
    total = 0.0
    per_op: List[Tuple[TimelineEntry, List[float]]] = []

    for e in report.timeline:
        vec = _entry_channel_bytes(e, n_ch)
        b = sum(vec)
        if b <= 0:
            continue
        total += b
        if is_camping_op(e.opcode, e.name):
            camping_bytes += b
        for ch in range(n_ch):
            per_ch[ch] += vec[ch]
        per_op.append((e, vec))

    mean = sum(per_ch) / n_ch if n_ch else 0.0
    imbalance = (max(per_ch) / mean) if mean > 0 else 1.0
    hot = max(range(n_ch), key=lambda c: per_ch[c]) if n_ch else 0

    contributors: dict = {}
    for e, vec in per_op:
        if n_ch and vec[hot] > 0:
            contributors[e.name] = contributors.get(e.name, 0.0) + vec[hot]
    top = sorted(contributors.items(), key=lambda kv: -kv[1])[:8]
    return ChannelReport(per_ch, imbalance, camping_bytes, total, hot, top)
