"""repro_torch.topology — the interconnect fabric as a first-class simulated resource.

The memory model (:mod:`repro_torch.memory`) splits the flat ``hbm`` clock into per-channel
clocks so DRAM partition camping could genuinely dilate the timeline.  This
package does the same for the ICI fabric: instead of one flat ``"ici"``
resource priced by a single analytic formula, the fabric is a
:class:`~repro_torch.topology.graph.Topology` graph (1D ring, 2D/3D torus, or a
fully-connected host fabric) and every collective is *lowered*
(:func:`~repro_torch.topology.lowering.lower_collective`) into a per-link transfer
schedule.  The engine then keeps one free-time clock per directed link
(``"ici:<src>-<dst>"``), so:

* two collectives on **disjoint** links (different mesh axes, different
  replica groups) genuinely overlap;
* collectives **sharing** links serialize — link camping dilates the
  timeline the way channel camping does;
* a torus fabric beats a flat ring on latency (fewer phases) at the same
  bandwidth optimum, measurably, in ``SimReport.total_seconds``.

The fabric shape comes from ``HardwareSpec.ici_topology`` (default
``"ring"``: a per-group ring that reproduces the old flat model's totals
exactly) and the same :class:`Topology` drives ``repro_torch.cluster``'s
topology-aware placement (minimal-diameter sub-slices for multi-device
jobs).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.hw import HardwareSpec
from repro_torch.topology.graph import Topology, link_name
from repro_torch.topology.lowering import (ALGORITHMS, TransferSchedule,
                                     lower_collective)


class FabricModel:
    """Per-engine fabric: resolves collectives to link schedules, memoized.

    One instance per :class:`~repro_torch.core.engine.Engine`; the cache is keyed
    on ``(kind, payload, members, algorithm)``, so a module that issues the
    same collective thousands of times (scan bodies, cluster re-simulations)
    lowers it once.
    """

    def __init__(self, hw: HardwareSpec,
                 broken: Optional[frozenset] = None):
        self.hw = hw
        #: failed undirected link pairs — every lowering routes around them,
        #: so an Engine built with ``broken_links`` prices the DEGRADED fabric
        self.broken: Optional[frozenset] = \
            frozenset(broken) if broken else None
        spec = getattr(hw, "ici_topology", "ring")
        # shared grammar check: an unknown kind or unsized torus raises HERE
        # rather than silently simulating a per-group ring the user did not
        # ask for
        self.kind, size = Topology.validate_spec(spec)
        #: the sized global fabric, when the spec names one (e.g. torus:4x4);
        #: unsized specs build a per-group fabric over each collective's
        #: members instead (the flat-model-compatible default)
        self.fabric: Optional[Topology] = \
            Topology.from_spec(spec) if size else None
        self._cache: Dict[tuple, TransferSchedule] = {}

    def topology_for(self, members: Tuple[int, ...]) -> Topology:
        """The fabric a collective over ``members`` runs on."""
        if self.fabric is not None and members and \
                max(members) < self.fabric.num_devices:
            return self.fabric
        if self.kind == "fc":
            return Topology.fully_connected(len(members), ids=members)
        return Topology.ring(len(members), ids=members)

    def schedule_for(self, kind: str, payload_bytes: float, group: int,
                     members: Optional[Sequence[int]] = None,
                     inter_pod: bool = False,
                     algorithm: Optional[str] = None,
                     pairs: Optional[Sequence] = None
                     ) -> Optional[TransferSchedule]:
        """Lowered schedule for one collective, or ``None`` when the fabric
        model does not apply (trivial groups, inter-pod DCN transfers).

        ``pairs`` carries a collective-permute's full source->target list so
        the schedule claims EVERY pair's links.
        """
        if group <= 1 or inter_pod:
            return None
        mt = tuple(members) if members else ()
        if len(mt) != group or len(set(mt)) != group:
            mt = tuple(range(group))    # unparsed/partial replica groups
        pt = tuple(tuple(p) for p in pairs) if pairs else None
        key = (kind, float(payload_bytes), mt, algorithm, pt)
        sched = self._cache.get(key)
        if sched is None:
            sched = lower_collective(kind, payload_bytes, mt,
                                     self.topology_for(mt), self.hw,
                                     algorithm=algorithm, pairs=pt,
                                     broken=self.broken)
            self._cache[key] = sched
        return sched


def ici_transfer_seconds(report) -> float:
    """Pure ICI transfer time on a report's timeline (duration minus issue
    cost) — the flat-fabric busy time the per-link conservation property
    (``sum(link_busy_seconds) >= this``) is defined over.  Shared by
    ``tests/test_properties.py`` and ``benchmarks/topology_sweep.py``."""
    return sum((e.duration - e.overhead_s) * e.scale
               for e in report.timeline if e.unit == "ici")


__all__ = [
    "Topology", "link_name", "TransferSchedule", "lower_collective",
    "ALGORITHMS", "FabricModel", "ici_transfer_seconds",
]
