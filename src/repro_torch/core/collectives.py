"""ICI collective timing model.

Ring algorithms on a 2D torus (one ring per mesh axis, bidirectional links):

    all-gather      g devices, S bytes output: (g-1)/g * S over the ring
    reduce-scatter  same traffic as AG (input traverses once)
    all-reduce      RS + AG = 2(g-1)/g * S
    all-to-all      (g-1)/g * S (each device keeps 1/g)
    collective-permute  S bytes point-to-point (one hop)

Effective per-device ring bandwidth = links_per_axis * link_bw (both
directions used).  A latency term (hops * per-hop latency) models small
transfers; the paper's DRAM-bank analysis maps here to *link camping*: a
collective whose group spans one mesh axis uses only that axis' links.

Two paths produce these times:

* the **flat closed forms** below — one aggregate fabric clock, the
  pre-topology model (and still the inter-pod/DCN path);
* the **per-link path**: pass a :class:`repro_torch.topology.FabricModel` as
  ``fabric`` and the collective is lowered onto a Topology graph
  (:func:`repro_torch.topology.lowering.lower_collective`); the returned
  :class:`CollectiveTime` then carries the :class:`TransferSchedule` whose
  per-link busy seconds the engine's link clocks consume.  On the default
  per-group ring fabric both paths agree exactly (tested in
  ``tests/test_topology.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

from repro_torch.core.hw import HardwareSpec


@dataclass
class CollectiveTime:
    seconds: float
    link_bytes: float       # bytes that traverse ICI per device
    axis_guess: str         # which mesh axis (ring) is used
    #: the lowered per-link plan (repro_torch.topology.TransferSchedule) when the
    #: fabric model produced this time; None on the flat path
    schedule: Optional[Any] = None


def collective_time(kind: str, payload_bytes: float, group: int,
                    hw: HardwareSpec, inter_pod: bool = False,
                    fabric: Optional[Any] = None,
                    members: Optional[Sequence[int]] = None,
                    pairs: Optional[Sequence] = None) -> CollectiveTime:
    """payload_bytes = size of the (full) tensor at the op's output/input.

    ``pairs`` (collective-permute only): every parsed source->target pair,
    so the fabric path claims all their links, not just the first's.
    """
    if group <= 1:
        return CollectiveTime(0.0, 0.0, "none")
    if fabric is not None:
        sched = fabric.schedule_for(kind, payload_bytes, group,
                                    members=members, inter_pod=inter_pod,
                                    pairs=pairs)
        if sched is not None:
            return CollectiveTime(sched.seconds, sched.traffic_bytes,
                                  fabric.topology_for(
                                      tuple(members or range(group))).name,
                                  schedule=sched)
    bw = hw.ici_links_per_axis * hw.ici_link_bw
    if inter_pod:
        bw = hw.dcn_bw
    g = group
    if kind == "all-reduce":
        traffic = 2.0 * (g - 1) / g * payload_bytes
        hops = 2 * (g - 1)
    elif kind in ("all-gather", "reduce-scatter", "all-to-all",
                  "ragged-all-to-all", "collective-broadcast"):
        traffic = (g - 1) / g * payload_bytes
        hops = g - 1
    elif kind == "collective-permute":
        traffic = float(payload_bytes)
        hops = 1
    else:
        traffic = float(payload_bytes)
        hops = g - 1
    t = traffic / bw + hops * hw.ici_latency_s
    axis = "pod" if inter_pod else ("model" if g <= 16 else "data")
    return CollectiveTime(t, traffic, axis)
