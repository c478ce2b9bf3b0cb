"""Gang slowdown on a degraded fabric: how much a broken link costs.

When an ICI link fails under a running (or about-to-start) gang, the
collectives the gang issues every step no longer see the healthy fabric:
traffic that flowed down the dead link re-routes over surviving neighbors
(BFS detours in :meth:`repro_torch.topology.graph.Topology.route`) and
*serializes* with the traffic already camped there.  The cluster loop
folds that into scheduling with one scalar: the **gang dilation** — the
ratio of the gang's all-reduce schedule time on the degraded fabric to
the same schedule on the healthy fabric.  Per-step gang time is then
``healthy_per_step * dilation``, i.e. the per-step collective share is
conservatively assumed to dominate the stretch.

The probe payload is a fixed 64 MiB all-reduce — big enough that the
schedule is bandwidth-dominated (latency hops cancel in the ratio for
same-phase-count reroutes), which is the regime where a lost link
actually hurts.

If the removals *partition* the gang (no surviving route between two
members), the lowering raises ``ValueError``; the dilation then falls
back to ``len(members)`` — fully serialized, the pessimistic bound — so
the simulation keeps running rather than wedging.  Schedulers should
avoid placing gangs across broken links in the first place (the Locality
policy does), making this the last-resort path.
"""
from __future__ import annotations

from functools import lru_cache
from typing import AbstractSet, Optional, Sequence, Tuple

from repro_torch.core.hw import HardwareSpec
from repro_torch.topology.graph import Topology
from repro_torch.topology.lowering import lower_collective

#: bandwidth-dominated probe payload for the dilation ratio (64 MiB)
PROBE_BYTES = 64 * 1024 * 1024


def gang_dilation(topo: Topology, members: Sequence[int],
                  broken: Optional[AbstractSet[Tuple[int, int]]],
                  hw: HardwareSpec) -> float:
    """Degraded/healthy all-reduce time ratio for a gang (>= 1.0).

    ``members`` are global device ids on ``topo``; ``broken`` holds
    undirected id pairs of failed physical links.  Returns 1.0 when no
    broken link can affect the gang, ``len(members)`` when the gang is
    partitioned by the removals.  Pure in its arguments, so the probe
    ratio is memoized — the cluster loop re-asks for the same (gang,
    outage) pair on every epoch/checkpoint event.
    """
    if not broken or len(members) <= 1:
        return 1.0
    return _dilation_cached(topo, tuple(members), frozenset(broken), hw)


@lru_cache(maxsize=4096)
def _dilation_cached(topo: Topology, members: Tuple[int, ...],
                     broken: frozenset, hw: HardwareSpec) -> float:
    # behind the lru_cache: the span/counter record probe computations
    # actually performed, not memoized re-asks
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.obs.trace import TRACER
    REGISTRY.counter("faults_dilation_probes_total").inc()
    with TRACER.span("faults.gang_dilation", gang=len(members),
                     broken_links=len(broken)):
        healthy = lower_collective("all-reduce", PROBE_BYTES, members, topo,
                                   hw)
        if healthy.seconds <= 0:
            return 1.0
        try:
            degraded = lower_collective("all-reduce", PROBE_BYTES, members,
                                        topo, hw, broken=broken)
        except ValueError:
            REGISTRY.counter("faults_gang_partitions_total").inc()
            return float(len(members))
        return max(degraded.seconds / healthy.seconds, 1.0)
