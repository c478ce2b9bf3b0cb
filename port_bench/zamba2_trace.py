"""The prefill replays of a traced run of the published Zamba2, for its
readers: the whole replays in the device trace (``replays.replays``) whose
event count is the prefill graph's node count, put down to its regions
(``replays.put_down``).

They are found by their count, not paired with their launches
(``replays.launched``): that pairing lets the offset between the device's
stamps and the host's move by half the shortest time between two launches
(a decode step, some 43 ms), and over a prefill of some 2.4 s the
profiler's conversion of the device's clock drifts by about as much (1%),
so a traced run's pairing failed now and then.  The prefill graph's count
(some 47,000 nodes) is its own: the decode graph's is some 6,000, and the
traced segment replays the prefill in its prefill phases only.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import replays as RP


def prefill_replays(run) -> Optional[Tuple[object, List[RP.Replay]]]:
    """The prefill graph's region table and its whole replays in the run's
    trace; None where there are none, or the program records no table."""
    trace = run.tracer.trace if run.tracer is not None else None
    table = RP.table("prefill") if trace is not None else None
    if table is None:
        return None
    found = [rp for rp in RP.replays(trace.device) if len(rp.events) == table.nodes]
    return (table, found) if found else None


def prefill_seconds(run) -> Optional[Dict[str, float]]:
    """Device seconds by region of the prefill replays."""
    got = prefill_replays(run)
    return None if got is None else RP.put_down(got[1], got[0])
