"""A traced run's CUDA-graph replays, found in its device trace and put
down to the regions of the graph's capture.

While a profiler records, the program launches a marker before each replay
of a compiled step and two after it: ATen's ``spin_kernel``
(``torch.cuda._sleep(0)``), which no other code of the port launches.  At
capture it writes the graph's region table (``repro_torch.obs.regions``):
the number of device-work nodes (kernels, copies, fills) in capture order,
and each region as (name, first node, end node, depth).  A graph captured on
one stream runs its nodes in that order, so the i-th device event between a
replay's markers is the i-th node of its table, and belongs to the innermost
region around that node.

Nothing here guesses: a replay whose markers or events the profiler cut (it
drops what the device runs in the first few hundred microseconds of its
session, and the events its clock conversion stamps past the session's
end) is passed over, only replays that hold their table's node count are
put down, and a trace whose replays do not pair with their launches in one
way alone gives nothing.  A program
that records no tables, as one from before the regions, gives nothing.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import devtrace as TR

#: the marker kernel's name, as a device trace shows it in part
MARKER = "spin_kernel"
#: the name under which the nodes outside every region are counted
OUTSIDE = "(no region)"
#: the host range inside which the program launches a replay
LAUNCH = "repro.jit.replay"
#: how far the offset between the device's stamps and the host's may move
#: from one launch to the next, as a share of the shortest time between two
#: launches: a profiler's conversion of the device's clock drifts by about 1%
#: on an H100, and a stall of the host's (a profiler's buffer request) can
#: hold a launch back by some milliseconds, where a replay paired with the
#: wrong launch is off by a whole gap or more
DRIFT = 0.5

#: a device trace's event: (name, start ns, end ns)
Event = Tuple[str, int, int]


@dataclass
class Replay:
    """One replay in a device trace: from its first marker's end to its
    last markers' start (ns), and the device events between them."""
    t0: int
    t1: int
    events: List[Event] = field(default_factory=list)

    @property
    def elapsed_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        """The summed device time of its events."""
        return sum(e - s for _, s, e in self.events) / 1e9


def replays(events: Sequence[Event]) -> List[Replay]:
    """The whole replays in a device trace's events, in order, with the
    host-to-device copies dropped (another thread's work, the data
    pipeline's prefetch, may put them between a replay's nodes).  A run of
    consecutive markers holds the end pairs of the replays it closes, then,
    where it is odd, the begin of the next (a graph is never empty).  A
    replay that a missing marker leaves without its begin or its end is
    passed over."""
    evs = sorted((e for e in events if "HtoD" not in e[0]), key=lambda e: e[1])
    out: List[Replay] = []
    cur: Optional[Replay] = None
    i = 0
    while i < len(evs):
        if MARKER not in evs[i][0]:
            if cur is not None:
                cur.events.append(evs[i])
            i += 1
            continue
        j = i
        while j < len(evs) and MARKER in evs[j][0]:
            j += 1
        ends, begin = divmod(j - i, 2)
        if (ends and (cur is None or ends > 1)) or (begin and not ends and cur is not None):
            cur = None
        elif ends:
            cur.t1 = evs[i][1]
            out.append(cur)
            cur = None
        if begin:
            cur = Replay(evs[j - 1][2], evs[j - 1][2])
        i = j
    return out


def launched(device: Sequence[Event], host: Sequence[Event]
             ) -> Optional[List[Tuple[int, Replay]]]:
    """The whole replays of a trace, each with the start (ns) of the host
    range (:data:`LAUNCH`) that launched it.  One stream runs the replays in
    the order of their launches, so they are a run of consecutive launches:
    those the profiler cut at either end of the trace have no replay (it
    drops what the device runs in the first few hundred microseconds of its
    session, and the events it stamps past its end).  The run is the one
    alignment that fits: no replay begins before its own launch, and the
    offset of the device's stamps from the host's changes from one launch
    to the next by no more than :data:`DRIFT` of the shortest time between
    two launches (the limit of both).  A single launch has no such time,
    and its replay is the only one it can pair with: the profiler's
    conversion of the device's clock can stamp a replay some hundred
    microseconds before the launch that made it, so a limit of nothing
    would refuse it.  The host's stamps
    say which phase of the host's work a replay belongs to where the
    device's may not: their offset from the host's drifts, by milliseconds
    over a trace of seconds.  None where no alignment fits (a replay lost
    within the trace) or more than one does."""
    found = replays(device)
    starts = sorted(s for name, s, _ in host if name == LAUNCH)
    if len(found) > len(starts):
        return None
    limit = DRIFT * min((b - a for a, b in zip(starts, starts[1:])), default=math.inf)
    fits = []
    for cut in range(len(starts) - len(found) + 1):
        pairs = list(zip(starts[cut:], found))
        offsets = [rp.t0 - h for h, rp in pairs]
        if min(offsets, default=0) >= -limit and all(
                abs(b - a) <= limit for a, b in zip(offsets, offsets[1:])):
            fits.append(pairs)
    return fits[0] if len(fits) == 1 else None


def owners(table) -> List[str]:
    """Each node's innermost region in a region table (:data:`OUTSIDE` for
    none)."""
    out = [OUTSIDE] * table.nodes
    for name, lo, hi, _ in sorted(table.regions, key=lambda r: r[3]):
        out[lo:hi] = [name] * (hi - lo)
    return out


def put_down(found: Sequence[Replay], table) -> Optional[Dict[str, float]]:
    """Device seconds a region over the replays ``found``, each put down to
    ``table`` node by node; the nodes outside every region under
    :data:`OUTSIDE`.  The values sum to the replays' device time.  None
    where there is no replay or a replay's event count is not the table's
    node count."""
    if not found:
        return None
    own = owners(table)
    out = dict.fromkeys([r[0] for r in table.regions] + [OUTSIDE], 0.0)
    for rp in found:
        if len(rp.events) != table.nodes:
            return None
        for owner, (_, s, e) in zip(own, rp.events):
            out[owner] += (e - s) / 1e9
    return out


def table(step: str):
    """The program's newest region table of the compiled step ``step``, or
    None where it records none."""
    try:
        from repro_torch.obs import regions
    except ImportError:
        return None
    return regions.table(step)


def phase_replays(trace, step: str, phase: str) -> Optional[Tuple[object, List[Replay]]]:
    """The region table of ``step`` and the whole replays of it that the
    host launched inside the ``bench.<phase>`` ranges and that hold the
    table's node count; None where the program records no table or the
    replays cannot be paired with their launches."""
    tab = table(step)
    pairs = launched(trace.device, trace.host) if tab is not None else None
    if pairs is None:
        return None
    spans = trace.ranges.get(TR.PREFIX + phase, [])
    return tab, [rp for t, rp in pairs if len(rp.events) == tab.nodes
                 and any(lo <= t < hi for lo, hi in spans)]


def phase_seconds(trace, step: str, phase: str) -> Optional[Dict[str, float]]:
    """Device seconds by region of ``step``'s replays in ``phase``
    (:func:`phase_replays` put down by :func:`put_down`); None where there
    are none."""
    got = phase_replays(trace, step, phase)
    return None if got is None else put_down(got[1], got[0])
