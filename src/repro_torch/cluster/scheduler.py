"""Placement/queueing policies behind one ``Policy`` interface.

The event loop (:mod:`repro_torch.cluster.events`) calls
:meth:`Policy.select` repeatedly whenever cluster state changes (an arrival
or a completion): each call either places one queued job on a tuple of free
devices or returns ``None`` ("nothing more can start now").  Policies
therefore never touch the clock or the heap — they are pure placement
decisions, and a new policy is one small class registered in
:data:`POLICIES`.

Jobs may be *multi-device gangs* (``QueuedJob.num_devices > 1``): a
placement is then a tuple of that many free devices held simultaneously.
Feasibility is shared across policies: a job *fits* a device when its
per-device share of the cost model's ``peak_hbm_bytes`` (PR 3's live-range
allocator high-water mark, divided across the gang — the sharded-model
assumption) is within the device's HBM.  A job too big for every chip in
the fleet is flagged ``oversubscribed`` and allowed anywhere — the
allocator reports oversubscription rather than refusing to run, and the
cluster follows suit.

Policies:

* ``fifo``          — strict arrival order; the queue head blocks everyone
                      behind it (the head-of-line-blocking baseline);
* ``sjf``           — shortest predicted service (engine makespan x steps)
                      first; the classic mean-delay optimizer;
* ``best-fit-hbm``  — tightest-fitting (job peak-HBM vs device HBM) pair
                      first, FIFO tie-break: keeps big-HBM slots free for
                      big jobs on heterogeneous fleets;
* ``locality``      — topology-aware placement.  Single-device jobs prefer
                      a device that last ran the same class (skips the
                      cold-start setup charge).  Multi-device gangs are
                      placed on the *minimal-diameter sub-slice* of the
                      fleet's interconnect :class:`~repro_torch.topology.Topology`
                      whose devices are all free — a 2x2 torus block beats
                      four scattered chips, because the gang's collectives
                      then run over short disjoint links.  Policies receive
                      the fleet (and its topology) via :meth:`Policy.
                      bind_fleet` at the start of every run.
"""
from __future__ import annotations

from bisect import bisect_left
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Type

from repro_torch.cluster.devices import DeviceSlot, Fleet
from repro_torch.cluster.workload import Job


@dataclass
class QueuedJob:
    """A job waiting for placement, with its precomputed cost features."""

    job: Job
    seq: int                      # arrival order (stable FIFO key)
    service_s: float              # predicted service on the *reference* chip
    peak_hbm_bytes: float         # PER-DEVICE footprint (peak / num_devices)
    remaining_steps: int          # > 0 remainder when preempted
    num_devices: int = 1          # gang footprint (clamped to fleet size)
    oversubscribed: bool = False  # fits no chip in the fleet; runs anyway
    first_start_s: Optional[float] = None
    preemptions: int = 0
    base_devices: int = 0         # gang size at arrival (elastic baseline)
    epoch: int = 0                # bumped on failure-kill: stale-event guard
    needs_restore: bool = False   # next start pays the checkpoint restore
    reshape_pending: bool = False # elastic shrink decision due next pass

    def fits(self, dev: DeviceSlot) -> bool:
        return self.oversubscribed or self.peak_hbm_bytes <= dev.hw.hbm_bytes


class Policy:
    """Base: subclasses override :meth:`select`."""

    name = "base"

    def __init__(self):
        self.topology = None                       # set by bind_fleet
        self.fleet = None
        self._node_of: Dict[str, int] = {}

    def bind_fleet(self, fleet: Fleet) -> None:
        """Give the policy the fleet's shape (called once per run): the
        interconnect topology and the device-id -> topology-position map.
        The fleet reference also exposes live fabric health
        (``fleet.broken_links``) to topology-aware policies."""
        self.topology = fleet.topology
        self.fleet = fleet
        self._node_of = {d.device_id: i for i, d in enumerate(fleet.slots)}
        self._slice_memo: Dict[int, Tuple[Tuple[int, ...], ...]] = {}
        self._min_hbm = min(d.hw.hbm_bytes for d in fleet.slots)

    def select(self, queue: Sequence[QueuedJob], free: Sequence[DeviceSlot],
               now: float
               ) -> Optional[Tuple[QueuedJob, Tuple[DeviceSlot, ...]]]:
        """Pick one (job, free-device gang) to start at ``now``, or ``None``.

        The loop re-invokes until ``None``, so returning one placement per
        call is enough; ``queue`` is in arrival order.
        """
        raise NotImplementedError

    @staticmethod
    def _first_fit(qj: QueuedJob, free: Sequence[DeviceSlot]
                   ) -> Optional[Tuple[DeviceSlot, ...]]:
        """First ``num_devices`` free fitting slots, or ``None``."""
        picked = [d for d in free if qj.fits(d)][:qj.num_devices]
        if len(picked) < qj.num_devices:
            return None
        return tuple(picked)

    @staticmethod
    def free_hbm_sorted(free: Sequence[DeviceSlot]) -> List[float]:
        """Sorted HBM capacities of the free set — the structure behind
        :meth:`can_fit`'s O(log n) feasibility test."""
        return sorted(d.hw.hbm_bytes for d in free)

    @staticmethod
    def can_fit(qj: QueuedJob, hbm_sorted: Sequence[float]) -> bool:
        """Whether ``_first_fit(qj, free)`` would succeed, in O(log n).

        ``qj.fits`` is a pure HBM-capacity threshold, so the number of
        fitting free devices is the count of capacities ``>= peak`` — a
        bisect over the sorted capacities, equivalent to (but much cheaper
        than) materializing the first-fit device tuple per queued job.
        """
        n = len(hbm_sorted)
        if qj.oversubscribed:
            return n >= qj.num_devices
        return n - bisect_left(hbm_sorted, qj.peak_hbm_bytes) \
            >= qj.num_devices


class FIFO(Policy):
    """Strict arrival order: only the queue head may start."""

    name = "fifo"

    def select(self, queue, free, now):
        if not queue or not free:
            return None
        devs = self._first_fit(queue[0], free)
        return (queue[0], devs) if devs is not None else None


class SJF(Policy):
    """Shortest predicted service first (non-preemptive)."""

    name = "sjf"

    def select(self, queue, free, now):
        # feasibility is an O(log n) bisect per queued job (see can_fit), so
        # one pass finds the min-(service, seq) fitting job without building
        # a candidate device tuple per entry; the winner's tuple is built
        # once at the end — identical selection to the full rescan
        if not queue or not free:
            return None
        hbm_sorted = self.free_hbm_sorted(free)
        best = None
        for qj in queue:
            if best is not None and \
                    (qj.service_s, qj.seq) >= (best.service_s, best.seq):
                continue
            if self.can_fit(qj, hbm_sorted):
                best = qj
        if best is None:
            return None
        return (best, self._first_fit(best, free))


class BestFitHBM(Policy):
    """Tightest (device HBM - job peak HBM) fit first, FIFO tie-break.

    Packing: on a mixed v5e/v5p fleet this parks small jobs on small chips
    and keeps the big-HBM slots available for jobs only they can hold.
    Multi-device gangs take the tightest-fitting slots (slack summed over
    the gang).
    """

    name = "best-fit-hbm"

    def select(self, queue, free, now):
        # sort the free set by HBM once; each job's fitting devices are then
        # a suffix of that order (fits() is a capacity threshold, and sort
        # stability makes filter-then-sort == sort-then-filter), so the old
        # per-job sort collapses to one bisect + slice
        if not queue or not free:
            return None
        free_sorted = sorted(free, key=lambda d: d.hw.hbm_bytes)
        hbm_vals = [d.hw.hbm_bytes for d in free_sorted]
        n = len(free_sorted)
        best = None
        best_key = None
        for qj in queue:
            i = 0 if qj.oversubscribed \
                else bisect_left(hbm_vals, qj.peak_hbm_bytes)
            if n - i < qj.num_devices:
                continue
            devs = tuple(free_sorted[i:i + qj.num_devices])
            slack = sum(d.hw.hbm_bytes - qj.peak_hbm_bytes for d in devs)
            key = (slack, qj.seq)
            if best_key is None or key < best_key:
                best, best_key = (qj, devs), key
        return best


class Locality(Policy):
    """Topology-aware placement, FIFO order.

    Single-device head: prefer a free device whose previous job was the
    same class (that start skips the cold-start setup charge) — the
    original warm-placement behavior.  Multi-device head: walk the
    interconnect topology's sub-slices best (smallest diameter) first and
    take the first one whose devices are all free and fitting, so gang
    collectives run over a compact block of links.  Without a fleet
    topology, gangs fall back to first-fit.
    """

    name = "locality"

    def select(self, queue, free, now):
        # only the head is considered (FIFO-style blocking, so the policy
        # stays comparable to fifo on homogeneous fleets) — the preference
        # just changes WHICH free devices the head lands on
        if not queue:
            return None
        head = queue[0]
        if head.num_devices <= 1:
            warm = [d for d in free
                    if head.fits(d) and d.last_class == head.job.job_class]
            devs = (warm[0],) if warm else self._first_fit(head, free)
        else:
            devs = self._best_slice(head, free)
        return (head, devs) if devs is not None else None

    def _best_slice(self, qj: QueuedJob, free: Sequence[DeviceSlot]
                    ) -> Optional[Tuple[DeviceSlot, ...]]:
        if self.topology is None or len(free) < qj.num_devices:
            # no candidate slice can be all-free; fall through to the same
            # first-fit fallback the exhausted walk would reach
            return self._first_fit(qj, free)
        node_of = self._node_of
        if qj.oversubscribed or \
                qj.peak_hbm_bytes <= getattr(self, "_min_hbm", 0):
            # fits every chip in the fleet: skip the per-device fit filter
            free_at = {node_of[d.device_id]: d for d in free
                       if d.device_id in node_of}
        else:
            free_at = {node_of[d.device_id]: d for d in free
                       if qj.fits(d) and d.device_id in node_of}
        if len(free_at) < qj.num_devices:
            return self._first_fit(qj, free)
        free_mask = 0
        for pos in free_at:
            free_mask |= 1 << pos
        broken = getattr(self.fleet, "broken_links", None)
        degraded = None
        for mask, cand in self._slices(qj.num_devices):
            # all-free test as one int op over position bitmasks
            if mask & free_mask == mask:
                if broken and self.topology.internal_links(cand) & broken:
                    # crosses a failed link: usable, but keep looking for
                    # an intact block first (its collectives run dilated)
                    if degraded is None:
                        degraded = tuple(free_at[pos] for pos in cand)
                    continue
                return tuple(free_at[pos] for pos in cand)
        if degraded is not None:
            return degraded
        return self._first_fit(qj, free)

    def _slices(self, k: int) -> Tuple[Tuple[int, Tuple[int, ...]], ...]:
        """Per-run memo of the topology's ranked sub-slices, each paired
        with its position bitmask (the public accessor re-copies its cached
        list on every call, and a bitmask subset test beats a frozenset
        one)."""
        memo = getattr(self, "_slice_memo", None)
        if memo is None:
            memo = self._slice_memo = {}
        got = memo.get(k)
        if got is None:
            got = memo[k] = tuple(
                (sum(1 << p for p in cand), cand)
                for cand in self.topology.sub_slices(k))
        return got


POLICIES: Dict[str, Type[Policy]] = {
    p.name: p for p in (FIFO, SJF, BestFitHBM, Locality)}


def make_policy(name: str) -> Policy:
    if name not in POLICIES:
        raise KeyError(f"unknown policy {name!r}; known: {sorted(POLICIES)}")
    return POLICIES[name]()
