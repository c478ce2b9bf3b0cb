"""The discrete-event cluster loop and its :class:`ClusterReport`.

A classic event-heap simulator on a virtual clock: ARRIVAL events come from
the trace, START decisions from the :class:`~repro_torch.cluster.scheduler.Policy`
(for multi-device jobs: a whole gang of devices held in lockstep, priced at
the slowest member's engine makespan), FINISH/PREEMPT events from the cost
model's per-device service times.  All
state changes happen at event times; between events nothing moves, so the
loop is O(events log events) regardless of how long the simulated horizon
is.  Determinism: events at equal times drain in insertion order (a
monotone sequence number breaks ties), and policies see the queue in
arrival order.

Time-slicing (``quantum_s``) turns one FINISH into a chain of PREEMPT
events: the job runs a whole number of steps per slice, goes back in the
queue, and may resume on a different device (heterogeneous fleets re-price
the remaining steps there).  Cold starts (``cold_start_s``) charge a setup
tax whenever a device switches job classes — what the ``locality`` policy
exists to avoid.

Failures (``faults``, a :class:`repro_torch.faults.FailureProcess`) add FAIL and
REPAIR events per device and — on a fabric-carrying fleet — per undirected
ICI link:

* a **device failure** kills the gang running there: work since the last
  committed checkpoint is lost, survivors free immediately, the failed
  device stays down until its repair event, and the job requeues (an
  elastic gang first reshapes onto the surviving device count, paying
  proportionally more steps-per-device via the slice ``price_factor``);
* a **link failure** kills gangs whose collectives cross it and removes
  the link from the fleet's fabric: the ``locality`` policy then prefers
  intact sub-slices, and gangs that must span a broken link run dilated
  by the degraded/healthy all-reduce ratio
  (:func:`repro_torch.faults.gang_dilation` — traffic genuinely re-routes and
  serializes on the surviving links);
* a ``checkpoint`` (:class:`repro_torch.faults.CheckpointModel`) prices the
  save cadence inside every run slice and the restore (+ gang re-shard)
  a killed job pays before resuming — all on the simulated clock, from
  the chip's HBM/DCN/ICI bandwidths.  Without a checkpoint model, a
  slice boundary is a free durable point and a mid-slice failure loses
  the whole slice.

The resulting :class:`ClusterReport` carries per-job records (queueing
delay, latency, device), per-device busy/setup time, fleet utilization,
latency percentiles, head-of-line-blocking counters, the cost-model cache
hit rate, failure/recovery counters with :meth:`ClusterReport.
goodput_fraction` and per-device :meth:`ClusterReport.time_accounting`
(busy + setup + checkpoint + restore + lost + down + idle == horizon), and
``engine_service_seconds`` — the sum of per-job Engine makespans recomputed
from the cost model, which must reconcile with the event loop's accumulated
busy time (the acceptance invariant).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.cluster.devices import CostModel, DeviceSlot, Fleet
from repro_torch.cluster.scheduler import Policy, QueuedJob
from repro_torch.cluster.workload import Job, Trace
from repro_torch.faults.pricing import CheckpointModel
from repro_torch.faults.processes import DEVICE, LINK, FailureProcess, link_key
from repro_torch.faults.reroute import gang_dilation
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.stats import quantile, quantile_sorted
from repro_torch.obs.trace import TRACER
from repro_torch.topology.graph import undirected_pair

_ARRIVAL, _FINISH, _FAIL, _REPAIR = 0, 1, 2, 3


def percentile(values: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile (numpy's default), pure python.

    Delegates to the one shared implementation in :mod:`repro_torch.obs.stats`:
    ``q`` is clamped to [0, 1] and NaN inputs raise ``ValueError`` instead
    of silently extrapolating or poisoning downstream summaries."""
    return quantile(values, q)


def _percentile_sorted(xs: Sequence[float], q: float) -> float:
    """:func:`percentile` over an ALREADY-sorted sequence (no re-sort).

    Simulator-produced latencies are NaN-free by construction, so the
    per-call NaN scan is skipped — summary() hits this three times per
    report over the same sorted list."""
    return quantile_sorted(xs, q, _validated=True)


@dataclass
class JobRecord:
    """Per-job outcome: the row a cluster operator would read."""

    job_id: str
    job_class: str
    user: str
    device_id: str                # device of the job's LAST slice
    arrival_s: float
    start_s: float                # first time any slice of the job ran
    finish_s: float
    service_s: float              # total run time across all slices
    num_steps: int
    preemptions: int = 0
    cold_starts: int = 0
    oversubscribed: bool = False
    failures: int = 0             # times a fault killed this job's gang
    restores: int = 0             # priced checkpoint restores paid
    lost_work_s: float = 0.0      # run time discarded by failures
    reshapes: int = 0             # elastic gang shrinks
    #: waiting accrued AFTER the first start: gaps between consecutive
    #: occupancy slices while the job sat requeued (preemption quantum
    #: expiries and failure-kill requeues).  Filled by the report pass
    #: from the job's slice-union, so Little's law over the waiting room
    #: reconciles against total_queue_delay_s, not just the first wait.
    requeue_wait_s: float = 0.0

    @property
    def queue_delay_s(self) -> float:
        """FIRST wait only: arrival to the first slice (the legacy
        definition, kept for golden/report compatibility)."""
        return self.start_s - self.arrival_s

    @property
    def total_queue_delay_s(self) -> float:
        """All time this job spent waiting: first wait + every requeue
        gap.  This — not :attr:`queue_delay_s` — is the W in the
        Little's-law identity L = lambda * W over the waiting room."""
        return self.queue_delay_s + self.requeue_wait_s

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s


@dataclass(slots=True)
class Slice:
    """One contiguous occupancy of one device (setup, restore, or run).

    A multi-device gang job produces one run slice PER occupied device;
    ``group`` then lists every device id in the gang (empty for the common
    single-device case) so the reconciliation can re-price the slice at the
    gang's step time — the SLOWEST member's engine makespan, since gang
    members step in lockstep.  A run slice's span decomposes as
    ``useful + ckpt_s + lost_s``: ``steps`` committed training steps, the
    cadenced checkpoint writes inside the slice, and — when a failure
    truncated it — the uncommitted tail that must be re-run.
    ``price_factor`` scales the engine's per-step price for degraded runs
    (elastic gangs on fewer devices, collectives re-routed around broken
    links) so the busy-vs-engine reconciliation stays honest.
    """

    device_id: str
    job_id: str
    job_class: str
    t0: float
    t1: float
    kind: str = "run"             # "run" | "setup" | "restore"
    steps: int = 0                # training steps COMMITTED in this slice
    group: Tuple[str, ...] = ()   # gang device ids (multi-device jobs)
    ckpt_s: float = 0.0           # checkpoint-write seconds inside the slice
    lost_s: float = 0.0           # truncated uncommitted work (failures)
    price_factor: float = 1.0     # per-step dilation vs the healthy engine


@dataclass
class ClusterReport:
    """Aggregate result of one trace x policy x fleet simulation."""

    policy: str
    trace_name: str
    num_devices: int
    jobs: List[JobRecord]
    slices: List[Slice]
    makespan_s: float
    fleet_busy_seconds: float         # useful run time (service time)
    fleet_setup_seconds: float        # cold-start slices
    per_device_busy: Dict[str, float]
    engine_service_seconds: float     # sum of per-job Engine makespans
    hol_events: int = 0               # passes where the queue head blocked
    hol_blocked_jobs: Tuple[str, ...] = ()
    hol_bypasses: int = 0             # starts that jumped an older job
    cache_hits: int = 0
    cache_misses: int = 0
    checkpoint_seconds: float = 0.0   # cadenced save writes (all devices)
    restore_seconds: float = 0.0      # restore/re-shard occupancy
    lost_work_seconds: float = 0.0    # truncated work re-run after failures
    device_failures: int = 0
    link_failures: int = 0
    recoveries: int = 0               # repairs completed within the run
    gang_reshapes: int = 0            # elastic shrinks applied
    #: heap events drained by the loop (throughput denominator for
    #: benchmarks/perf_core.py) — intentionally NOT part of summary()
    events_processed: int = 0
    #: wall-clock seconds per simulator stage (setup/pricing/events/render/
    #: export), filled when the CLI runs with --self-profile; NOT part of
    #: summary()
    stage_seconds: Dict[str, float] = field(default_factory=dict)
    down_intervals: Dict[str, List[Tuple[float, float]]] = \
        field(default_factory=dict)
    link_down_intervals: Dict[str, List[Tuple[float, float]]] = \
        field(default_factory=dict)
    failure_marks: List[dict] = field(default_factory=list)

    # -- derived ------------------------------------------------------------
    @property
    def utilization(self) -> float:
        cap = self.makespan_s * self.num_devices
        if cap <= 0:
            return 0.0
        occupied = (self.fleet_busy_seconds + self.fleet_setup_seconds
                    + self.checkpoint_seconds + self.restore_seconds
                    + self.lost_work_seconds)
        return occupied / cap

    @property
    def goodput_fraction(self) -> float:
        """Useful run seconds over all run+recovery occupancy.

        1.0 means every occupied second advanced a job; failures push it
        down through lost work, checkpoint writes, and restores — the
        quantity the checkpoint-interval sweep optimizes (Young/Daly)."""
        denom = (self.fleet_busy_seconds + self.lost_work_seconds
                 + self.checkpoint_seconds + self.restore_seconds)
        if denom <= 0:
            return 1.0
        return self.fleet_busy_seconds / denom

    @property
    def mean_queue_delay_s(self) -> float:
        if not self.jobs:
            return 0.0
        return sum(j.queue_delay_s for j in self.jobs) / len(self.jobs)

    @property
    def mean_total_queue_delay_s(self) -> float:
        """Mean of first wait + requeue waits — the queueing-theory W.

        On preemption/failure-free runs this equals
        :attr:`mean_queue_delay_s`; under time-slicing or faults it is
        strictly larger (the legacy metric silently dropped every requeue
        gap, understating waiting by orders of magnitude on quantum
        runs — the bug the Little's-law cross-check caught)."""
        if not self.jobs:
            return 0.0
        return sum(j.total_queue_delay_s for j in self.jobs) / len(self.jobs)

    def latency_percentile(self, q: float) -> float:
        # sort the latency list once and reuse it for every quantile asked
        # of this report (summary() alone asks for three)
        cached = self.__dict__.get("_latency_sorted")
        if cached is None or len(cached) != len(self.jobs):
            cached = sorted(j.latency_s for j in self.jobs)
            self.__dict__["_latency_sorted"] = cached
        return _percentile_sorted(cached, q)

    @property
    def cache_hit_rate(self) -> float:
        n = self.cache_hits + self.cache_misses
        return self.cache_hits / n if n else 0.0

    def reconcile_busy(self) -> float:
        """|fleet busy - sum of per-job engine makespans| / engine sum.

        The acceptance invariant: every second a device spends running came
        from an Engine-simulated step, so the two totals must agree."""
        if self.engine_service_seconds <= 0:
            return 0.0
        return (abs(self.fleet_busy_seconds - self.engine_service_seconds)
                / self.engine_service_seconds)

    def time_accounting(self) -> Dict[str, Dict[str, float]]:
        """Per-device occupancy ledger over the makespan horizon.

        Every device's ``busy + setup + checkpoint + restore + lost + down
        + idle`` equals ``horizon`` by construction (idle is the remainder)
        — the conservation invariant is that the remainder never goes
        negative, i.e. occupancy and down time never overlap.  Down
        intervals are clipped to the horizon (the last repair may land
        after the final job finishes)."""
        horizon = self.makespan_s
        acc = {d: {"busy": 0.0, "setup": 0.0, "checkpoint": 0.0,
                   "restore": 0.0, "lost": 0.0, "down": 0.0, "idle": 0.0,
                   "horizon": horizon}
               for d in self.per_device_busy}
        for s in self.slices:
            a = acc.get(s.device_id)
            if a is None:
                continue
            if s.kind == "run":
                a["busy"] += (s.t1 - s.t0) - s.ckpt_s - s.lost_s
                a["checkpoint"] += s.ckpt_s
                a["lost"] += s.lost_s
            elif s.kind == "setup":
                a["setup"] += s.t1 - s.t0
            elif s.kind == "restore":
                a["restore"] += s.t1 - s.t0
        for dev, intervals in self.down_intervals.items():
            a = acc.get(dev)
            if a is None:
                continue
            for t0, t1 in intervals:
                a["down"] += max(min(t1, horizon) - min(t0, horizon), 0.0)
        for a in acc.values():
            a["idle"] = a["horizon"] - sum(
                a[k] for k in ("busy", "setup", "checkpoint", "restore",
                               "lost", "down"))
        return acc

    def summary(self) -> Dict[str, float]:
        return {
            "policy": self.policy,
            "trace": self.trace_name,
            "num_devices": self.num_devices,
            "num_jobs": len(self.jobs),
            "makespan_s": self.makespan_s,
            "fleet_busy_seconds": self.fleet_busy_seconds,
            "fleet_setup_seconds": self.fleet_setup_seconds,
            "engine_service_seconds": self.engine_service_seconds,
            "utilization": self.utilization,
            "goodput_fraction": self.goodput_fraction,
            "checkpoint_seconds": self.checkpoint_seconds,
            "restore_seconds": self.restore_seconds,
            "lost_work_seconds": self.lost_work_seconds,
            "device_failures": self.device_failures,
            "link_failures": self.link_failures,
            "recoveries": self.recoveries,
            "gang_reshapes": self.gang_reshapes,
            "mean_queue_delay_s": self.mean_queue_delay_s,
            "mean_total_queue_delay_s": self.mean_total_queue_delay_s,
            "p50_latency_s": self.latency_percentile(0.50),
            "p95_latency_s": self.latency_percentile(0.95),
            "p99_latency_s": self.latency_percentile(0.99),
            "hol_events": self.hol_events,
            "hol_bypasses": self.hol_bypasses,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "cache_hit_rate": self.cache_hit_rate,
        }

    def table(self, max_rows: int = 20) -> str:
        """Per-job outcome table (worst queueing delays first)."""
        ranked = self.__dict__.get("_qdelay_ranked")
        if ranked is None or len(ranked) != len(self.jobs):
            ranked = sorted(self.jobs, key=lambda j: -j.queue_delay_s)
            self.__dict__["_qdelay_ranked"] = ranked
        rows = ranked[:max_rows]
        lines = [f"{'job':>9s} {'class':>14s} {'tenant':>9s} {'device':>13s} "
                 f"{'arrive':>9s} {'qdelay':>9s} {'service':>9s} "
                 f"{'latency':>9s} {'pre':>3s} {'fail':>4s}"]
        lines.append("-" * len(lines[0]))
        for j in rows:
            lines.append(
                f"{j.job_id:>9s} {j.job_class:>14s} {j.user:>9s} "
                f"{j.device_id:>13s} {j.arrival_s:>8.2f}s {j.queue_delay_s:>8.2f}s "
                f"{j.service_s:>8.2f}s {j.latency_s:>8.2f}s {j.preemptions:>3d} "
                f"{j.failures:>4d}")
        if len(self.jobs) > max_rows:
            lines.append(f"... ({len(self.jobs) - max_rows} more jobs)")
        return "\n".join(lines)


class ClusterSim:
    """Bind fleet + cost model + policy; :meth:`run` executes a trace.

    ``faults`` injects device/link outages, ``checkpoint`` prices the
    save/restore cycle, and ``elastic`` lets killed gangs reshape onto the
    surviving device count instead of waiting for repairs.  All three
    default off, in which case the loop behaves exactly as the
    failure-free simulator.
    """

    def __init__(self, fleet: Fleet, cost_model: CostModel, policy: Policy,
                 cold_start_s: float = 0.0,
                 quantum_s: Optional[float] = None,
                 faults: Optional[FailureProcess] = None,
                 checkpoint: Optional[CheckpointModel] = None,
                 elastic: bool = True):
        if quantum_s is not None and quantum_s <= 0:
            raise ValueError(f"quantum_s must be positive, got {quantum_s}")
        self.fleet = fleet
        self.cost = cost_model
        self.policy = policy
        self.cold_start_s = cold_start_s
        self.quantum_s = quantum_s
        self.faults = faults
        self.checkpoint = checkpoint
        self.elastic = elastic

    # ------------------------------------------------------------------
    def run(self, trace: Trace) -> ClusterReport:
        with TRACER.span("cluster.run", policy=self.policy.name,
                         trace=trace.name, devices=len(self.fleet),
                         jobs=len(trace.jobs)):
            report = self._run(trace)
        self._publish_metrics(report)
        return report

    def _publish_metrics(self, report: "ClusterReport") -> None:
        """Bulk-publish one run's loop counters into the obs registry.

        Done once per run (never inside the event loop) so the hot path
        keeps its plain local counters; labels carry the policy so
        multi-policy sweeps in one process stay distinguishable."""
        c = REGISTRY.counter
        policy = report.policy
        c("cluster_runs_total", policy=policy).inc()
        c("cluster_events_total", policy=policy).inc(
            report.events_processed)
        c("cluster_hol_events_total", policy=policy).inc(report.hol_events)
        c("cluster_hol_bypasses_total", policy=policy).inc(
            report.hol_bypasses)
        c("cluster_device_failures_total", policy=policy).inc(
            report.device_failures)
        c("cluster_link_failures_total", policy=policy).inc(
            report.link_failures)
        c("cluster_recoveries_total", policy=policy).inc(report.recoveries)
        c("cluster_gang_reshapes_total", policy=policy).inc(
            report.gang_reshapes)
        REGISTRY.histogram("cluster_makespan_seconds", policy=policy) \
            .observe(report.makespan_s)

    def _run(self, trace: Trace) -> ClusterReport:
        fleet, cost, ckpt = self.fleet, self.cost, self.checkpoint
        for dev in fleet:            # reset between runs: fleets are reusable
            dev.free_at = dev.busy_seconds = dev.setup_seconds = 0.0
            dev.jobs_done, dev.last_class = 0, None
        fleet.broken_links = set()
        # hand the policy the fleet's shape (topology + id->position map)
        self.policy.bind_fleet(fleet)

        ref_hw = fleet.slots[0].hw   # service predictions for SJF ordering
        max_hbm = fleet.max_hbm_bytes()
        topo = fleet.topology
        slot_of = {d.device_id: d for d in fleet}
        pos_of = {d.device_id: i for i, d in enumerate(fleet.slots)}
        node_id = {d.device_id: (topo.ids[i] if topo is not None else i)
                   for i, d in enumerate(fleet.slots)}

        heap: List[Tuple[float, int, int, object]] = []
        seq = 0
        for job in trace.jobs:
            heapq.heappush(heap, (job.arrival_s, seq, _ARRIVAL, job))
            seq += 1
        total_jobs = len(trace.jobs)
        finished = 0

        # failure streams: lazy per-target outage iterators; only the NEXT
        # outage sits in the heap, the one after is pulled at repair time —
        # and only while unfinished jobs remain, so infinite renewal
        # processes cannot keep an otherwise-drained loop alive
        sched: Dict[Tuple[str, str], Iterator[Tuple[float, float]]] = {}

        def push_outage(tkind: str, key: str, pair) -> None:
            nonlocal seq
            nxt = next(sched[(tkind, key)], None)
            if nxt is not None:
                heapq.heappush(heap, (nxt[0], seq, _FAIL,
                                      (tkind, key, pair, nxt)))
                seq += 1

        if self.faults is not None and trace.jobs:
            for d in fleet:
                sched[(DEVICE, d.device_id)] = \
                    self.faults.device_schedule(d.device_id)
                push_outage(DEVICE, d.device_id, None)
            if self.faults.has_link_failures and topo is not None:
                for a, b in topo.links():
                    pair = undirected_pair(a, b)
                    key = link_key(*pair)
                    if (LINK, key) in sched:
                        continue
                    sched[(LINK, key)] = self.faults.link_schedule(key)
                    push_outage(LINK, key, pair)

        queue: List[QueuedJob] = []
        records: Dict[str, JobRecord] = {}
        slices: List[Slice] = []
        active: Dict[str, dict] = {}          # device id -> shared gang ctx
        gangs: Dict[int, dict] = {}           # id(ctx) -> multi-device ctxs
        device_down: Dict[str, float] = {}    # device id -> repair time
        down_iv: Dict[str, List[Tuple[float, float]]] = \
            {d.device_id: [] for d in fleet}
        link_iv: Dict[str, List[Tuple[float, float]]] = {}
        marks: List[dict] = []
        hol_events = 0
        hol_blocked: List[str] = []
        hol_bypasses = 0
        device_failures = link_failures = recoveries = gang_reshapes = 0
        arrival_seq = 0
        events_processed = 0
        pending_reshapes = 0          # queued jobs with reshape_pending set

        # incremental policy state: on a uniform-HBM fleet every queued job
        # fits every device (oversubscribed jobs fit by definition; the rest
        # have peak <= max_hbm == every slot's HBM), so feasibility reduces
        # to num_devices <= len(free) and the head-of-line probe only needs
        # the smallest gang size currently queued — a per-size counter
        # maintained at every queue mutation instead of a full queue rescan
        # per event
        uniform_fleet = all(d.hw.hbm_bytes == max_hbm for d in fleet)
        uniform_hw = all(d.hw == ref_hw for d in fleet)
        nd_counts: Dict[int, int] = {}
        seq_heap: List[int] = []      # lazy min-heap over queued seqs
        live_seqs: set = set()
        # event-coalescing state: once a pass ends with select() == None,
        # the policy stays blocked until the free set GROWS or the queue
        # changes — a shrink (device failure) or a fabric-health change can
        # never create a placement that did not exist, so those events skip
        # the policy rescan entirely (the HoL predicate is re-answered from
        # the O(1) gang-size counter instead)
        sched_blocked = False

        def q_add(qj: QueuedJob) -> None:
            nonlocal sched_blocked
            sched_blocked = False
            queue.append(qj)
            nd_counts[qj.num_devices] = nd_counts.get(qj.num_devices, 0) + 1
            heapq.heappush(seq_heap, qj.seq)
            live_seqs.add(qj.seq)

        def q_remove(qj: QueuedJob) -> None:
            nonlocal sched_blocked
            sched_blocked = False
            queue.remove(qj)
            n = nd_counts[qj.num_devices] - 1
            if n:
                nd_counts[qj.num_devices] = n
            else:
                del nd_counts[qj.num_devices]
            live_seqs.discard(qj.seq)

        def queue_min_seq() -> int:
            while seq_heap and seq_heap[0] not in live_seqs:
                heapq.heappop(seq_heap)
            return seq_heap[0] if seq_heap else -1

        _state_bytes: Dict[str, float] = {}

        def state_bytes_of(job_class: str) -> float:
            """Checkpoint payload: the class's full model/optimizer-state
            footprint (the allocator's high-water mark on the reference
            chip — the same number placement shards across the gang)."""
            got = _state_bytes.get(job_class)
            if got is None:
                got = _state_bytes[job_class] = \
                    cost.peak_hbm_bytes(job_class, ref_hw)
            return got

        def start_one(qj: QueuedJob, devs: Tuple[DeviceSlot, ...],
                      now: float) -> float:
            nonlocal seq
            job = qj.job
            nd = len(devs)
            # gang members step in LOCKSTEP, so the slowest chip's engine
            # makespan prices the whole gang's step (on a uniform fleet the
            # max over identical prices is one query)
            base_step = cost.report(job.job_class, devs[0].hw).total_seconds \
                if uniform_hw else \
                max(cost.report(job.job_class, d.hw).total_seconds
                    for d in devs)
            factor = 1.0
            if qj.base_devices and nd < qj.base_devices:
                # elastic shrink: the same global batch over fewer devices
                factor *= qj.base_devices / nd
            if nd > 1 and topo is not None and fleet.broken_links:
                factor *= gang_dilation(
                    topo, [node_id[d.device_id] for d in devs],
                    fleet.broken_links, devs[0].hw)
            per_step = base_step * factor
            cold = [d for d in devs if d.last_class != job.job_class] \
                if self.cold_start_s > 0 else []
            setup = self.cold_start_s if cold else 0.0
            rec = records[job.job_id]
            rec.cold_starts += len(cold)
            # restore: a failure sent this job back to its last durable
            # checkpoint; before re-running it pays the priced read-back
            # (+ gang re-shard) — interrupted restores pay again
            done = job.num_steps - qj.remaining_steps
            restore_s = 0.0
            if qj.needs_restore and ckpt is not None and done > 0:
                sb = state_bytes_of(job.job_class)
                restore_s = ckpt.restore_seconds(sb, devs[0].hw, gang=nd) \
                    if uniform_hw else \
                    max(ckpt.restore_seconds(sb, d.hw, gang=nd)
                        for d in devs)
                rec.restores += 1
            qj.needs_restore = False
            # checkpoint cadence inside this slice: k steps per save, each
            # member writing its 1/nd shard (lockstep: slowest shard wins)
            k, w = 0, 0.0
            if ckpt is not None and ckpt.interval_s > 0 and per_step > 0:
                k = ckpt.steps_per_checkpoint(per_step)
                sb = state_bytes_of(job.job_class)
                w = ckpt.save_seconds(sb / nd, devs[0].hw) if uniform_hw \
                    else max(ckpt.save_seconds(sb / nd, d.hw) for d in devs)
            steps = qj.remaining_steps
            if self.quantum_s is not None and per_step > 0:
                steps = min(steps, max(int(self.quantum_s / per_step), 1))
            if k > 0:
                # completing slices skip the trailing write (the job is
                # done); preempted slices pay it so the quantum boundary
                # stays a durable point, as it is for free without a model
                n_ck = (steps - 1) // k if steps == qj.remaining_steps \
                    else -(-steps // k)
            else:
                n_ck = 0
            run_s = steps * per_step + n_ck * w
            # devs come from fleet.free(now), so every free_at <= now and
            # the legacy max(now, *free_at) is exactly now
            t0 = now
            run_t0 = t0 + setup + restore_s
            group = tuple(d.device_id for d in devs) if nd > 1 else ()
            ctx = {"qj": qj, "devs": devs, "t0": run_t0,
                   "per_step": per_step, "steps": steps, "k": k, "w": w,
                   "finish": run_t0 + run_s, "restored": restore_s > 0,
                   "pre": [], "run": []}
            for d in devs:
                if d in cold:
                    s = Slice(d.device_id, job.job_id, job.job_class,
                              t0, t0 + setup, kind="setup", group=group)
                    slices.append(s)
                    ctx["pre"].append(s)
                if restore_s > 0:
                    s = Slice(d.device_id, job.job_id, job.job_class,
                              t0 + setup, run_t0, kind="restore",
                              group=group)
                    slices.append(s)
                    ctx["pre"].append(s)
                s = Slice(d.device_id, job.job_id, job.job_class,
                          run_t0, run_t0 + run_s, steps=steps, group=group,
                          ckpt_s=n_ck * w, price_factor=factor)
                slices.append(s)
                ctx["run"].append(s)
                d.free_at = run_t0 + run_s
                d.last_class = job.job_class
                active[d.device_id] = ctx
            if nd > 1:
                gangs[id(ctx)] = ctx      # link-failure kill scan registry
                TRACER.instant("cluster.gang_start", job=job.job_id,
                               devices=nd, t_sim=now)
            if qj.first_start_s is None:
                qj.first_start_s = t0
                rec.start_s = t0
            rec.service_s += run_s
            rec.device_id = "+".join(d.device_id for d in devs)
            qj.remaining_steps -= steps
            finish = run_t0 + run_s
            heapq.heappush(heap, (finish, seq, _FINISH, (qj, devs, qj.epoch)))
            seq += 1
            return finish

        def predicted_service(qj: QueuedJob) -> float:
            per = cost.report(qj.job.job_class, ref_hw).total_seconds
            if qj.base_devices and qj.num_devices < qj.base_devices:
                per *= qj.base_devices / qj.num_devices
            return qj.remaining_steps * per

        def kill_gang(ctx: dict, now: float, failed_ids=()) -> None:
            """A fault killed this running gang: truncate its occupancy to
            ``now``, roll the job back to its last durable point, requeue."""
            nonlocal arrival_seq, pending_reshapes
            qj: QueuedJob = ctx["qj"]
            devs = ctx["devs"]
            TRACER.instant("cluster.gang_kill", job=qj.job.job_id,
                           devices=len(devs), t_sim=now)
            qj.epoch += 1                 # invalidate the pending FINISH
            rec = records[qj.job.job_id]
            rec.failures += 1
            steps, k, w, per_step = (ctx["steps"], ctx["k"], ctx["w"],
                                     ctx["per_step"])
            e = now - ctx["t0"]
            if e <= 0:
                # killed during setup/restore: no run time spent, nothing
                # committed; an interrupted restore must be paid again
                committed, spent_ck, lost = 0, 0.0, 0.0
                for s in ctx["pre"]:
                    if s.kind == "setup" and s.t1 > now:
                        # the class switch never completed: the device is
                        # NOT warm, so the retry must repay the cold start
                        slot_of[s.device_id].last_class = None
                    s.t0, s.t1 = min(s.t0, now), min(s.t1, now)
                for s in ctx["run"]:
                    s.t0 = s.t1 = now
                    s.steps = 0
                qj.needs_restore = ctx["restored"] or qj.needs_restore
            else:
                if k > 0:
                    # whole checkpoint cycles (k steps + one write) commit;
                    # the partial tail — steps and any in-flight write — is
                    # lost and re-run after restore
                    cycle = k * per_step + w
                    c = int(e // cycle)
                    committed = min(c * k, steps)
                    spent_ck = c * w
                    lost = e - c * cycle
                else:
                    committed, spent_ck, lost = 0, 0.0, e
                for s in ctx["run"]:
                    s.t1 = now
                    s.steps = committed
                    s.ckpt_s = spent_ck
                    s.lost_s = lost
                qj.needs_restore = True
            rec.lost_work_s += lost
            rec.service_s -= ctx["finish"] - max(now, ctx["t0"])
            qj.remaining_steps += steps - committed
            gangs.pop(id(ctx), None)
            for d in devs:
                active.pop(d.device_id, None)
                if d.device_id not in failed_ids:
                    d.free_at = now       # survivors free immediately
            qj.seq = arrival_seq
            arrival_seq += 1
            qj.service_s = predicted_service(qj)
            qj.reshape_pending = self.elastic and qj.num_devices > 1
            if qj.reshape_pending:
                pending_reshapes += 1
            q_add(qj)

        def reshape_pass() -> None:
            """Elastic gangs killed by a failure reshape onto the surviving
            device count at their first post-failure scheduling pass (after
            ALL same-timestamp failures have drained, so simultaneous
            multi-device outages are seen at once)."""
            nonlocal gang_reshapes, pending_reshapes, sched_blocked
            if not pending_reshapes:
                return                # nothing queued was failure-killed
            sched_blocked = False     # gang shapes may shrink below
            up = len(fleet) - len(device_down)
            for qj in queue:
                if not qj.reshape_pending:
                    continue
                qj.reshape_pending = False
                if up <= 0 or up >= qj.num_devices:
                    continue
                full_peak = qj.peak_hbm_bytes * qj.num_devices
                old_nd = qj.num_devices
                qj.num_devices = max(up, 1)
                qj.peak_hbm_bytes = full_peak / qj.num_devices
                qj.oversubscribed = (qj.oversubscribed
                                     or qj.peak_hbm_bytes > max_hbm)
                qj.service_s = predicted_service(qj)
                gang_reshapes += 1
                records[qj.job.job_id].reshapes += 1
                TRACER.instant("cluster.gang_reshape", job=qj.job.job_id,
                               old=old_nd, new=qj.num_devices)
                n = nd_counts[old_nd] - 1
                if n:
                    nd_counts[old_nd] = n
                else:
                    del nd_counts[old_nd]
                nd_counts[qj.num_devices] = \
                    nd_counts.get(qj.num_devices, 0) + 1
            pending_reshapes = 0      # every flag was consumed above

        def hol_check(free) -> None:
            # head-of-line diagnosis: the head cannot start but a
            # younger queued job could — the FIFO pathology the
            # MLaaS traces blame for short-job delays.  Feasibility
            # per job is the O(log n) capacity bisect, not a
            # materialized first-fit tuple.
            # (select() returning None means the head itself cannot
            # fit, so probing the WHOLE queue equals probing
            # queue[1:] — which lets the uniform-fleet path answer
            # from the incremental gang-size counter alone)
            nonlocal hol_events
            head = queue[0]
            if uniform_fleet:
                blocked_could = min(nd_counts) <= len(free)
            else:
                hbm_sorted = self.policy.free_hbm_sorted(free)
                blocked_could = any(
                    self.policy.can_fit(qj, hbm_sorted)
                    for qj in queue[1:])
            if blocked_could:
                hol_events += 1
                if head.job.job_id not in hol_blocked:
                    hol_blocked.append(head.job.job_id)

        def schedule_pass(now: float) -> None:
            nonlocal hol_events, hol_bypasses, sched_blocked
            if pending_reshapes:
                reshape_pass()
            if sched_blocked:
                # coalesced replay: since the blocking pass the free set
                # never grew and the queue never changed (those events clear
                # the flag), so select() would return None again — a shrink
                # can only remove placements.  Only the head-of-line
                # accounting depends on the current free set, so re-answer
                # it from the O(1)/O(log n) predicate and skip the policy.
                if queue:
                    free = fleet.free(now)
                    if free:
                        hol_check(free)
                return
            while queue:
                free = fleet.free(now)
                if not free:
                    sched_blocked = True
                    return
                sel = self.policy.select(queue, free, now)
                if sel is None:
                    hol_check(free)
                    sched_blocked = True
                    return
                qj, devs = sel
                # seqs are unique, so "an older job was jumped" is just a
                # min-seq comparison (tracked incrementally, not rescanned)
                if queue_min_seq() < qj.seq:
                    hol_bypasses += 1
                q_remove(qj)
                start_one(qj, devs, now)
            sched_blocked = True          # empty queue: next q_add resets

        heappop = heapq.heappop               # hot-loop local binding
        while heap:
            now = heap[0][0]
            # drain every event at `now` before making placement decisions
            while heap and heap[0][0] == now:
                _t, _s, kind, payload = heappop(heap)
                events_processed += 1
                if kind == _ARRIVAL:
                    job: Job = payload
                    # gangs larger than the fleet are clamped (and flagged):
                    # the job runs degraded rather than queueing forever
                    nd = max(getattr(job, "num_devices", 1), 1)
                    clamped = nd > len(fleet)
                    nd = min(nd, len(fleet))
                    # sharded-model assumption: the gang splits the class's
                    # peak footprint evenly across its devices
                    peak = cost.peak_hbm_bytes(job.job_class, ref_hw) / nd
                    over = clamped or peak > max_hbm
                    records[job.job_id] = JobRecord(
                        job.job_id, job.job_class, job.user, device_id="",
                        arrival_s=job.arrival_s, start_s=job.arrival_s,
                        finish_s=job.arrival_s, service_s=0.0,
                        num_steps=job.num_steps, oversubscribed=over)
                    q_add(QueuedJob(
                        job, arrival_seq,
                        service_s=cost.service_seconds(job, ref_hw),
                        peak_hbm_bytes=peak,
                        remaining_steps=job.num_steps, num_devices=nd,
                        oversubscribed=over, base_devices=nd))
                    arrival_seq += 1
                elif kind == _FINISH:
                    qj, devs, epoch = payload
                    if epoch != qj.epoch:
                        continue          # gang was killed: stale event
                    sched_blocked = False     # the free set just grew
                    if len(devs) > 1:
                        ctx = active.get(devs[0].device_id)
                        if ctx is not None:
                            gangs.pop(id(ctx), None)
                    for dev in devs:
                        dev.jobs_done += 1
                        active.pop(dev.device_id, None)
                    if qj.remaining_steps > 0:
                        # preempted: re-sequenced to the BACK of the line,
                        # so fifo + quantum is round-robin time-slicing;
                        # service prediction shrinks to the REMAINING work
                        # (sjf must order by what is left, not the original
                        # total)
                        qj.preemptions += 1
                        records[qj.job.job_id].preemptions += 1
                        qj.seq = arrival_seq
                        arrival_seq += 1
                        qj.service_s = predicted_service(qj)
                        q_add(qj)
                    else:
                        records[qj.job.job_id].finish_s = now
                        finished += 1
                elif kind == _FAIL:
                    tkind, key, pair, (fail_t, rep_t) = payload
                    if finished >= total_jobs:
                        continue          # fleet drained: outage is moot
                    marks.append({"t": now, "target": tkind, "key": key})
                    TRACER.instant("cluster.fail", target=tkind, key=key,
                                   t_sim=now)
                    if tkind == DEVICE:
                        device_failures += 1
                        down_iv[key].append((now, rep_t))
                        device_down[key] = rep_t
                        ctx = active.get(key)
                        if ctx is not None:
                            kill_gang(ctx, now, failed_ids={key})
                        slot_of[key].free_at = rep_t
                        # a repaired device comes back COLD: whatever class
                        # state it held died with it (keeping it "warm"
                        # skipped the setup tax and biased locality toward
                        # freshly rebooted devices)
                        slot_of[key].last_class = None
                    else:
                        link_failures += 1
                        link_iv.setdefault(key, []).append((now, rep_t))
                        fleet.broken_links.add(pair)
                        # kill every gang whose collectives cross the link
                        # (the registry holds exactly the multi-device ctxs,
                        # so no dedup scan over per-device entries)
                        for ctx in list(gangs.values()):
                            gang = ctx["devs"]
                            if topo is None:
                                continue
                            inside = topo.internal_links(
                                [pos_of[d.device_id] for d in gang])
                            if pair in inside:
                                kill_gang(ctx, now)
                    heapq.heappush(heap, (rep_t, seq, _REPAIR,
                                          (tkind, key, pair)))
                    seq += 1
                else:                     # _REPAIR
                    tkind, key, pair = payload
                    recoveries += 1
                    TRACER.instant("cluster.repair", target=tkind, key=key,
                                   t_sim=now)
                    if tkind == DEVICE:
                        device_down.pop(key, None)
                        sched_blocked = False     # the free set just grew
                    else:
                        fleet.broken_links.discard(pair)
                    if finished < total_jobs:
                        push_outage(tkind, key, pair)
            schedule_pass(now)

        # one fused pass over the tape: drop the zero-width slices that
        # degenerate truncations (killed before any run time) leave behind,
        # and compute every per-device/per-kind aggregate — the single
        # source of truth once failures can rewrite history
        busy = {d.device_id: 0.0 for d in fleet}
        setup = dict(busy)
        ckpt_total = restore_total = lost_total = 0.0
        makespan = 0.0
        kept: List[Slice] = []
        for s in slices:
            if not (s.t1 > s.t0 or s.steps > 0):
                continue
            kept.append(s)
            if s.t1 > makespan:
                makespan = s.t1
            if s.kind == "run":
                busy[s.device_id] += (s.t1 - s.t0) - s.ckpt_s - s.lost_s
                ckpt_total += s.ckpt_s
                lost_total += s.lost_s
            elif s.kind == "setup":
                setup[s.device_id] += s.t1 - s.t0
            elif s.kind == "restore":
                restore_total += s.t1 - s.t0
        slices = kept
        for d in fleet:
            d.busy_seconds = busy[d.device_id]
            d.setup_seconds = setup[d.device_id]
        # requeue waits: a preempted or failure-killed job waits again
        # between consecutive occupancy slices.  The per-job slice-UNION
        # gaps (gang slices share spans, so the union collapses them) are
        # exactly the post-first-start waiting the (+1/-1) queue-depth
        # export integrates — recorded per job so Little's law over the
        # waiting room closes against total_queue_delay_s.
        spans_by_job: Dict[str, List[Tuple[float, float]]] = {}
        for s in slices:
            spans_by_job.setdefault(s.job_id, []).append((s.t0, s.t1))
        for job_id, spans in spans_by_job.items():
            spans.sort()
            wait, reach = 0.0, None
            for t0, t1 in spans:
                if reach is not None and t0 > reach:
                    wait += t0 - reach
                reach = t1 if reach is None else max(reach, t1)
            if wait > 0.0:
                records[job_id].requeue_wait_s = wait
        # acceptance invariant RHS, recomputed from the cost model: every
        # run slice is `steps` Engine-simulated step makespans on its
        # device's chip (for gangs: the slowest member's chip, the lockstep
        # price), scaled by the slice's degradation factor — must match the
        # loop's accumulated useful busy time
        hw_of = {d.device_id: d.hw for d in fleet}
        price_memo: Dict[tuple, float] = {}
        engine_service = 0.0
        for s in slices:
            if s.kind != "run":
                continue
            # the inner max is pure in (class, gang): memoize it so the
            # reconciliation sweep prices each distinct placement once
            # instead of re-querying the cost model per slice
            pkey = (s.job_class, s.group or s.device_id)
            p = price_memo.get(pkey)
            if p is None:
                p = max(cost.report(s.job_class, hw_of[d]).total_seconds
                        for d in (s.group or (s.device_id,)))
                price_memo[pkey] = p
            engine_service += s.steps * s.price_factor * p
        hits, misses = cost.cache_stats()
        ordered = [records[j.job_id] for j in trace.jobs]
        return ClusterReport(
            policy=self.policy.name,
            trace_name=trace.name,
            num_devices=len(fleet),
            jobs=ordered,
            slices=slices,
            makespan_s=makespan,
            fleet_busy_seconds=sum(busy.values()),
            fleet_setup_seconds=sum(setup.values()),
            per_device_busy=dict(busy),
            engine_service_seconds=engine_service,
            hol_events=hol_events,
            hol_blocked_jobs=tuple(hol_blocked),
            hol_bypasses=hol_bypasses,
            cache_hits=hits,
            cache_misses=misses,
            checkpoint_seconds=ckpt_total,
            restore_seconds=restore_total,
            lost_work_seconds=lost_total,
            device_failures=device_failures,
            link_failures=link_failures,
            recoveries=recoveries,
            gang_reshapes=gang_reshapes,
            events_processed=events_processed,
            down_intervals={d: iv for d, iv in down_iv.items() if iv},
            link_down_intervals=link_iv,
            failure_marks=marks,
        )
