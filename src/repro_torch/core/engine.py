"""Event-driven timeline engine (the Performance-simulation mode of the paper).

Walks the entry computation as a true dataflow graph and *list-schedules*
every op ASAP at ``max(operand-ready, resource-free)`` over independent
per-resource free times — MXU, VPU, HBM, the per-op issue ("overhead") slot,
and the ICI fabric — plus a configurable number of compute *streams* that
model dispatch concurrency:

* ``num_compute_streams=1`` (default): compute ops serialize among
  themselves like a TPU TensorCore, but collectives still overlap with
  compute when dependencies allow;
* ``num_compute_streams>1``: independent compute ops may also overlap
  (async-dispatch scenarios), still serializing per bottleneck unit.

Dependencies come from each :class:`SimOp`'s operands (the def-use edges
:mod:`repro_torch.core.hlo_ir` exposes), so producer/consumer ordering, while-loop
carried dependences and trailing-collective results are all honored — a
consumer of a collective waits for the collective, not for the compute chain.

While-loops are simulated once per body and scaled by trip count; the
timeline stores one representative iteration (cheap) plus the scale factor
(the same trick as the paper's CTA-window checkpointing: simulate a window in
detail, extrapolate the rest).  The ``window=`` fast-forward flows through
the same scheduler, so windowed and full runs agree on totals (including the
launch-overhead tax).

Beyond busy totals, the schedule yields per-unit *exposed* seconds (span
where only that unit is active — the generalization of exposed-collective
time) and per-unit *critical-path* seconds (time attributed to each unit
along the binding-constraint chain that determines the makespan).

With ``memory_model=True`` (default) the engine additionally consults
:mod:`repro_torch.memory`: a live-range allocator assigns every value an HBM
placement, the flat ``hbm`` clock is replaced by per-channel free times
(an op's HBM duration is ``max_over_channels(bytes / per_channel_bw)``,
so camping gather/scatter traffic genuinely dilates the timeline the way
the paper's partition camping does), and VMEM-overflowing working sets pay
spill traffic.  ``SimReport`` then carries ``peak_hbm_bytes``,
``spill_bytes`` and per-channel busy seconds, and every ``TimelineEntry``
its channel-byte split.

With ``topology_model=True`` (default) the ICI fabric gets the same
treatment via :mod:`repro_torch.topology`: every collective is lowered onto the
``hw.ici_topology`` fabric into a per-link transfer schedule, and instead of
one flat ``ici`` clock the op contends on — and claims — exactly the
``"ici:<src>-<dst>"`` link clocks its schedule touches.  Collectives on
disjoint links (different mesh axes / replica groups) genuinely overlap;
shared-link collectives serialize.  ``SimReport`` carries per-link busy
seconds (``link_busy_seconds``/``link_imbalance``) and every collective
``TimelineEntry`` its link-byte split.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.hlo_ir import (
    _BODY_RE, _CALLS_RE, _TO_APPLY_RE, Computation, SimModule, SimOp,
)
from repro_torch.core.hw import HardwareSpec, V5E
from repro_torch.core.timing import OpTime, op_time
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import TRACER

SKIP_OPS = ("parameter", "constant", "tuple", "get-tuple-element", "bitcast",
            "after-all", "partition-id", "replica-id", "domain",
            "opt-barrier")

#: schedulable resources with independent free times ("overhead" is the
#: issue slot zero-work ops occupy; "ici" is the interconnect fabric).
#: The single source of truth — repro_torch.analysis conserves per-resource
#: busy time against exactly this set.  Under the memory model the flat
#: "hbm" clock splits into "hbm:<channel>" keys, and under the topology
#: model collectives claim per-link "ici:<src>-<dst>" keys instead of the
#: flat "ici" clock (busy-time ACCOUNTING stays on these five units).
RESOURCES = ("mxu", "vpu", "hbm", "overhead", "ici")


@dataclass
class TimelineEntry:
    """One scheduled op on the simulated timeline.

    A while-body op is recorded ONCE (its representative iteration) with
    ``scale`` = trip count; its modeled span on the wall clock is
    ``duration * scale`` starting at ``start``.  ``flops``/``hbm_bytes``/
    ``ici_bytes`` are per-iteration — multiply by ``scale`` for totals.
    """

    name: str               # HLO op name (unique within the module)
    opcode: str             # HLO opcode ("dot", "fusion", "all-reduce", ...)
    unit: str               # bottleneck resource: "mxu"|"vpu"|"hbm"|"ici"|"overhead"
    start: float            # scheduled start time [s]
    duration: float         # per-iteration modeled duration [s], incl. overhead
    scale: float            # trip-count multiplier (1.0 outside while bodies)
    flops: float            # per-iteration FLOPs retired by this op
    hbm_bytes: float        # per-iteration HBM traffic [bytes]
    ici_bytes: float        # per-iteration interconnect traffic [bytes]
    comp: str = ""          # enclosing HLO computation name
    overhead_s: float = 0.0  # issue/launch-cost portion of ``duration`` [s]
    exposed_s: float = 0.0   # wall-clock span where this op's unit ran alone
    #: per-iteration HBM bytes per channel (index = channel id), produced by
    #: the memory model from the op's buffer placements; None on legacy runs
    channel_bytes: Optional[List[float]] = None
    spill_bytes: float = 0.0  # per-iteration VMEM-spill HBM traffic [bytes]
    #: per-iteration ICI bytes per link ("ici:<src>-<dst>" keys) from the
    #: topology lowering of a collective; None on non-collectives/legacy runs
    link_bytes: Optional[Dict[str, float]] = None
    #: per-iteration busy SECONDS per link (same keys) — what
    #: ``SimReport.link_busy_seconds`` accumulates; recorded so the
    #: time-lapse can apportion link utilization to intervals exactly
    link_seconds: Optional[Dict[str, float]] = None


@dataclass
class _Node:
    """Critical-path bookkeeping for one scheduled (or fast-forwarded) op."""

    unit: str
    seconds: float           # duration * scale: wall-clock contribution
    finish: float
    pred: Optional[str]      # node id of the constraint that set our start


@dataclass
class SimReport:
    """Aggregate result of one performance simulation.

    ``timeline`` holds the per-op schedule (see :class:`TimelineEntry`);
    everything else is a whole-run total.  Post-process the timeline into
    time-bucketed per-unit views with :mod:`repro_torch.analysis` (or the
    :meth:`analysis` shortcut).
    """

    total_seconds: float          # modeled wall-clock for one step [s]
    compute_seconds: float        # busy time on the compute core [s]
    ici_seconds: float            # busy time on the ICI fabric [s]
    exposed_ici_seconds: float    # ICI time NOT hidden behind compute [s]
    unit_seconds: Dict[str, float]  # busy seconds keyed by bottleneck unit
    total_flops: float            # FLOPs retired (trip-count scaled)
    total_hbm_bytes: float        # HBM traffic [bytes] (trip-count scaled)
    total_ici_bytes: float        # ICI traffic [bytes] (trip-count scaled)
    timeline: List[TimelineEntry]
    hw: HardwareSpec = V5E
    #: per-unit span where ONLY that unit was active — the generalization of
    #: exposed-collective time: shrinking an exposed unit shortens the run
    exposed_seconds: Dict[str, float] = field(default_factory=dict)
    #: per-unit seconds along the binding-constraint chain ending at the
    #: makespan — which unit the run's length is actually charged to
    critical_path_seconds: Dict[str, float] = field(default_factory=dict)
    #: issue cost of ops fast-forwarded outside a ``window=`` run (they carry
    #: no timeline entry, so the property below adds this explicitly)
    ff_overhead_seconds: float = 0.0
    #: peak simultaneous HBM bytes (the live-range allocator's high-water
    #: mark); 0.0 when the memory model is off
    peak_hbm_bytes: float = 0.0
    #: HBM traffic added by VMEM working-set spills (trip-count scaled);
    #: already included in ``total_hbm_bytes``
    spill_bytes: float = 0.0
    #: per-channel HBM transfer busy seconds (index = channel id); empty
    #: when the memory model is off
    channel_busy_seconds: List[float] = field(default_factory=list)
    #: the allocator's full report (repro_torch.memory.AllocationMap), or None
    memory: Optional[Any] = None
    #: per-ICI-link transfer busy seconds ("ici:<src>-<dst>" keys) from the
    #: topology model; empty when it is off (or no collectives ran)
    link_busy_seconds: Dict[str, float] = field(default_factory=dict)

    @staticmethod
    def _ratio(num: float, den: float) -> float:
        """Ratio guarded against empty runs / zero-capability specs: a
        zero-duration timeline or a zero-bandwidth HardwareSpec reads as
        0.0 utilization, never a ZeroDivisionError."""
        if den <= 0:
            return 0.0
        return num / den

    @property
    def mfu(self) -> float:
        return self._ratio(self.total_flops,
                           self.total_seconds * self.hw.peak_bf16_flops)

    @property
    def hbm_utilization(self) -> float:
        return self._ratio(self.total_hbm_bytes,
                           self.total_seconds * self.hw.hbm_bw)

    @property
    def peak_hbm_fraction(self) -> float:
        """Peak live footprint as a fraction of HBM capacity."""
        return self._ratio(self.peak_hbm_bytes, self.hw.hbm_bytes)

    @property
    def spill_fraction(self) -> float:
        """Share of the HBM traffic that is VMEM spill."""
        return self._ratio(self.spill_bytes, self.total_hbm_bytes)

    @property
    def channel_imbalance(self) -> float:
        """Busiest-channel busy seconds / mean (1.0 = perfectly balanced)."""
        if not self.channel_busy_seconds:
            return 1.0
        mean = sum(self.channel_busy_seconds) / len(self.channel_busy_seconds)
        if mean <= 0:
            return 1.0
        return max(self.channel_busy_seconds) / mean

    @property
    def link_imbalance(self) -> float:
        """Busiest-link busy seconds / mean (1.0 = perfectly balanced) —
        the ICI analogue of ``channel_imbalance``: well above ~1.5 means a
        minority of links (one camped mesh axis) gates the fabric."""
        if not self.link_busy_seconds:
            return 1.0
        vals = list(self.link_busy_seconds.values())
        mean = sum(vals) / len(vals)
        if mean <= 0:
            return 1.0
        return max(vals) / mean

    @property
    def launch_overhead_seconds(self) -> float:
        """Total per-op issue cost — the paper's kernel-launch-overhead tax.

        Includes ops fast-forwarded by ``window=`` (via
        ``ff_overhead_seconds``), so windowed and full runs agree.
        """
        return (sum(e.overhead_s * e.scale for e in self.timeline)
                + self.ff_overhead_seconds)

    def analysis(self, num_buckets: int = 120):
        """Phase-analysis view of this report (see :mod:`repro_torch.analysis`)."""
        from repro_torch.analysis import analyze
        return analyze(self, num_buckets=num_buckets)

    def summary(self) -> Dict[str, float]:
        return {
            "total_seconds": self.total_seconds,
            "compute_seconds": self.compute_seconds,
            "ici_seconds": self.ici_seconds,
            "exposed_ici_seconds": self.exposed_ici_seconds,
            "mfu": self.mfu,
            "hbm_utilization": self.hbm_utilization,
            "total_flops": self.total_flops,
            "total_hbm_bytes": self.total_hbm_bytes,
            "total_ici_bytes": self.total_ici_bytes,
            "launch_overhead_seconds": self.launch_overhead_seconds,
            "peak_hbm_bytes": self.peak_hbm_bytes,
            "peak_hbm_fraction": self.peak_hbm_fraction,
            "spill_bytes": self.spill_bytes,
            "spill_fraction": self.spill_fraction,
            "channel_imbalance": self.channel_imbalance,
            "link_imbalance": self.link_imbalance,
            "link_busy_total_seconds": sum(self.link_busy_seconds.values()),
            **{f"unit_{k}_seconds": v for k, v in self.unit_seconds.items()},
            **{f"exposed_{k}_seconds": v
               for k, v in self.exposed_seconds.items()},
            **{f"critical_path_{k}_seconds": v
               for k, v in self.critical_path_seconds.items()},
        }


class SimulationCache:
    """Keyed memo for :meth:`Engine.simulate` results.

    Cluster runs (``repro_torch.cluster``) re-simulate the same captured job class
    thousands of times on identical ``(SimModule, window, HardwareSpec)``
    inputs; the simulation is deterministic, so the second and later calls
    can return the first call's :class:`SimReport` verbatim.  The key also
    covers every Engine knob that changes the schedule (overlap, stream
    count, memory model), so one cache can safely back heterogeneous
    engines.  Modules are keyed by identity (and kept referenced so ids
    cannot be recycled): two textually equal but distinct parses are
    conservatively treated as different workloads.

    Cached reports are returned *shared* — callers must treat them as
    read-only.  ``hits``/``misses`` feed the cluster's hit-rate counter.

    The key decomposes into (module, hw, knobs, faults) parts so the
    batched scheduler's *delta re-simulation* can tell which family a
    change lives in: the cache also registers each recorded
    :class:`~repro_torch.core.fastsched.ModuleTape` under its ``(module, hw,
    knobs)`` family, and an engine differing ONLY in the faults part (a
    broken-link set, a checkpoint/faults key) reprices the donor tape's
    collective steps instead of re-walking the module.
    """

    def __init__(self):
        self.hits = 0
        self.misses = 0
        self._reports: Dict[tuple, SimReport] = {}
        self._modules: Dict[int, SimModule] = {}   # pin ids (see docstring)
        #: tape family -> (faults part, ModuleTape): donor tapes for the
        #: batched scheduler's cross-engine delta re-simulation
        self._tapes: Dict[tuple, tuple] = {}
        # registry children resolved once: lookup() is the cluster's
        # hottest call site, so publishing must be one bound .inc()
        self._hits_ctr = REGISTRY.counter("sim_cache_hits_total")
        self._misses_ctr = REGISTRY.counter("sim_cache_misses_total")

    @staticmethod
    def key(engine: "Engine", mod: SimModule,
            window: Optional[Tuple[int, int]]) -> tuple:
        return ((id(mod), window), engine.hw,
                SimulationCache.knobs_part(engine),
                SimulationCache.faults_part(engine))

    @staticmethod
    def knobs_part(engine: "Engine") -> tuple:
        """Schedule-shaping engine knobs (everything but hw and faults)."""
        return (engine.overlap, engine.num_compute_streams,
                engine.memory_model, engine.topology_model)

    @staticmethod
    def faults_part(engine: "Engine") -> tuple:
        """Faults-layer inputs that change pricing: the degraded-fabric
        broken-link set and the opaque ``faults_key`` (e.g. a checkpoint
        spec) — previously MISSING from the key, which aliased reports
        across fault scenarios."""
        broken = engine.broken_links
        return (tuple(sorted(broken)) if broken else None, engine.faults_key)

    @staticmethod
    def tape_family(engine: "Engine", mod: SimModule) -> tuple:
        """Tape-sharing granularity: window and faults excluded (a tape is
        window-independent; a faults-only change is repriceable)."""
        return (id(mod), engine.hw, SimulationCache.knobs_part(engine))

    def lookup_tape(self, family: tuple) -> Optional[tuple]:
        """``(faults_part, tape)`` recorded for this family, if any."""
        return self._tapes.get(family)

    def store_tape(self, family: tuple, faults_part: tuple,
                   tape: Any) -> None:
        self._tapes[family] = (faults_part, tape)

    def lookup(self, key: tuple) -> Optional[SimReport]:
        rep = self._reports.get(key)
        if rep is not None:
            self.hits += 1
            self._hits_ctr.inc()
        return rep

    def store(self, key: tuple, mod: SimModule, report: SimReport) -> None:
        self.misses += 1
        self._misses_ctr.inc()
        self._modules[id(mod)] = mod
        self._reports[key] = report

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def __len__(self) -> int:
        return len(self._reports)


class Engine:
    """Dataflow list scheduler over per-unit resources.

    ``overlap_collectives=False`` makes every collective a barrier across
    ALL compute streams (fully serial, the paper's no-async baseline);
    ``num_compute_streams`` sets dispatch concurrency for compute ops
    (1 = serial TensorCore); ``memory_model=False`` falls back to the
    pre-memory-subsystem flat ``hbm`` clock (no placements, no per-channel
    contention, no VMEM spills) — the baseline the camping benchmark
    measures dilation against; ``topology_model=False`` likewise falls back
    to the flat analytic ``ici`` clock (no per-link contention, no
    topology-lowered collective schedules) — the pre-``repro_torch.topology``
    fabric.  ``cache`` (a :class:`SimulationCache`)
    memoizes whole ``simulate`` calls on identical (module, window, spec)
    inputs — the cluster simulator's per-job cost model shares one across
    the fleet.

    ``scheduler`` selects the simulation core: ``"batched"`` (default)
    records the first walk of each module onto a
    :class:`~repro_torch.core.fastsched.ModuleTape` and replays the tape for
    every later simulation (bit-exact, several times faster — see
    ``docs/ARCHITECTURE.md``); ``"legacy"`` re-walks the module every
    call (the reference implementation the equivalence suite compares
    against).

    ``broken_links`` (undirected node-id pairs) prices collectives on the
    DEGRADED fabric — lowering routes around the failed links.
    ``faults_key`` is an opaque hashable folded into the cache key for any
    other faults-layer input that changes effective cost (e.g. a
    checkpoint spec); both live in the key's faults part, so fault
    scenarios never alias each other's cached reports.
    """

    def __init__(self, hw: HardwareSpec = V5E, overlap_collectives: bool = True,
                 num_compute_streams: int = 1, memory_model: bool = True,
                 cache: Optional[SimulationCache] = None,
                 topology_model: bool = True, scheduler: str = "batched",
                 broken_links: Optional[Any] = None,
                 faults_key: Optional[Any] = None):
        if num_compute_streams < 1:
            raise ValueError(
                f"num_compute_streams must be >= 1, got {num_compute_streams}")
        if scheduler not in ("batched", "legacy"):
            raise KeyError(f"unknown scheduler {scheduler!r} "
                           "(expected 'batched' or 'legacy')")
        self.hw = hw
        self.overlap = overlap_collectives
        self.num_compute_streams = num_compute_streams
        self.memory_model = memory_model
        self.topology_model = topology_model
        self.scheduler = scheduler
        self.broken_links = frozenset(broken_links) if broken_links else None
        self.faults_key = faults_key
        self.cache = cache
        # one FabricModel per engine (hw is fixed), so its collective-
        # lowering memo survives across simulate() calls — and a malformed
        # hw.ici_topology spec fails HERE, before any capture work
        from repro_torch.topology import FabricModel
        self.fabric = FabricModel(hw, broken=self.broken_links) \
            if topology_model else None
        #: per-engine replay tapes keyed by module identity (modules pinned
        #: alongside so ids cannot be recycled while a tape references one)
        self._tapes: Dict[int, Any] = {}
        self._tape_mods: Dict[int, SimModule] = {}

    # ------------------------------------------------------------------
    def simulate(self, mod: SimModule, window: Optional[Tuple[int, int]] = None
                 ) -> SimReport:
        """window=(start_idx, end_idx): detailed-simulate only ops in the
        window (by flat index over the entry walk), fast-forwarding the rest
        analytically — the op-level analogue of the paper's CTA checkpoint.
        Fast-forwarded ops flow through the same scheduler (they advance the
        same resource clocks and are fully accounted), they just carry no
        timeline entry.

        Dispatch order (cheapest first): cached report -> tape replay
        (this engine has, or can borrow/reprice, a recorded tape for the
        module) -> full recording walk.  The ``"legacy"`` scheduler always
        takes the full walk."""
        if mod.entry is None:
            raise ValueError("module has no entry computation")

        cache = self.cache
        if cache is not None:
            cache_key = SimulationCache.key(self, mod, window)
            cached = cache.lookup(cache_key)
            if cached is not None:
                return cached

        if self.scheduler == "legacy":
            with TRACER.span("engine.walk", module=mod.entry, legacy=True):
                report = self._walk_simulate(mod, window, record=False)[0]
            if cache is not None:
                cache.store(cache_key, mod, report)
            return report

        from repro_torch.core import fastsched
        tape = self._tapes.get(id(mod))
        family = None
        if tape is None and cache is not None:
            # borrow a tape recorded by another engine of the same family;
            # a faults-part mismatch means only the fabric state differs,
            # which the ici delta tier reprices without re-walking
            family = SimulationCache.tape_family(self, mod)
            donor = cache.lookup_tape(family)
            if donor is not None:
                donor_faults, donor_tape = donor
                if donor_faults == SimulationCache.faults_part(self):
                    tape = donor_tape
                else:
                    tape = fastsched.reprice_ici(donor_tape, mod, self.hw,
                                                 self.fabric)
                if tape is not None:
                    self._tapes[id(mod)] = tape
                    self._tape_mods[id(mod)] = mod
        if tape is not None:
            with TRACER.span("fastsched.replay", module=mod.entry):
                report = fastsched.replay(tape, self, window)
        else:
            with TRACER.span("engine.record", module=mod.entry):
                report, tape = self._walk_simulate(mod, window, record=True)
            self._tapes[id(mod)] = tape
            self._tape_mods[id(mod)] = mod
            if cache is not None:
                if family is None:
                    family = SimulationCache.tape_family(self, mod)
                cache.store_tape(family, SimulationCache.faults_part(self),
                                 tape)
        if cache is not None:
            cache.store(cache_key, mod, report)
        return report

    def tape_for(self, mod: SimModule) -> Optional[Any]:
        """The replay tape for ``mod``, recording one if this engine has
        none yet.  Returns ``None`` under the legacy scheduler (it never
        records).  The tape is the counterfactual surface for
        :mod:`repro_torch.obs.whatif`: its EXEC steps carry every pricing input,
        so a patched copy replays into an idealized report without
        re-walking the module."""
        if self.scheduler == "legacy":
            return None
        tape = self._tapes.get(id(mod))
        if tape is None:
            if mod.entry is None:
                raise ValueError("module has no entry computation")
            with TRACER.span("engine.record", module=mod.entry):
                _report, tape = self._walk_simulate(mod, None, record=True)
            self._tapes[id(mod)] = tape
            self._tape_mods[id(mod)] = mod
        return tape

    def _walk_simulate(self, mod: SimModule,
                       window: Optional[Tuple[int, int]],
                       record: bool) -> Tuple[SimReport, Optional[Any]]:
        """The reference dataflow walk (the pre-refactor ``simulate`` body).

        With ``record=True`` the walk additionally freezes its structure
        and pricing decisions onto a :class:`~repro_torch.core.fastsched.
        ModuleTape` (returned as the second element) so later simulations
        replay instead of re-walking; the recording hooks never influence
        the walk's own arithmetic."""
        from repro_torch.memory import MemoryModel
        mem = MemoryModel(mod, self.hw) if self.memory_model else None
        fabric = self.fabric
        rec = None
        if record:
            from repro_torch.core.fastsched import (
                CALL, EXEC, SKIP, WHILE, ModuleTape, TapeRecorder,
            )
            rec = TapeRecorder()

        timeline: List[TimelineEntry] = []
        unit_seconds: Dict[str, float] = {}
        link_busy: Dict[str, float] = {}
        tot = {"flops": 0.0, "hbm": 0.0, "ici": 0.0, "spill": 0.0}
        unit_free: Dict[str, float] = {u: 0.0 for u in RESOURCES}
        unit_last: Dict[str, Optional[str]] = {u: None for u in RESOURCES}
        if mem is not None:
            # per-channel HBM clocks: hbm-unit ops claim exactly the
            # channels their byte split touches, so camped ops contend on
            # their subset while disjoint subsets overlap.  Keyed inside
            # unit_free so while-loop snapshot/push-forward covers them.
            for c in range(self.hw.hbm_channels):
                unit_free[f"hbm:{c}"] = 0.0
                unit_last[f"hbm:{c}"] = None
        streams: List[float] = [0.0] * self.num_compute_streams
        stream_last: List[Optional[str]] = [None] * self.num_compute_streams
        #: (comp name, op name) -> (value-ready time, binding crit node)
        ready: Dict[Tuple[str, str], Tuple[float, Optional[str]]] = {}
        nodes: Dict[str, _Node] = {}
        state = {"idx": 0, "ff_overhead": 0.0, "ninv": 0,
                 "makespan": 0.0, "makespan_node": None}
        #: (start, wall span, unit) of fast-forwarded ops: no timeline entry,
        #: but the exposure sweep still needs their occupancy
        ff_spans: List[Tuple[float, float, str]] = []

        def bump_makespan(t: float, node: Optional[str]):
            if t > state["makespan"]:
                state["makespan"] = t
                state["makespan_node"] = node

        def dep_ready(comp_name: str, op: SimOp, t_base: float,
                      base_pred: Optional[str]) -> Tuple[float, Optional[str]]:
            """Latest operand-ready time and the crit node that binds it."""
            t, pred = t_base, base_pred
            for name in op.operands:
                r = ready.get((comp_name, name))
                if r is not None and r[0] > t:
                    t, pred = r
            return t, pred

        def schedule(node_id: str, unit: str, seconds: float, scale: float,
                     dep_t: float, dep_pred: Optional[str], use_stream: bool,
                     barrier: bool = False,
                     channels: Optional[List[int]] = None,
                     links: Optional[List[str]] = None) -> Tuple[float, float]:
            """ASAP list-scheduling: start at max(operand-ready, unit-free
            [, stream-free]); claim the unit (and stream) until finish.

            ``channels`` (memory model, hbm-unit ops): contend on — and
            claim — the per-channel HBM clocks the op's byte split touches
            instead of one flat ``hbm`` clock, so two camped transfers on
            disjoint channel subsets may overlap while an evenly striped op
            still serializes against everything.

            ``links`` (topology model, ici-unit ops): the same split for the
            fabric — the collective contends on and claims exactly the
            per-link ``"ici:<src>-<dst>"`` clocks its lowered schedule
            touches, so collectives on disjoint links (different mesh axes)
            overlap while shared-link collectives serialize.  Link clocks
            are created lazily: which links exist depends on the collectives
            the module actually issues.

            ``barrier=True`` (non-overlapped collectives): wait for EVERY
            stream and hold them all until finish — with multiple streams a
            collective must not run beside compute on another stream, or
            ``overlap_collectives=False`` would be silently ignored."""
            cands = [(dep_t, dep_pred)]
            if channels:
                cands += [(unit_free[f"hbm:{c}"], unit_last[f"hbm:{c}"])
                          for c in channels]
            elif links:
                cands += [(unit_free.setdefault(l, 0.0),
                           unit_last.setdefault(l, None)) for l in links]
            else:
                cands.append((unit_free[unit], unit_last[unit]))
            si = None
            if barrier:
                bi = max(range(len(streams)), key=streams.__getitem__)
                cands.append((streams[bi], stream_last[bi]))
            elif use_stream:
                si = min(range(len(streams)), key=streams.__getitem__)
                cands.append((streams[si], stream_last[si]))
            start, pred = max(cands, key=lambda c: c[0])
            finish = start + seconds
            if channels:
                for c in channels:
                    unit_free[f"hbm:{c}"] = finish
                    unit_last[f"hbm:{c}"] = node_id
            elif links:
                for l in links:
                    unit_free[l] = finish
                    unit_last[l] = node_id
            else:
                unit_free[unit] = finish
                unit_last[unit] = node_id
            if barrier:
                for i in range(len(streams)):
                    streams[i] = finish
                    stream_last[i] = node_id
            elif si is not None:
                streams[si] = finish
                stream_last[si] = node_id
            nodes[node_id] = _Node(unit, seconds * scale, finish, pred)
            bump_makespan(finish, node_id)
            return start, finish

        def run_comp(comp_name: str, scale: float, t_base: float,
                     base_pred: Optional[str]) -> Tuple[float, Optional[str]]:
            """Schedule one computation; returns when its ROOT value is ready
            (a trailing collective's result included — callers must not
            proceed before it)."""
            comp = mod.computations[comp_name]
            # invocation serial: a computation invoked twice (two call sites)
            # must not overwrite the first invocation's crit-path nodes
            inv = state["ninv"]
            state["ninv"] += 1
            # recording: operand slots are bound BEFORE this op publishes its
            # own ready value, and every publish allocates a fresh slot, so
            # replay resolves re-invoked computations to the same values the
            # dict lookups saw here
            steps = [] if rec is not None else None
            last_slots = [] if rec is not None else None
            last: Tuple[float, Optional[str]] = (t_base, base_pred)
            for op in comp.ops:
                key = (comp_name, op.name)
                if mem is not None:
                    # linear-scan allocator step (aliases included, so the
                    # per-invocation live ranges line up with program order)
                    mem.visit(inv, comp, op)
                if rec is not None:
                    deps = rec.deps(comp_name, op.operands)
                if op.opcode in SKIP_OPS:
                    # zero-cost dataflow plumbing: propagate readiness
                    ready[key] = dep_ready(comp_name, op, t_base, base_pred)
                    if rec is not None:
                        steps.append((SKIP, rec.slot(key), deps))
                    continue
                if op.opcode == "while":
                    ready[key] = run_while(comp_name, op, scale, t_base,
                                           base_pred)
                    if mem is not None:
                        mem.after_subcomputation(inv, op)
                    if rec is not None:
                        out = rec.slot(key)
                        pw = rec.pending_while
                        if pw is None:     # body-less while degenerates to
                            steps.append((SKIP, out, deps))  # dep propagation
                        else:
                            steps.append((WHILE, out, deps) + pw)
                        last_slots.append(out)
                    last = max(last, ready[key], key=lambda r: r[0])
                    continue
                if op.opcode == "call":
                    c = _TO_APPLY_RE.search(op.raw) or _CALLS_RE.search(op.raw)
                    if c and c.group(1) in mod.computations:
                        d, dpred = dep_ready(comp_name, op, t_base, base_pred)
                        ready[key] = run_comp(c.group(1), scale, d, dpred)
                        if mem is not None:
                            mem.after_subcomputation(inv, op)
                        if rec is not None:
                            out = rec.slot(key)
                            steps.append((CALL, out, deps) + rec.last_frame)
                            last_slots.append(out)
                        last = max(last, ready[key], key=lambda r: r[0])
                        continue
                state["idx"] += 1
                ot = op_time(mod, comp, op, self.hw, fabric=fabric)
                mo = mem.time_op(inv, comp, op, ot) if mem is not None \
                    else None
                chans = None
                if mo is not None:
                    ot = mo.ot
                    if ot.unit == "hbm":
                        chans = mo.channels
                links = sorted(ot.link_seconds) if ot.unit == "ici" \
                    and ot.link_seconds else None
                d, dpred = dep_ready(comp_name, op, t_base, base_pred)
                node_id = f"{inv}:{comp_name}/{op.name}"
                on_ici = ot.unit == "ici"
                use_stream = not on_ici
                barrier = on_ici and not self.overlap
                start, _ = schedule(node_id, ot.unit, ot.seconds, scale,
                                    d, dpred, use_stream, barrier,
                                    channels=chans, links=links)
                if window and not (window[0] <= state["idx"] < window[1]):
                    # fast-forward: same clocks advanced, no timeline entry
                    state["ff_overhead"] += ot.overhead_s * scale
                    ff_spans.append((start, ot.seconds * scale, ot.unit))
                else:
                    timeline.append(TimelineEntry(
                        op.name, op.opcode, ot.unit, start, ot.seconds, scale,
                        ot.flops, ot.hbm_bytes, ot.ici_bytes, comp_name,
                        overhead_s=ot.overhead_s,
                        channel_bytes=mo.channel_bytes if mo else None,
                        spill_bytes=float(mo.spill_bytes) if mo else 0.0,
                        link_bytes=ot.link_bytes,
                        link_seconds=ot.link_seconds))
                self._account(ot, scale, tot, unit_seconds, link_busy)
                if mo is not None:
                    mem.account(mo, scale)
                    tot["spill"] += mo.spill_bytes * scale
                    # unresolved call ops fall through to here: perform any
                    # release their visit deferred (no-op for other ops)
                    mem.after_subcomputation(inv, op)
                ready[key] = (nodes[node_id].finish, node_id)
                if rec is not None:
                    out = rec.slot(key)
                    steps.append((EXEC, out, deps, state["idx"], node_id, ot,
                                  scale, chans, links,
                                  mo.channel_bytes if mo else None,
                                  float(mo.spill_bytes) if mo else 0.0,
                                  comp_name, op))
                    last_slots.append(out)
                last = max(last, ready[key], key=lambda r: r[0])
            if mem is not None:
                mem.close_invocation(inv)
            if comp.root is not None and (comp_name, comp.root) in ready:
                if rec is not None:
                    rec.last_frame = (steps,
                                      rec.slot_of[(comp_name, comp.root)],
                                      last_slots)
                return ready[(comp_name, comp.root)]
            if rec is not None:
                rec.last_frame = (steps, None, last_slots)
            return last

        def run_while(comp_name: str, op: SimOp, scale: float, t_base: float,
                      base_pred: Optional[str]) -> Tuple[float, Optional[str]]:
            """One detailed iteration, then scale: resources the body used
            are pushed FORWARD by (trip-1) iterations — never backward (a
            later collective can never schedule in the past).

            Loop entry is a scheduling BARRIER: the body starts once its
            operands AND every resource are available, so the pre-loop
            busy-wait is paid exactly once (not repaid per trip) and no body
            work is ever dropped from the per-iteration cost — ``iter_time``
            measures a clean-slate iteration."""
            d, dpred = dep_ready(comp_name, op, t_base, base_pred)
            trip = mod.trip_count(op)
            b = _BODY_RE.search(op.raw)
            if not (b and b.group(1) in mod.computations):
                if rec is not None:
                    rec.pending_while = None
                return d, dpred
            t0, pred0 = max(
                [(d, dpred)]
                + [(unit_free[u], unit_last[u]) for u in unit_free]
                + [(streams[i], stream_last[i])
                   for i in range(len(streams))],
                key=lambda c: c[0])
            snap_units = dict(unit_free)
            snap_streams = list(streams)
            t1, rpred = run_comp(b.group(1), scale * trip, t0, pred0)
            if rec is not None:
                rec.pending_while = (trip,) + rec.last_frame
            # iterations serialize on the loop-carried dependence, so the
            # body's resources stay busy for the remaining trips
            # .get(..., 0.0): link clocks are created lazily, so a collective
            # first issued INSIDE the body has no snapshot entry
            t1_res = max([t1]
                         + [t for u, t in unit_free.items()
                            if t > snap_units.get(u, 0.0)]
                         + [t for i, t in enumerate(streams)
                            if t > snap_streams[i]])
            iter_time = max(t1_res - t0, 0.0)
            extra = iter_time * (trip - 1)
            for u in unit_free:
                if unit_free[u] > snap_units.get(u, 0.0):
                    unit_free[u] += extra
            for i in range(len(streams)):
                if streams[i] > snap_streams[i]:
                    streams[i] += extra
            t_end = t1_res + extra
            bump_makespan(t_end, rpred)
            return t_end, rpred

        root_t, _root_pred = run_comp(mod.entry, 1.0, 0.0, None)
        bump_makespan(root_t, _root_pred)
        total = state["makespan"]

        # busy totals come from the same accounting as unit_seconds so they
        # include fast-forwarded ops — windowed and full runs agree
        compute_seconds = sum(v for u, v in unit_seconds.items()
                              if u != "ici")
        ici_seconds = unit_seconds.get("ici", 0.0)
        exposed = self._exposure(timeline, ff_spans)
        critical_path = self._critical_path(nodes, state["makespan_node"])
        memmap = mem.finish() if mem is not None else None
        report = SimReport(
            total_seconds=total,
            compute_seconds=compute_seconds,
            ici_seconds=ici_seconds,
            exposed_ici_seconds=exposed.get("ici", 0.0),
            unit_seconds=unit_seconds,
            total_flops=tot["flops"],
            total_hbm_bytes=tot["hbm"],
            total_ici_bytes=tot["ici"],
            timeline=timeline,
            hw=self.hw,
            exposed_seconds=exposed,
            critical_path_seconds=critical_path,
            ff_overhead_seconds=state["ff_overhead"],
            peak_hbm_bytes=float(memmap.peak_live_bytes) if memmap else 0.0,
            spill_bytes=tot["spill"],
            channel_busy_seconds=list(mem.channel_busy) if mem else [],
            memory=memmap,
            link_busy_seconds=link_busy,
        )
        tape = None
        if rec is not None:
            entry_steps, entry_root, entry_lasts = rec.last_frame
            tape = ModuleTape(
                entry_steps, entry_root, entry_lasts, rec.n,
                has_mem=mem is not None,
                mem_peak=float(memmap.peak_live_bytes) if memmap else 0.0,
                mem_channel_busy=list(mem.channel_busy) if mem else (),
                memmap=memmap)
        return report, tape

    # ------------------------------------------------------------------
    @staticmethod
    def _exposure(timeline: List[TimelineEntry],
                  ff_spans: Tuple = ()) -> Dict[str, float]:
        """Per-unit seconds during which ONLY that unit was active.

        A coordinate sweep over the scheduled spans — timeline entries plus
        the fast-forwarded ``(start, span, unit)`` spans of a windowed run,
        so exposure agrees between windowed and full runs.  Each single-unit
        segment is also attributed back to the covering *entries'*
        ``exposed_s`` (split evenly when trip-scaled spans overlap), so the
        per-op figure is exact on the overlapped timeline.
        """
        spans: List[Tuple[float, float, str, Optional[TimelineEntry]]] = [
            (e.start, e.duration * e.scale, e.unit, e) for e in timeline]
        spans += [(s, w, u, None) for (s, w, u) in ff_spans]
        events: List[Tuple[float, int, int]] = []
        for i, (s, w, _u, _e) in enumerate(spans):
            if w <= 0:
                continue
            events.append((s, 1, i))
            events.append((s + w, 0, i))
        # process ends before starts at equal times so back-to-back ops on
        # different units don't create a fake multi-unit instant
        events.sort(key=lambda ev: (ev[0], ev[1]))
        exposed: Dict[str, float] = {}
        active: Dict[int, None] = {}
        prev_t = 0.0
        for t, kind, i in events:
            if active and t > prev_t:
                units = {spans[j][2] for j in active}
                if len(units) == 1:
                    seg = t - prev_t
                    u = next(iter(units))
                    exposed[u] = exposed.get(u, 0.0) + seg
                    # the per-op split goes only to spans that HAVE an entry
                    # (fast-forwarded spans count toward the aggregate but
                    # carry no op to attribute to)
                    recipients = [spans[j][3] for j in active
                                  if spans[j][3] is not None]
                    if recipients:
                        share = seg / len(recipients)
                        for e in recipients:
                            e.exposed_s += share
            if kind == 1:
                active[i] = None
            else:
                active.pop(i, None)
            prev_t = t
        return exposed

    @staticmethod
    def _critical_path(nodes: Dict[str, _Node], end_node: Optional[str]
                       ) -> Dict[str, float]:
        """Walk the binding-constraint chain back from the makespan,
        attributing each node's wall-clock contribution to its unit."""
        cp: Dict[str, float] = {}
        seen = set()
        cur = end_node
        while cur is not None and cur not in seen:
            seen.add(cur)
            n = nodes.get(cur)
            if n is None:
                break
            cp[n.unit] = cp.get(n.unit, 0.0) + n.seconds
            cur = n.pred
        return cp

    @staticmethod
    def _account(ot: OpTime, scale: float, tot: Dict[str, float],
                 unit_seconds: Dict[str, float],
                 link_busy: Optional[Dict[str, float]] = None):
        tot["flops"] += ot.flops * scale
        tot["hbm"] += ot.hbm_bytes * scale
        tot["ici"] += ot.ici_bytes * scale
        unit_seconds[ot.unit] = unit_seconds.get(ot.unit, 0.0) + ot.seconds * scale
        if link_busy is not None and ot.link_seconds:
            for l, s in ot.link_seconds.items():
                link_busy[l] = link_busy.get(l, 0.0) + s * scale
