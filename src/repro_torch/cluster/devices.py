"""Device fleet + Engine-backed job cost models.

A *device slot* is one simulated chip a job occupies exclusively while it
runs; a :class:`Fleet` is a (possibly heterogeneous) set of slots built from
a spec string like ``"4"``, ``"4xtpu-v5p"`` or ``"2xtpu-v5e+2xtpu-v5p"``.

What a job costs on a slot is answered by a :class:`CostModel`: it maps the
job's class to a :class:`~repro_torch.core.hlo_ir.SimModule` and runs it through
a per-spec :class:`~repro_torch.core.engine.Engine` — so a job's service time is
``num_steps * SimReport.total_seconds`` *on that slot's chip* (a v5p slot
genuinely finishes sooner than a v5e slot), and its footprint for
placement decisions is the allocator's ``SimReport.peak_hbm_bytes``.
Every engine shares one :class:`~repro_torch.core.engine.SimulationCache`, so a
trace that submits the same class thousands of times pays for one detailed
simulation per (class, chip) and the cluster loop stays O(events); the
cache's hit rate is surfaced in the :class:`~repro_torch.cluster.events.ClusterReport`.

Three module suppliers:

* :func:`captured_modules` — lazily capture each class's smoke train
  step (``repro_torch.configs`` + ``runtime.steps.train_bundle``, traced on
  fake tensors on a device, default cuda) and parse the emitted HLO text:
  full-fidelity;
* :func:`synthetic_modules` — hand-built HLO chains sized by
  ``JobClass.cost_scale``: capture-free and fast, for benchmarks/tests;
* :class:`TableCostModel` — bypass modules entirely with fixed per-step
  costs, for hand-verifiable scheduling tests.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from repro_torch.cluster.workload import Job, Trace
from repro_torch.core.engine import Engine, SimReport, SimulationCache
from repro_torch.core.hlo_ir import SimModule, parse_hlo_module
from repro_torch.core.hw import CHIPS, V5E, HardwareSpec
from repro_torch.topology import Topology


@dataclass
class DeviceSlot:
    """One simulated chip of the fleet (exclusively occupied while busy)."""

    device_id: str
    hw: HardwareSpec = V5E
    free_at: float = 0.0          # virtual time this slot next goes idle
    busy_seconds: float = 0.0     # job service time executed here
    setup_seconds: float = 0.0    # cold-start overhead paid here
    jobs_done: int = 0
    last_class: Optional[str] = None   # for locality/warm-start policies


class Fleet:
    """An ordered set of device slots, optionally arranged on a topology.

    ``topology`` (a :class:`repro_torch.topology.Topology` whose node *positions*
    map 1:1 onto slot indices) gives the fleet an interconnect shape: the
    ``locality`` policy then places multi-device gang jobs on
    minimal-diameter sub-slices of it.  A fleet without a topology behaves
    exactly as before (placement ignores distance).
    """

    def __init__(self, slots: List[DeviceSlot],
                 topology: Optional[Topology] = None):
        if not slots:
            raise ValueError("fleet needs at least one device slot")
        if topology is not None and topology.num_devices != len(slots):
            raise ValueError(
                f"topology {topology.name} has {topology.num_devices} nodes "
                f"but the fleet has {len(slots)} slots")
        self.slots = slots
        self.topology = topology
        # undirected id pairs of currently-failed fabric links, maintained
        # by the cluster loop; topology-aware policies prefer sub-slices
        # whose internal links avoid them
        self.broken_links: set = set()

    def __len__(self) -> int:
        return len(self.slots)

    def __iter__(self):
        return iter(self.slots)

    def free(self, now: float) -> List[DeviceSlot]:
        return [d for d in self.slots if d.free_at <= now]

    def max_hbm_bytes(self) -> int:
        return max(d.hw.hbm_bytes for d in self.slots)

    @classmethod
    def from_spec(cls, spec: str,
                  topology: Optional[str] = None) -> "Fleet":
        """``"4"`` -> 4x v5e; ``"4xtpu-v5p"``; ``"2xtpu-v5e+2xtpu-v5p"``.

        ``topology`` is an optional fabric spec (``"ring"``,
        ``"torus:4x4"``, ``"fc"``) instantiated over the fleet's slot
        count; a sized spec must match it exactly.
        """
        slots: List[DeviceSlot] = []
        for part in str(spec).split("+"):
            part = part.strip()
            if "x" in part:
                count_s, chip = part.split("x", 1)
                count, chip = int(count_s), chip.strip()
            else:
                count, chip = int(part), "tpu-v5e"
            if chip not in CHIPS:
                raise KeyError(f"unknown chip {chip!r}; known: {sorted(CHIPS)}")
            for _ in range(count):
                slots.append(DeviceSlot(f"dev{len(slots)}:{chip}", CHIPS[chip]))
        topo = Topology.from_spec(topology, n=len(slots)) \
            if topology is not None else None
        return cls(slots, topology=topo)


# ---------------------------------------------------------------------------
# cost models
# ---------------------------------------------------------------------------

class CostModel:
    """job class -> detailed :class:`SimReport` per chip, memoized.

    ``module_fn(job_class)`` supplies the class's SimModule on first use;
    one shared :class:`SimulationCache` memoizes the Engine runs, so the
    cluster loop's thousands of cost queries collapse to one simulation per
    (class, chip spec).
    """

    def __init__(self, module_fn: Callable[[str], SimModule],
                 cache: Optional[SimulationCache] = None, **engine_kw):
        self._module_fn = module_fn
        self._modules: Dict[str, SimModule] = {}
        self._engines: Dict[HardwareSpec, Engine] = {}
        self._engine_kw = engine_kw
        self.cache = cache if cache is not None else SimulationCache()

    def _module(self, job_class: str) -> SimModule:
        if job_class not in self._modules:
            self._modules[job_class] = self._module_fn(job_class)
        return self._modules[job_class]

    def report(self, job_class: str, hw: HardwareSpec) -> SimReport:
        eng = self._engines.get(hw)
        if eng is None:
            eng = Engine(hw, cache=self.cache, **self._engine_kw)
            self._engines[hw] = eng
        return eng.simulate(self._module(job_class))

    def service_seconds(self, job: Job, hw: HardwareSpec) -> float:
        """Modeled run time of the whole job on ``hw`` (steps x makespan)."""
        return job.num_steps * self.report(job.job_class, hw).total_seconds

    def peak_hbm_bytes(self, job_class: str, hw: HardwareSpec) -> float:
        return self.report(job_class, hw).peak_hbm_bytes

    def cache_stats(self) -> Tuple[int, int]:
        return self.cache.hits, self.cache.misses


class TableCostModel(CostModel):
    """Fixed per-step costs — no modules, no engine.

    ``table`` maps class name -> (seconds_per_step, peak_hbm_bytes).  For
    tests that need hand-computable queueing delays, and for replaying
    externally measured traces where only durations are known.
    """

    def __init__(self, table: Mapping[str, Tuple[float, float]]):
        super().__init__(module_fn=lambda _name: None)
        self.table = dict(table)
        self._memo: Dict[Tuple[str, HardwareSpec], SimReport] = {}

    def report(self, job_class: str, hw: HardwareSpec) -> SimReport:
        # the report is pure in (class, chip) and never mutated by callers,
        # so the cluster loop's thousands of cost queries share one object
        got = self._memo.get((job_class, hw))
        if got is None:
            seconds, peak = self.table[job_class]
            got = SimReport(
                total_seconds=seconds, compute_seconds=seconds,
                ici_seconds=0.0, exposed_ici_seconds=0.0,
                unit_seconds={"mxu": seconds}, total_flops=0.0,
                total_hbm_bytes=0.0, total_ici_bytes=0.0,
                timeline=[], hw=hw, peak_hbm_bytes=peak)
            self._memo[(job_class, hw)] = got
        return got


# ---------------------------------------------------------------------------
# module suppliers
# ---------------------------------------------------------------------------

def captured_modules(trace: Trace, seq_len: Optional[int] = None,
                     global_batch: Optional[int] = None, device=None
                     ) -> Callable[[str], SimModule]:
    """Capture each class's smoke train step on first use (lazy, per class).

    The slow path (a trace of the whole step on fake tensors on ``device``,
    default cuda; seconds per class) — but it runs once per class ever,
    thanks to :class:`CostModel`'s memoization.
    """
    from repro_torch.device import resolve_device
    dev = resolve_device(device)

    def build(job_class: str) -> SimModule:
        from repro_torch import config as C
        from repro_torch.core.capture import capture_bundle
        from repro_torch.runtime.steps import train_bundle

        jc = trace.job_class(job_class)
        entry = C.get(jc.arch)
        shape = C.ShapeConfig("cluster", seq_len=seq_len or jc.seq_len,
                              global_batch=global_batch or jc.global_batch,
                              kind="train")
        rc = C.RunConfig(model=entry.smoke, shape=shape, mesh=C.SMOKE_MESH)
        cap = capture_bundle(train_bundle(rc), name=f"{job_class}_train", device=dev)
        return cap.module

    return build


def synthetic_module(n_ops: int, elems: int) -> SimModule:
    """A serial chain of ``n_ops`` elementwise HBM-bound ops on
    ``f32[elems]`` buffers — the capture-free stand-in workload (cost scales
    linearly with both arguments)."""
    lines = [f"ENTRY %main (p0: f32[{elems}]) -> f32[{elems}] {{",
             f"  %p0 = f32[{elems}]{{0}} parameter(0)"]
    prev = "p0"
    for i in range(max(n_ops, 1)):
        root = "ROOT " if i == max(n_ops, 1) - 1 else ""
        lines.append(f"  {root}%a{i} = f32[{elems}]{{0}} "
                     f"add(%{prev}, %{prev})")
        prev = f"a{i}"
    lines.append("}")
    return parse_hlo_module("\n".join(lines))


def synthetic_modules(trace: Trace, base_elems: int = 1 << 18,
                      n_ops: int = 16) -> Callable[[str], SimModule]:
    """Capture-free supplier: chain sized by ``JobClass.cost_scale``."""
    def build(job_class: str) -> SimModule:
        jc = trace.job_class(job_class)
        return synthetic_module(n_ops, int(base_elems * jc.cost_scale))

    return build


def cost_model_for(trace: Trace, backend: str = "capture", device=None,
                   **engine_kw) -> CostModel:
    """The CLI/benchmark entry point: ``capture`` (on ``device``, default
    cuda) or ``synthetic``."""
    if backend == "capture":
        return CostModel(captured_modules(trace, device=device), **engine_kw)
    if backend == "synthetic":
        return CostModel(synthetic_modules(trace), **engine_kw)
    raise KeyError(f"unknown cost backend {backend!r} "
                   "(expected 'capture' or 'synthetic')")
