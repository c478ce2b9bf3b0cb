"""Jobs, job classes and arrival traces for the fleet simulator.

The cluster layer's unit of work is a :class:`Job`: "tenant X submits a
``llama3-8b`` training run of N steps at time T".  What one step of that job
costs on a given chip is *not* stored here — it comes from simulating the
class's captured :class:`~repro_torch.core.hlo_ir.SimModule` through the device
Engine (:mod:`repro_torch.cluster.devices`), so the cluster numbers inherit the
paper's per-op fidelity instead of trusting trace-recorded durations.

Three synthetic generators cover the regimes the MLaaS literature cares
about (Weng et al., "MLaaS in the Wild"): memoryless :func:`poisson_trace`,
:func:`bursty_trace` (compound arrivals — whole batches of jobs land
together, the head-of-line-blocking stressor), and
:func:`multislice_trace` (multi-device gang jobs over
:data:`MULTISLICE_CLASSES`, the topology-placement stressor).  All draw job classes from a
weighted catalog and job lengths log-uniformly, so traces are heavy-tailed:
many short jobs, a few very long ones.  Generators split their RNG into an
arrival stream and a job-mix stream, so sweeping the arrival *rate* at a
fixed seed replays the identical job population on a compressed clock —
latency-vs-load curves measure queueing, not a reshuffled workload.

Traces round-trip through JSON (:meth:`Trace.save` / :meth:`Trace.load`)
bit-exactly, so a generated or externally converted trace is a reproducible
experiment input.
"""
from __future__ import annotations

import json
import random
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class JobClass:
    """One entry of the job-class catalog.

    ``arch`` names a registered architecture (``repro_torch.configs``) whose smoke
    config the capture-backed cost model lowers; ``seq_len``/``global_batch``
    shape that step.  ``steps_lo``/``steps_hi`` bound the log-uniform
    per-job step count (the heavy tail), ``weight`` the class's share of the
    arrival mix, and ``cost_scale`` sizes the capture-free synthetic cost
    model (:func:`repro_torch.cluster.devices.synthetic_modules`).

    ``num_devices`` is the class's gang footprint: every job of the class
    occupies that many device slots simultaneously (a multi-device "slice"
    job).  The topology-aware ``locality`` policy places such jobs on
    minimal-diameter sub-slices of the fleet's interconnect graph.
    """

    name: str
    arch: str
    seq_len: int = 64
    global_batch: int = 4
    steps_lo: int = 10
    steps_hi: int = 100
    weight: float = 1.0
    cost_scale: float = 1.0
    num_devices: int = 1


#: default multi-tenant mix: mostly small jobs, a medium LLM class, and a
#: rare-but-huge MoE class — the heavy-tailed shape SJF-vs-FIFO hinges on
DEFAULT_CLASSES: Tuple[JobClass, ...] = (
    JobClass("lenet", "lenet", seq_len=32, global_batch=8,
             steps_lo=20, steps_hi=400, weight=0.6, cost_scale=1.0),
    JobClass("llama3-8b", "llama3-8b", seq_len=64, global_batch=4,
             steps_lo=50, steps_hi=2000, weight=0.3, cost_scale=8.0),
    JobClass("qwen3-moe-30b", "qwen3-moe-30b-a3b", seq_len=64, global_batch=4,
             steps_lo=200, steps_hi=8000, weight=0.1, cost_scale=32.0),
)

#: multi-device ("slice") mix for topology-aware placement studies: the big
#: classes gang-occupy 2/4 devices, so the locality policy's
#: minimal-diameter sub-slice selection actually matters
MULTISLICE_CLASSES: Tuple[JobClass, ...] = (
    JobClass("lenet", "lenet", seq_len=32, global_batch=8,
             steps_lo=20, steps_hi=400, weight=0.5, cost_scale=1.0),
    JobClass("llama3-8b-x2", "llama3-8b", seq_len=64, global_batch=4,
             steps_lo=50, steps_hi=2000, weight=0.3, cost_scale=8.0,
             num_devices=2),
    JobClass("qwen3-moe-30b-x4", "qwen3-moe-30b-a3b", seq_len=64,
             global_batch=4, steps_lo=200, steps_hi=8000, weight=0.2,
             cost_scale=32.0, num_devices=4),
)

#: tenant pool for the multi-tenant tag (round-robin-free random draw)
_TENANTS = ("tenant-0", "tenant-1", "tenant-2", "tenant-3")


@dataclass(frozen=True)
class Job:
    """One submitted run: a class instance with an arrival time and length."""

    job_id: str
    job_class: str        # JobClass.name
    arrival_s: float      # submission time on the cluster's virtual clock
    num_steps: int        # training steps this job runs
    user: str = "anon"    # owning tenant
    num_devices: int = 1  # gang footprint: device slots held simultaneously


@dataclass
class Trace:
    """An arrival trace: jobs (sorted by arrival) + the class catalog."""

    name: str
    jobs: List[Job]
    classes: Tuple[JobClass, ...] = DEFAULT_CLASSES
    meta: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self):
        self.jobs = sorted(self.jobs, key=lambda j: (j.arrival_s, j.job_id))

    def job_class(self, name: str) -> JobClass:
        for c in self.classes:
            if c.name == name:
                return c
        raise KeyError(f"unknown job class {name!r}; "
                       f"catalog: {[c.name for c in self.classes]}")

    # -- JSON round-trip ----------------------------------------------------
    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps({
            "name": self.name,
            "meta": self.meta,
            "classes": [asdict(c) for c in self.classes],
            "jobs": [asdict(j) for j in self.jobs],
        }, indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "Trace":
        doc = json.loads(text)
        return cls(name=doc["name"],
                   jobs=[Job(**j) for j in doc["jobs"]],
                   classes=tuple(JobClass(**c) for c in doc["classes"]),
                   meta=dict(doc.get("meta", {})))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=2))

    @staticmethod
    def load(path: str) -> "Trace":
        with open(path) as f:
            return Trace.from_json(f.read())


# ---------------------------------------------------------------------------
# synthetic generators
# ---------------------------------------------------------------------------

def _draw_jobs(n_jobs: int, classes: Sequence[JobClass], seed: int
               ) -> List[Tuple[JobClass, int, str]]:
    """The job population (class, steps, tenant) — arrival-independent, so
    the same seed yields the same population at every arrival rate.

    Determinism contract (regression-tested in ``tests/test_cluster.py``):
    EVERY per-job attribute — class, step count, tenant, and the class's
    gang footprint (``num_devices``) — must derive from THIS population
    stream, never from the generators' arrival RNG.  An attribute drawn
    from the arrival stream would silently reshuffle the job population
    whenever the arrival *rate* is rescaled (the arrival RNG's draw
    sequence is rate-dependent in general), so latency-vs-load sweeps
    would compare different workloads instead of different loads.
    """
    rng = random.Random(seed + 1)
    weights = [c.weight for c in classes]
    out = []
    for _ in range(n_jobs):
        c = rng.choices(list(classes), weights=weights)[0]
        # log-uniform step count: the heavy tail
        lo, hi = max(c.steps_lo, 1), max(c.steps_hi, c.steps_lo, 1)
        steps = round(lo * (hi / lo) ** rng.random())
        out.append((c, steps, rng.choice(_TENANTS)))
    return out


def poisson_trace(n_jobs: int = 40, rate_jobs_per_s: float = 1.0,
                  classes: Sequence[JobClass] = DEFAULT_CLASSES,
                  seed: int = 0, name: str = "poisson") -> Trace:
    """Memoryless arrivals: exponential inter-arrival times at ``rate``."""
    rng = random.Random(seed)
    population = _draw_jobs(n_jobs, classes, seed)
    t, jobs = 0.0, []
    for i, (c, steps, user) in enumerate(population):
        t += rng.expovariate(rate_jobs_per_s)
        jobs.append(Job(f"job-{i:04d}", c.name, t, steps, user,
                        num_devices=c.num_devices))
    return Trace(name, jobs, tuple(classes),
                 meta={"rate_jobs_per_s": rate_jobs_per_s, "seed": seed})


def bursty_trace(n_jobs: int = 40, rate_jobs_per_s: float = 1.0,
                 burst_size: int = 5, burst_jitter_s: float = 0.05,
                 classes: Sequence[JobClass] = DEFAULT_CLASSES,
                 seed: int = 0, name: str = "bursty") -> Trace:
    """Compound-Poisson arrivals: bursts of ~``burst_size`` jobs land within
    ``burst_jitter_s`` of each epoch; epochs arrive at ``rate/burst_size``
    so the long-run job rate matches :func:`poisson_trace` at equal args."""
    rng = random.Random(seed)
    population = _draw_jobs(n_jobs, classes, seed)
    jobs: List[Job] = []
    t, i = 0.0, 0
    while i < n_jobs:
        t += rng.expovariate(rate_jobs_per_s / max(burst_size, 1))
        for _ in range(min(burst_size, n_jobs - i)):
            c, steps, user = population[i]
            jobs.append(Job(f"job-{i:04d}", c.name,
                            t + rng.random() * burst_jitter_s, steps, user,
                            num_devices=c.num_devices))
            i += 1
    return Trace(name, jobs, tuple(classes),
                 meta={"rate_jobs_per_s": rate_jobs_per_s, "seed": seed,
                       "burst_size": burst_size})


def multislice_trace(n_jobs: int = 40, rate_jobs_per_s: float = 1.0,
                     classes: Sequence[JobClass] = MULTISLICE_CLASSES,
                     seed: int = 0, name: str = "multislice") -> Trace:
    """Poisson arrivals over the multi-device class mix: jobs gang-occupy
    1/2/4 device slots, the workload the topology-aware ``locality`` policy
    (minimal-diameter sub-slice placement) is built for."""
    return poisson_trace(n_jobs, rate_jobs_per_s, classes, seed, name)


#: spec name -> generator for ``--trace synthetic:<name>``
GENERATORS = {"poisson": poisson_trace, "bursty": bursty_trace,
              "multislice": multislice_trace}


def synthetic_trace(spec: str, **kw) -> Trace:
    """Resolve ``synthetic:poisson`` / ``synthetic:bursty`` (or a bare
    generator name) to a generated :class:`Trace`; kwargs pass through."""
    kind = spec.split(":", 1)[1] if ":" in spec else spec
    if kind not in GENERATORS:
        # the validate layer contributes trace-refit generators
        # (``alibaba-like``) by registering into GENERATORS on import;
        # lazy-load it on first miss so the cluster package keeps no
        # static dependency on repro_torch.validate
        try:
            import repro_torch.validate.ingest  # noqa: F401  (self-registers)
        except ImportError:
            pass
    if kind not in GENERATORS:
        raise KeyError(f"unknown synthetic trace {spec!r}; "
                       f"known: {sorted(GENERATORS)}")
    return GENERATORS[kind](name=kind, **kw)
