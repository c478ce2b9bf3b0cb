"""Alibaba cluster-trace-gpu-v2020 ingestion -> :class:`Trace` objects.

The paper trusts GPGPU-Sim because its simulated kernels correlate with
real hardware; the fleet layer earns the same trust by replaying *real*
MLaaS traces.  This module reads the two tables of the Alibaba
cluster-trace-gpu-v2020 release (the schema the MLaaS-performance-modeling
exemplar in SNIPPETS.md is built on):

* ``pai_job_table``  — one row per job: name, user, status, submit/start/
  end timestamps;
* ``pai_task_table`` — one row per task: instance count, per-instance
  ``plan_gpu`` (a *percentage* of one GPU: 50 = half, 800 = eight),
  ``plan_cpu``/``plan_mem`` and the requested ``gpu_type``.

and converts them into the cluster layer's native :class:`Trace`:

* arrival = normalized ``submit_time`` (shifted so the first job lands at
  t=0).  Real tables are NOT sorted by submission and carry clock skew —
  rows are tolerated in any order and :class:`Trace` canonically sorts on
  construction (the regression the shuffled-arrival test pins down);
* gang footprint = ``ceil(sum(inst_num * plan_gpu) / 100)`` device slots
  (tenant tags preserved from ``user``);
* duration = the longest task span, discretized into ``num_steps`` of a
  per-class step price so the heavy-tailed short-job mass survives the
  conversion.  The per-class step prices are recorded in ``Trace.meta``
  (``"step_s:<class>"`` keys) and :func:`table_cost_model` turns them
  into a :class:`~repro_torch.cluster.devices.TableCostModel` — replaying the
  trace reproduces the observed service times instead of re-pricing them
  through a synthetic engine.

:func:`profile_from_trace` refits the ingested trace's distributions
(:mod:`repro_torch.validate.fitting`) into a :class:`WorkloadProfile`, and
:func:`alibaba_like_trace` generates fresh synthetic traces from such a
profile — registered as ``synthetic:alibaba-like`` in the workload
generator catalog (lazy-loaded, so the cluster CLI resolves it without
the validate package on its import path).
"""
from __future__ import annotations

import csv
import math
import os
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.cluster.devices import TableCostModel
from repro_torch.cluster.workload import (GENERATORS, Job, JobClass, Trace,
                                          _draw_jobs)
from repro_torch.validate.fitting import FitResult, best_fit

#: canonical column orders of the two v2020 tables (headerless CSVs use
#: these; a first line mentioning ``job_name`` is detected as a header)
JOB_COLUMNS = ("job_name", "inst_id", "user", "status", "submit_time",
               "start_time", "end_time")
TASK_COLUMNS = ("job_name", "task_name", "inst_num", "status", "start_time",
                "end_time", "plan_cpu", "plan_mem", "plan_gpu", "gpu_type")

#: a class's median-duration job is discretized into this many steps, so
#: short jobs keep >= 1 step and the tail keeps its relative length
STEPS_AT_MEDIAN = 100

#: nominal per-device state footprint when the table carries no usable
#: ``plan_mem`` (bytes) — only placement feasibility cares
_DEFAULT_HBM_BYTES = 1 << 30


def _read_table(path: str, columns: Sequence[str]) -> List[Dict[str, str]]:
    """Read one CSV table, with or without a header row."""
    rows: List[Dict[str, str]] = []
    with open(path, newline="") as f:
        reader = csv.reader(f)
        for i, raw in enumerate(reader):
            if not raw or not any(cell.strip() for cell in raw):
                continue
            if i == 0 and any("job_name" in cell for cell in raw):
                columns = tuple(cell.strip() for cell in raw)
                continue
            rows.append({c: (raw[j].strip() if j < len(raw) else "")
                         for j, c in enumerate(columns)})
    return rows


def _num(text: str) -> Optional[float]:
    if not text:
        return None
    try:
        v = float(text)
    except ValueError:
        return None
    return v if math.isfinite(v) else None


@dataclass
class IngestStats:
    """What the reader kept, dropped, and normalized — the honesty ledger
    printed next to every ingested trace."""

    jobs_read: int = 0
    jobs_kept: int = 0
    dropped_no_tasks: int = 0
    dropped_bad_times: int = 0
    non_monotone_rows: int = 0        # rows out of submit order in the file
    arrival_shift_s: float = 0.0      # subtracted so the trace starts at 0
    classes: Dict[str, int] = field(default_factory=dict)

    def render(self) -> str:
        cls = ", ".join(f"{k}:{v}" for k, v in sorted(self.classes.items()))
        return (f"ingest: kept {self.jobs_kept}/{self.jobs_read} jobs "
                f"(dropped {self.dropped_no_tasks} taskless, "
                f"{self.dropped_bad_times} with bad timestamps; "
                f"{self.non_monotone_rows} rows out of submit order, "
                f"normalized by {self.arrival_shift_s:.0f} s); "
                f"classes: {cls}")


def load_alibaba(path: str, max_jobs: Optional[int] = None,
                 name: Optional[str] = None
                 ) -> Tuple[Trace, IngestStats]:
    """Read an Alibaba-schema trace directory into a (Trace, stats) pair.

    ``path`` must contain ``pai_job_table.csv`` and ``pai_task_table.csv``
    (header optional).  Rows with unparsable/negative spans are dropped
    and counted; out-of-order submissions are kept — the Trace sorts.
    """
    job_path = os.path.join(path, "pai_job_table.csv")
    task_path = os.path.join(path, "pai_task_table.csv")
    for p in (job_path, task_path):
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"{p} not found — expected an Alibaba cluster-trace-gpu-"
                f"v2020 directory with pai_job_table.csv + "
                f"pai_task_table.csv")
    stats = IngestStats()

    # task table: per job, the gang's GPU demand and the longest task span
    demand: Dict[str, float] = {}        # job -> sum(inst_num * plan_gpu)%
    span: Dict[str, float] = {}          # job -> longest task duration (s)
    mem: Dict[str, float] = {}           # job -> summed plan_mem (GB-ish)
    gpu_type: Dict[str, str] = {}
    for row in _read_table(task_path, TASK_COLUMNS):
        jid = row.get("job_name", "")
        if not jid:
            continue
        t0, t1 = _num(row.get("start_time", "")), _num(row.get("end_time", ""))
        if t0 is not None and t1 is not None and t1 > t0:
            span[jid] = max(span.get(jid, 0.0), t1 - t0)
        inst = _num(row.get("inst_num", "")) or 1.0
        gpu = _num(row.get("plan_gpu", ""))
        if gpu is not None and gpu > 0:
            demand[jid] = demand.get(jid, 0.0) + inst * gpu
        pm = _num(row.get("plan_mem", ""))
        if pm is not None and pm > 0:
            mem[jid] = mem.get(jid, 0.0) + pm
        gt = row.get("gpu_type", "")
        if gt and jid not in gpu_type:
            gpu_type[jid] = gt.lower()

    raw_jobs: List[Tuple[float, str, str, float, int, str]] = []
    prev_submit = -math.inf
    for row in _read_table(job_path, JOB_COLUMNS):
        jid = row.get("job_name", "")
        if not jid:
            continue
        stats.jobs_read += 1
        submit = _num(row.get("submit_time", ""))
        if submit is None or submit < 0:
            stats.dropped_bad_times += 1
            continue
        if submit < prev_submit:
            stats.non_monotone_rows += 1
        prev_submit = submit
        dur = span.get(jid)
        if dur is None:
            # job table's own span is the fallback when no task matched
            t0 = _num(row.get("start_time", ""))
            t1 = _num(row.get("end_time", ""))
            if t0 is not None and t1 is not None and t1 > t0:
                dur = t1 - t0
        if dur is None or dur <= 0:
            stats.dropped_no_tasks += 1
            continue
        gpus = demand.get(jid, 100.0) / 100.0     # plan_gpu is a percent
        nd = max(int(math.ceil(gpus - 1e-9)), 1)
        user = row.get("user", "") or "anon"
        raw_jobs.append((submit, jid, user, dur, nd,
                         gpu_type.get(jid, "misc")))
        if max_jobs is not None and len(raw_jobs) >= max_jobs:
            break
    if not raw_jobs:
        raise ValueError(f"no usable jobs in {path}")

    # class bucketing: (gpu type, gang size); per-class step price from
    # the class's median duration so num_steps stays O(100) and the
    # short-job tail survives discretization
    by_class: Dict[str, List[float]] = {}
    for _, _, _, dur, nd, gt in raw_jobs:
        by_class.setdefault(f"{gt}-g{nd}", []).append(dur)
    step_s: Dict[str, float] = {}
    classes: List[JobClass] = []
    n_total = len(raw_jobs)
    mem_by_class: Dict[str, List[float]] = {}
    for _, jid, _, _, nd, gt in raw_jobs:
        if jid in mem:
            mem_by_class.setdefault(f"{gt}-g{nd}", []).append(mem[jid])
    base_step: Optional[float] = None
    for cname in sorted(by_class):
        durs = sorted(by_class[cname])
        median = durs[len(durs) // 2]
        sps = max(median / STEPS_AT_MEDIAN, 1e-9)
        step_s[cname] = sps
        if base_step is None:
            base_step = sps
        nd = int(cname.rsplit("-g", 1)[1])
        lo = max(int(round(durs[0] / sps)), 1)
        hi = max(int(round(durs[-1] / sps)), lo)
        classes.append(JobClass(
            cname, "lenet", steps_lo=lo, steps_hi=hi,
            weight=len(durs) / n_total,
            cost_scale=sps / base_step, num_devices=nd))

    shift = min(j[0] for j in raw_jobs)
    stats.arrival_shift_s = shift
    jobs = [Job(jid, f"{gt}-g{nd}", submit - shift,
                max(int(round(dur / step_s[f'{gt}-g{nd}'])), 1),
                user=user, num_devices=nd)
            for submit, jid, user, dur, nd, gt in raw_jobs]
    stats.jobs_kept = len(jobs)
    for j in jobs:
        stats.classes[j.job_class] = stats.classes.get(j.job_class, 0) + 1

    meta: Dict[str, float] = {"arrival_shift_s": shift,
                              "source": 2020.0}
    for cname, sps in step_s.items():
        meta[f"step_s:{cname}"] = sps
        mems = mem_by_class.get(cname)
        if mems:
            # plan_mem is ~GB in the public tables
            meta[f"hbm_bytes:{cname}"] = \
                (sum(mems) / len(mems)) * (1 << 30)
    trace = Trace(name or os.path.basename(os.path.normpath(path))
                  or "alibaba", jobs, tuple(classes), meta=meta)
    return trace, stats


def table_cost_model(trace: Trace,
                     default_hbm_bytes: float = _DEFAULT_HBM_BYTES
                     ) -> TableCostModel:
    """Build the replay cost model from a trace's ``step_s:*`` meta keys.

    An ingested (or alibaba-like generated) trace carries its measured
    per-class step price; replaying through this table makes simulated
    service time equal the trace's observed durations — the property the
    analytic cross-checks assume.  Raises ``KeyError`` when the trace
    carries no step prices (synthetic traces should use
    :func:`repro_torch.cluster.devices.cost_model_for` instead).
    """
    table: Dict[str, Tuple[float, float]] = {}
    for key, val in trace.meta.items():
        if key.startswith("step_s:"):
            cname = key.split(":", 1)[1]
            peak = trace.meta.get(f"hbm_bytes:{cname}", default_hbm_bytes)
            table[cname] = (float(val), float(peak))
    if not table:
        raise KeyError(f"trace {trace.name!r} carries no step_s:* meta — "
                       "not an ingested/alibaba-like trace")
    missing = {j.job_class for j in trace.jobs} - set(table)
    if missing:
        raise KeyError(f"trace meta lacks step prices for {sorted(missing)}")
    return TableCostModel(table)


# ---------------------------------------------------------------------------
# refit profile + alibaba-like generator
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WorkloadProfile:
    """Everything :func:`alibaba_like_trace` needs to generate fresh
    traces statistically matched to an ingested one."""

    interarrival: FitResult            # fitted inter-arrival distribution
    rate_jobs_per_s: float             # observed long-run arrival rate
    classes: Tuple[JobClass, ...]      # weights + step bounds + footprints
    step_s: Dict[str, float]           # per-class step price (meta keys)

    def meta(self) -> Dict[str, float]:
        out: Dict[str, float] = {"rate_jobs_per_s": self.rate_jobs_per_s}
        for cname, sps in self.step_s.items():
            out[f"step_s:{cname}"] = sps
        return out


def profile_from_trace(trace: Trace) -> WorkloadProfile:
    """Refit a (typically ingested) trace into a generator profile.

    Inter-arrivals go through :func:`repro_torch.validate.fitting.best_fit`;
    class weights/step bounds are re-derived from the observed jobs (the
    ingested JobClass catalog already carries them, but re-deriving keeps
    the function total on hand-built traces too).
    """
    arrivals = [j.arrival_s for j in trace.jobs]
    gaps = [b - a for a, b in zip(arrivals, arrivals[1:]) if b > a]
    if len(gaps) < 3:
        raise ValueError(f"trace {trace.name!r} has too few distinct "
                         "arrivals to fit an inter-arrival distribution")
    ia = best_fit(gaps)
    span = arrivals[-1] - arrivals[0]
    rate = (len(arrivals) - 1) / span if span > 0 else 1.0
    counts: Dict[str, int] = {}
    steps: Dict[str, List[int]] = {}
    for j in trace.jobs:
        counts[j.job_class] = counts.get(j.job_class, 0) + 1
        steps.setdefault(j.job_class, []).append(j.num_steps)
    classes = []
    for c in trace.classes:
        if c.name not in counts:
            continue
        ss = sorted(steps[c.name])
        classes.append(JobClass(
            c.name, c.arch, seq_len=c.seq_len,
            global_batch=c.global_batch,
            steps_lo=ss[0], steps_hi=ss[-1],
            weight=counts[c.name] / len(trace.jobs),
            cost_scale=c.cost_scale, num_devices=c.num_devices))
    step_s = {k.split(":", 1)[1]: float(v) for k, v in trace.meta.items()
              if k.startswith("step_s:")}
    return WorkloadProfile(ia, rate, tuple(classes), step_s)


def _default_profile() -> WorkloadProfile:
    """Built-in alibaba-like shape for generator use WITHOUT an ingested
    trace: bursty sub-exponential arrivals (Weibull k<1), mostly
    single-GPU short jobs, a small multi-GPU tail — the headline stats of
    the published v2020 analysis, not a fit of the full tables."""
    shape = 0.75
    scale = 1.0 / math.gamma(1.0 + 1.0 / shape)   # mean 1.0 inter-arrival
    ia = FitResult("weibull", (shape, scale), 1.0,
                   math.gamma(1.0 + 2.0 / shape) * scale * scale - 1.0,
                   n=0, ks_stat=0.0, ks_pvalue=1.0,
                   chi2_stat=0.0, chi2_pvalue=1.0, chi2_dof=0)
    classes = (
        JobClass("misc-g1", "lenet", steps_lo=5, steps_hi=400,
                 weight=0.70, cost_scale=1.0),
        JobClass("v100-g1", "lenet", steps_lo=20, steps_hi=2000,
                 weight=0.20, cost_scale=2.0),
        JobClass("v100-g2", "lenet", steps_lo=50, steps_hi=4000,
                 weight=0.07, cost_scale=2.0, num_devices=2),
        JobClass("v100-g4", "lenet", steps_lo=100, steps_hi=8000,
                 weight=0.03, cost_scale=2.0, num_devices=4),
    )
    step_s = {"misc-g1": 0.05, "v100-g1": 0.1, "v100-g2": 0.1,
              "v100-g4": 0.1}
    return WorkloadProfile(ia, 1.0, classes, step_s)


_DEFAULT_PROFILE: Optional[WorkloadProfile] = None


def default_profile() -> WorkloadProfile:
    global _DEFAULT_PROFILE
    if _DEFAULT_PROFILE is None:
        _DEFAULT_PROFILE = _default_profile()
    return _DEFAULT_PROFILE


def alibaba_like_trace(n_jobs: int = 40, rate_jobs_per_s: float = 1.0,
                       classes: Optional[Sequence[JobClass]] = None,
                       seed: int = 0, name: str = "alibaba-like",
                       profile: Optional[WorkloadProfile] = None) -> Trace:
    """Generate a trace from an alibaba-like :class:`WorkloadProfile`.

    Arrivals replay the profile's *fitted* inter-arrival distribution,
    rescaled to ``rate_jobs_per_s`` (so latency-vs-load sweeps compress
    the clock without changing the arrival process's shape); the job
    population draws from the profile's class weights through the same
    deterministic population stream every other generator uses (the
    rate-invariance contract of ``_draw_jobs``).
    """
    prof = profile or default_profile()
    mix = tuple(classes) if classes is not None else prof.classes
    rng = random.Random(seed)
    population = _draw_jobs(n_jobs, mix, seed)
    ia = prof.interarrival
    # rescale the fitted inter-arrival mean to the requested rate
    scale = (1.0 / rate_jobs_per_s) / ia.mean \
        if rate_jobs_per_s > 0 and ia.mean > 0 else 1.0
    t, jobs = 0.0, []
    for i, (c, steps, user) in enumerate(population):
        t += ia.sample(rng) * scale
        jobs.append(Job(f"job-{i:04d}", c.name, t, steps, user,
                        num_devices=c.num_devices))
    meta = prof.meta()
    meta.update({"rate_jobs_per_s": rate_jobs_per_s, "seed": seed})
    meta["interarrival_scv"] = ia.scv if math.isfinite(ia.scv) else -1.0
    return Trace(name, jobs, mix, meta=meta)


#: register with the workload generator catalog so
#: ``--trace synthetic:alibaba-like`` resolves (workload.synthetic_trace
#: lazy-imports this module on first unknown-kind lookup)
GENERATORS.setdefault("alibaba-like", alibaba_like_trace)
