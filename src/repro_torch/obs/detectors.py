"""Pathology detectors: telemetry in, named structured findings out.

Each detector is one rule over a run's existing telemetry — the
``SimReport``/``ClusterReport`` summaries, the timeline, and (when given)
the PR 8 time-lapse intervals — and emits a :class:`Finding` naming the
pathology, its evidence metrics, the affected ops/devices/links and the
time-lapse interval span where it concentrates.  Detection is cheap and
purely observational; *pricing* what a fix would buy is the what-if
engine's job (:mod:`repro_torch.obs.whatif`), which the doctor runs per finding
to fill ``recoverable_seconds``.

All cutoffs come from the shared :class:`~repro_torch.obs.thresholds.Thresholds`
config, so a doctor verdict can never disagree with the timelapse heat
strips or the links table.

Registries are plain lists of callables — register a custom rule with the
:func:`engine_detector` / :func:`cluster_detector` decorators.  Engine
detectors take ``(report, summary, lapse, thresholds)``; cluster detectors
take ``(report, summary, lapse, thresholds, context)`` where ``context``
optionally carries the run's :class:`~repro_torch.faults.CheckpointModel` and
MTBF (the CLI passes them) for the Young–Daly rule.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.obs.thresholds import DEFAULT_THRESHOLDS, Thresholds

#: what-if slug each engine finding is priced with (identity for engine
#: pathologies; cluster findings are analytic and carry their own price)
ENGINE_DETECTORS: List[Callable] = []
CLUSTER_DETECTORS: List[Callable] = []


@dataclass
class Finding:
    """One named pathology diagnosed on a run."""

    slug: str                     # stable id, e.g. "hbm-channel-camping"
    title: str                    # human-readable one-liner
    evidence: Dict[str, float] = field(default_factory=dict)
    #: affected ops / devices / links, hottest first
    affected: List[str] = field(default_factory=list)
    #: (first, last) time-lapse interval index where it concentrates
    interval_span: Optional[Tuple[int, int]] = None
    #: wall-time span of ``interval_span`` in simulated seconds
    span_seconds: Optional[Tuple[float, float]] = None
    #: what fixing ONLY this would buy (filled by the doctor's what-if
    #: pass for engine findings; analytic for cluster findings)
    recoverable_seconds: float = 0.0
    #: how recoverable_seconds was priced: "tape-replay" | "engine-knob"
    #: | "analytic" | "unpriced"
    method: str = "unpriced"
    detail: str = ""

    def to_doc(self) -> Dict[str, Any]:
        return {"slug": self.slug, "title": self.title,
                "evidence": dict(self.evidence),
                "affected": list(self.affected),
                "interval_span": list(self.interval_span)
                if self.interval_span else None,
                "span_seconds": list(self.span_seconds)
                if self.span_seconds else None,
                "recoverable_seconds": self.recoverable_seconds,
                "method": self.method,
                "detail": self.detail}


def engine_detector(fn: Callable) -> Callable:
    ENGINE_DETECTORS.append(fn)
    return fn


def cluster_detector(fn: Callable) -> Callable:
    CLUSTER_DETECTORS.append(fn)
    return fn


def _lapse_span(lapse, indices) -> Tuple[Optional[Tuple[int, int]],
                                         Optional[Tuple[float, float]]]:
    """(interval_span, span_seconds) for a set of flagged interval
    indices (None, None when nothing is flagged or no lapse given)."""
    if lapse is None or not indices:
        return None, None
    lo, hi = min(indices), max(indices)
    return (lo, hi), (lapse.intervals[lo].t0, lapse.intervals[hi].t1)


# ----------------------------------------------------------------------
# engine detectors (report, summary, lapse, thresholds) -> Finding | None
# ----------------------------------------------------------------------
@engine_detector
def detect_channel_camping(report, s, lapse,
                           th: Thresholds) -> Optional[Finding]:
    """HBM channel camping: camping-class ops concentrate their traffic on
    an address-derived channel subset (paper §V, Figs. 22-25)."""
    from repro_torch.memory.channels import is_camping_op
    camped = lapse.camped_intervals() if lapse is not None else []
    imb = s.get("channel_imbalance", 0.0)
    if not camped and imb <= th.channel_camping_imbalance:
        return None
    campers: Dict[str, float] = {}
    camp_busy = 0.0
    for e in report.timeline:
        if is_camping_op(e.opcode, e.name):
            sec = e.duration * e.scale
            campers[e.name] = campers.get(e.name, 0.0) + sec
            camp_busy += sec
    if camp_busy <= 0:
        return None
    span, span_s = _lapse_span(lapse, camped)
    top = sorted(campers.items(), key=lambda kv: -kv[1])[:4]
    return Finding(
        "hbm-channel-camping",
        "HBM channel camping: camping-class ops gate on a channel subset",
        evidence={"channel_imbalance": imb,
                  "camping_busy_seconds": camp_busy,
                  "camped_intervals": float(len(camped))},
        affected=[n for n, _ in top],
        interval_span=span, span_seconds=span_s)


@engine_detector
def detect_link_imbalance(report, s, lapse,
                          th: Thresholds) -> Optional[Finding]:
    """Fabric link camping: one axis' links carry most of the collective
    traffic while the rest of the fabric idles."""
    from repro_torch.analysis.links import link_traffic
    lr = link_traffic(report)
    if lr.num_links < 2 or lr.imbalance <= th.link_camping_imbalance:
        return None
    return Finding(
        "link-imbalance",
        "fabric link imbalance: a minority of ICI links gates the "
        "collectives",
        evidence={"link_imbalance": lr.imbalance,
                  "hot_link_bytes": lr.link_bytes.get(lr.hot_link, 0.0),
                  "total_link_bytes": lr.total_bytes},
        affected=[lr.hot_link] + [n for n, _ in lr.hot_contributors[:3]])


@engine_detector
def detect_exposed_comm(report, s, lapse,
                        th: Thresholds) -> Optional[Finding]:
    """Exposed communication: collective seconds the schedule failed to
    hide behind compute."""
    total = s.get("total_seconds", 0.0)
    exposed = s.get("exposed_ici_seconds", 0.0)
    if total <= 0 or exposed / total <= th.exposed_comm_fraction:
        return None
    hot = sorted((e for e in report.timeline if e.unit == "ici"),
                 key=lambda e: -getattr(e, "exposed_s", 0.0))[:4]
    return Finding(
        "exposed-communication",
        "exposed communication: collectives sit on the critical path "
        "instead of overlapping compute",
        evidence={"exposed_ici_seconds": exposed,
                  "exposed_fraction": exposed / total,
                  "ici_seconds": s.get("ici_seconds", 0.0)},
        affected=[e.name for e in hot])


@engine_detector
def detect_vmem_spill(report, s, lapse,
                      th: Thresholds) -> Optional[Finding]:
    """VMEM spill: working sets over VMEM capacity spill extra HBM
    traffic."""
    frac = s.get("spill_fraction", 0.0)
    if frac <= th.spill_fraction:
        return None
    spillers: Dict[str, float] = {}
    for e in report.timeline:
        sp = getattr(e, "spill_bytes", 0)
        if sp:
            spillers[e.name] = spillers.get(e.name, 0.0) + sp * e.scale
    top = sorted(spillers.items(), key=lambda kv: -kv[1])[:4]
    return Finding(
        "vmem-spill",
        "VMEM spill: over-capacity working sets stream extra HBM traffic",
        evidence={"spill_bytes": s.get("spill_bytes", 0.0),
                  "spill_fraction": frac},
        affected=[n for n, _ in top])


@engine_detector
def detect_launch_overhead(report, s, lapse,
                           th: Thresholds) -> Optional[Finding]:
    """Launch-overhead domination: fixed per-op issue cost outweighs the
    useful work (tiny-op workloads — the lenet smoke capture's verdict)."""
    total = s.get("total_seconds", 0.0)
    ovh = s.get("launch_overhead_seconds", 0.0)
    if total <= 0 or ovh / total <= th.launch_overhead_fraction:
        return None
    return Finding(
        "launch-overhead",
        "launch-overhead domination: per-op issue cost outweighs the "
        "useful work",
        evidence={"launch_overhead_seconds": ovh,
                  "overhead_fraction": ovh / total,
                  "timeline_ops": float(len(report.timeline))})


# ----------------------------------------------------------------------
# cluster detectors (report, summary, lapse, th, context) -> Finding|None
# ----------------------------------------------------------------------
@cluster_detector
def detect_hol_blocking(report, s, lapse, th: Thresholds,
                        context) -> Optional[Finding]:
    """Head-of-line blocking: the queue head couldn't fit while later
    jobs could have run."""
    n_jobs = max(len(report.jobs), 1)
    blocked = list(report.hol_blocked_jobs)
    if len(blocked) / n_jobs <= th.hol_blocked_fraction:
        return None
    mean_delay = s.get("mean_queue_delay_s", 0.0)
    return Finding(
        "cluster-hol-blocking",
        "head-of-line blocking: queue-head jobs stall the backlog",
        evidence={"hol_events": float(report.hol_events),
                  "hol_blocked_jobs": float(len(blocked)),
                  "blocked_fraction": len(blocked) / n_jobs,
                  "mean_queue_delay_s": mean_delay},
        affected=blocked[:6],
        recoverable_seconds=mean_delay * len(blocked),
        method="analytic",
        detail="estimate: blocked jobs x mean queue delay (a "
               "size-aware policy bypasses the blocker)")


@cluster_detector
def detect_gang_stragglers(report, s, lapse, th: Thresholds,
                           context) -> Optional[Finding]:
    """Gang stragglers: one member device of a lockstep gang stays busier
    than its peers, dilating every step for the whole gang."""
    gangs: Dict[tuple, Dict[str, float]] = {}
    for sl in report.slices:
        if sl.kind != "run" or not sl.group or len(sl.group) < 2:
            continue
        per_dev = gangs.setdefault(tuple(sl.group), {})
        per_dev[sl.device_id] = per_dev.get(sl.device_id, 0.0) \
            + (sl.t1 - sl.t0)
    worst_dil, recoverable, laggards = 0.0, 0.0, []
    for group, per_dev in gangs.items():
        if len(per_dev) < 2:
            continue
        busy = list(per_dev.values())
        mean = sum(busy) / len(busy)
        if mean <= 0:
            continue
        peak = max(busy)
        dil = peak / mean
        if dil > th.straggler_dilation:
            recoverable += peak - mean
            laggards.append(max(per_dev, key=per_dev.get))
            worst_dil = max(worst_dil, dil)
    if not laggards:
        return None
    return Finding(
        "gang-stragglers",
        "gang stragglers: slowest members dilate lockstep gangs",
        evidence={"worst_dilation": worst_dil,
                  "straggling_gangs": float(len(laggards))},
        affected=sorted(set(laggards))[:6],
        recoverable_seconds=recoverable,
        method="analytic",
        detail="estimate: per-gang (peak - mean) member busy seconds")


@cluster_detector
def detect_checkpoint_interval(report, s, lapse, th: Thresholds,
                               context) -> Optional[Finding]:
    """Checkpoint cadence vs the Young–Daly optimum sqrt(2wM): too-frequent
    saves waste writes, too-rare saves waste lost work on failure."""
    from repro_torch.faults.pricing import daly_interval
    ckpt = (context or {}).get("checkpoint")
    mtbf = (context or {}).get("mtbf_s")
    if ckpt is None or not mtbf or not math.isfinite(mtbf):
        return None
    tau = getattr(ckpt, "interval_s", 0.0)
    busy = report.fleet_busy_seconds
    if tau <= 0 or busy <= 0 or report.checkpoint_seconds <= 0:
        return None
    # effective mean write cost from the run itself: total write seconds
    # over the number of cadence cycles actually completed
    w = report.checkpoint_seconds * tau / busy
    tau_opt = daly_interval(w, mtbf)
    if not math.isfinite(tau_opt) or tau_opt <= 0:
        return None
    rel_err = abs(tau - tau_opt) / tau_opt
    if rel_err <= th.checkpoint_interval_rel_error:
        return None
    # first-order overhead fraction f(tau) = w/tau + tau/(2M)
    f_cur = w / tau + tau / (2.0 * mtbf)
    f_opt = w / tau_opt + tau_opt / (2.0 * mtbf)
    recoverable = max((f_cur - f_opt) * busy, 0.0)
    return Finding(
        "checkpoint-interval",
        "checkpoint cadence off the Young-Daly optimum",
        evidence={"interval_s": tau, "optimal_interval_s": tau_opt,
                  "rel_error": rel_err, "write_cost_s": w,
                  "mtbf_s": float(mtbf),
                  "checkpoint_seconds": report.checkpoint_seconds,
                  "lost_work_seconds": report.lost_work_seconds},
        recoverable_seconds=recoverable,
        method="analytic",
        detail=f"first-order overhead model w/tau + tau/2M; "
               f"move interval toward {tau_opt:.1f}s")


@cluster_detector
def detect_cache_miss_storm(report, s, lapse, th: Thresholds,
                            context) -> Optional[Finding]:
    """SimulationCache miss storm: per-job pricing keeps re-simulating
    instead of hitting the (module, hw, knobs) cache — a wall-clock
    pathology of the simulator itself, not of the simulated fleet."""
    hits, misses = report.cache_hits, report.cache_misses
    lookups = hits + misses
    if lookups < 16:
        return None
    rate = hits / lookups
    if rate >= th.cache_hit_rate_floor:
        return None
    price_wall = report.stage_seconds.get("price", 0.0)
    return Finding(
        "cache-miss-storm",
        "SimulationCache miss storm: cost pricing keeps re-simulating",
        evidence={"cache_hits": float(hits), "cache_misses": float(misses),
                  "hit_rate": rate},
        recoverable_seconds=price_wall * (1.0 - rate),
        method="analytic",
        detail="recoverable is simulator WALL-CLOCK pricing time (0 when "
               "the run was not stage-profiled), not simulated fleet time")


@cluster_detector
def detect_accounting_residual(report, s, lapse, th: Thresholds,
                               context) -> Optional[Finding]:
    """Conservation-law drift: Little's law / busy-time / utilization
    identities (``repro_torch.validate``) disagree with the report.  Unlike
    every other cluster finding this is a verdict on the SIMULATOR, not
    the simulated fleet — the identities are exact, so any residual
    above float noise means the tape and the records tell different
    stories about the same run."""
    try:
        from repro_torch.validate.queueing import conservation_checks
    except ImportError:                               # pragma: no cover
        return None
    bad = [c for c in conservation_checks(
        report, tol=th.conservation_residual) if not c.ok]
    if not bad:
        return None
    worst = max(bad, key=lambda c: c.residual)
    return Finding(
        "accounting-residual",
        f"{len(bad)} conservation identities violated "
        f"(worst {worst.name}: residual {worst.residual * 100:.3g}%)",
        evidence={c.name.replace("-", "_"): c.residual for c in bad},
        affected=[c.name for c in bad],
        method="analytic",
        detail="accounting drift is a simulator bug, not a workload "
               "effect — rerun with --validate for the full check table")


def run_engine_detectors(report, summary, lapse=None,
                         thresholds: Thresholds = DEFAULT_THRESHOLDS
                         ) -> List[Finding]:
    out = []
    for det in ENGINE_DETECTORS:
        f = det(report, summary, lapse, thresholds)
        if f is not None:
            out.append(f)
    return out


def run_cluster_detectors(report, summary, lapse=None,
                          thresholds: Thresholds = DEFAULT_THRESHOLDS,
                          context: Optional[Dict[str, Any]] = None
                          ) -> List[Finding]:
    out = []
    for det in CLUSTER_DETECTORS:
        f = det(report, summary, lapse, thresholds, context)
        if f is not None:
            out.append(f)
    return out
