"""repro_torch.obs.doctor — automated diagnosis with counterfactual pricing.

The paper's observability loop ends with a human squinting at AerialVision
plots to *name* the pathology (partition camping, §V).  The doctor closes
that loop mechanically: run every registered detector over a report
(:mod:`repro_torch.obs.detectors`), price each finding's counterfactual through
the tape-replay what-if engine (:mod:`repro_torch.obs.whatif`), and rank the
findings by ``recoverable_seconds`` — the seconds a fix would actually buy
on the simulated clock.  Exports: ASCII table, JSON doc, and chrome-trace
annotation overlays that compose with the PR 8 exporters
(``trace_json(op_events, lapse_events, doctor_events)``).

Entry points: :func:`diagnose_engine` / :func:`diagnose_cluster` (library),
``python -m repro_torch.obs doctor`` (CLI, incl. built-in pathological demo
workloads), and ``--doctor`` on the analysis and cluster CLIs.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.obs.detectors import (Finding, run_cluster_detectors,
                                       run_engine_detectors)
from repro_torch.obs.export import duration_event, instant_event, thread_meta
from repro_torch.obs.thresholds import DEFAULT_THRESHOLDS, Thresholds
from repro_torch.obs.whatif import ENGINE_WHATIFS, whatif_engine

#: chrome-trace track for doctor annotations (pid 0 — simulated time —
#: after the time-lapse counter tracks at 1100)
_DOCTOR_TID = 1200


@dataclass
class DoctorReport:
    """Ranked findings for one run, with counterfactual prices."""

    kind: str                       # "engine" | "cluster"
    label: str
    baseline_seconds: float         # makespan the recoveries are against
    findings: List[Finding] = field(default_factory=list)

    @property
    def top(self) -> Optional[Finding]:
        return self.findings[0] if self.findings else None

    @property
    def recoverable_total(self) -> float:
        """Sum of per-finding recoveries — an upper bound, the fixes are
        counterfactuals of the SAME baseline and do not compose."""
        return sum(f.recoverable_seconds for f in self.findings)

    def table(self, width: int = 72) -> str:
        """Ranked ASCII findings table (the CLI's primary rendering)."""
        head = (f"doctor: {self.label or self.kind} — baseline "
                f"{self.baseline_seconds * 1e3:.3f} ms, "
                f"{len(self.findings)} finding"
                f"{'' if len(self.findings) == 1 else 's'}")
        if not self.findings:
            return head + "\n  (clean: no pathology above threshold)"
        lines = [head,
                 f"  {'#':>2s} {'recoverable':>12s} {'share':>6s} "
                 f"{'method':>11s}  pathology"]
        for i, f in enumerate(self.findings, 1):
            share = f.recoverable_seconds / self.baseline_seconds \
                if self.baseline_seconds > 0 else 0.0
            lines.append(f"  {i:>2d} {f.recoverable_seconds * 1e3:9.3f} ms "
                         f"{share * 100:5.1f}% {f.method:>11s}  {f.slug}")
            if f.affected:
                lines.append(f"     {'':>34s}{'':>1s}affected: "
                             + ", ".join(f.affected[:4]))
        return "\n".join(lines)

    def to_doc(self) -> Dict[str, Any]:
        return {"kind": self.kind, "label": self.label,
                "baseline_seconds": self.baseline_seconds,
                "recoverable_total_seconds": self.recoverable_total,
                "findings": [f.to_doc() for f in self.findings]}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_doc(), indent=indent)

    def to_chrome_events(self, pid: int = 0) -> List[dict]:
        """Annotation overlay: one ``doctor`` track with a span per finding
        (its time-lapse concentration window when known, else the whole
        run), composing with the PR 8 op/lapse/span tracks."""
        if not self.findings:
            return []
        events = [thread_meta("doctor", tid=_DOCTOR_TID, pid=pid)]
        for f in self.findings:
            args = {"recoverable_ms": round(f.recoverable_seconds * 1e3, 6),
                    "method": f.method,
                    **{k: round(v, 6) for k, v in f.evidence.items()}}
            if f.span_seconds is not None:
                t0, t1 = f.span_seconds
                events.append(duration_event(
                    f.slug, "doctor", t0, max(t1 - t0, 0.0),
                    tid=_DOCTOR_TID, pid=pid, args=args))
            else:
                events.append(duration_event(
                    f.slug, "doctor", 0.0, self.baseline_seconds,
                    tid=_DOCTOR_TID, pid=pid, args=args))
            if f.affected:
                events.append(instant_event(
                    f"{f.slug}: {f.affected[0]}", "doctor",
                    f.span_seconds[0] if f.span_seconds else 0.0,
                    tid=_DOCTOR_TID, pid=pid))
        return events


def _rank(findings: List[Finding], baseline: float,
          thresholds: Thresholds) -> List[Finding]:
    """Drop priced findings under the noise floor, rank by recovery.

    Recoveries are clamped to the baseline: analytic cluster estimates
    are in fleet-seconds and can exceed the wall-clock makespan, but no
    fix can recover more than the whole run."""
    floor = thresholds.min_recoverable_fraction * baseline
    kept = [f for f in findings
            if f.method == "unpriced" or f.recoverable_seconds >= floor]
    for f in kept:
        f.recoverable_seconds = min(f.recoverable_seconds, baseline)
    return sorted(kept, key=lambda f: -f.recoverable_seconds)


def diagnose_engine(report, engine=None, module=None, lapse=None,
                    thresholds: Thresholds = DEFAULT_THRESHOLDS,
                    label: str = "") -> DoctorReport:
    """Diagnose one engine run; price findings when the module is at hand.

    ``engine`` + ``module`` enable the counterfactual pass (tape replay,
    falling back to knob-override re-simulation); without them findings
    stay ``method="unpriced"`` and rank by detector order.
    """
    from repro_torch.obs.trace import TRACER
    with TRACER.span("doctor.diagnose", kind="engine"):
        s = report.summary()
        findings = run_engine_detectors(report, s, lapse, thresholds)
        for f in findings:
            if f.slug not in ENGINE_WHATIFS:
                continue
            wi = whatif_engine(f.slug, report, engine=engine, module=module)
            if wi is None:
                continue
            f.recoverable_seconds = wi.recoverable_seconds
            f.method = wi.method
            f.evidence["ideal_seconds"] = wi.ideal_seconds
            if wi.detail and not f.detail:
                f.detail = wi.detail
    return DoctorReport("engine", label, report.total_seconds,
                        _rank(findings, report.total_seconds, thresholds))


def diagnose_cluster(report, lapse=None,
                     thresholds: Thresholds = DEFAULT_THRESHOLDS,
                     context: Optional[Dict[str, Any]] = None,
                     label: str = "") -> DoctorReport:
    """Diagnose one fleet run.  ``context`` may carry ``checkpoint`` (the
    run's :class:`~repro_torch.faults.CheckpointModel`) and ``mtbf_s`` so the
    Young-Daly rule can price the cadence; cluster findings are analytic
    (no tape exists across the event loop)."""
    from repro_torch.obs.trace import TRACER
    with TRACER.span("doctor.diagnose", kind="cluster"):
        s = report.summary()
        findings = run_cluster_detectors(report, s, lapse, thresholds,
                                         context)
    label = label or f"{report.trace_name} x {report.policy}"
    return DoctorReport("cluster", label, report.makespan_s,
                        _rank(findings, report.makespan_s, thresholds))


# ----------------------------------------------------------------------
# built-in demo workloads (CLI + CI smoke): hand-built HLO pathologies
# ----------------------------------------------------------------------
_DEMO_ELEMS = 1 << 20      # 4 MiB f32 buffers


def demo_module_src(pathology: str, n_ops: int = 8) -> str:
    """Hand-built HLO text exhibiting exactly one pathology.

    * ``"camping"`` — a serial chain of gathers into one shared table:
      every op camps the same placement-derived channel subset (the paper's
      §V pathology, worst case: full 1/CAMPING_FRACTION dilation);
    * ``"clean"`` — the contiguous twin: a negate chain with the identical
      per-op byte/flop profile (8 MiB moved, same vpu work) striped evenly;
    * ``"no-overlap"`` — compute serialized against all-reduces so the
      collectives sit fully exposed on the critical path.
    """
    n = _DEMO_ELEMS
    head = [f"ENTRY %main (p0: f32[{n}], idx: s32[{n}]) -> f32[{n}] {{",
            f"  %p0 = f32[{n}]{{0}} parameter(0)",
            f"  %idx = s32[{n}]{{0}} parameter(1)"]
    lines, prev = list(head), "idx"
    if pathology == "camping":
        for i in range(n_ops):
            root = "ROOT " if i == n_ops - 1 else ""
            lines.append(f"  {root}%g{i} = f32[{n}]{{0}} "
                         f"gather(%p0, %{prev}), offset_dims={{}}")
            prev = f"g{i}"
    elif pathology == "clean":
        lines.append(f"  %g0 = f32[{n}]{{0}} add(%p0, %p0)")
        prev = "g0"
        for i in range(1, n_ops):
            root = "ROOT " if i == n_ops - 1 else ""
            lines.append(f"  {root}%n{i} = f32[{n}]{{0}} negate(%{prev})")
            prev = f"n{i}"
    elif pathology == "no-overlap":
        for i in range(n_ops):
            root = "ROOT " if i == n_ops - 1 else ""
            lines.append(f"  %c{i} = f32[{n}]{{0}} negate(%{prev})")
            lines.append(f"  {root}%r{i} = f32[{n}]{{0}} "
                         f"all-reduce(%c{i}), replica_groups={{{{0,1,2,3}}}}")
            prev = f"r{i}"
    else:
        raise KeyError(f"unknown demo pathology {pathology!r} "
                       "(expected camping | clean | no-overlap)")
    lines.append("}")
    return "\n".join(lines)


def diagnose_demo(pathology: str, hw=None, n_ops: int = 8,
                  thresholds: Thresholds = DEFAULT_THRESHOLDS,
                  overlap: bool = True):
    """Simulate one built-in demo workload and diagnose it.

    Returns ``(DoctorReport, SimReport)`` — the CI smoke and ``python -m
    repro_torch.obs doctor`` default path (no jax capture needed)."""
    from repro_torch.core import V5E, Engine, parse_hlo_module
    from repro_torch.obs.timelapse import TimeLapse
    hw = hw or V5E
    mod = parse_hlo_module(demo_module_src(pathology, n_ops))
    engine = Engine(hw=hw, overlap_collectives=overlap)
    report = engine.simulate(mod)
    lapse = TimeLapse.from_report(report, num_intervals=32,
                                  label=f"demo:{pathology}")
    doc = diagnose_engine(report, engine=engine, module=mod, lapse=lapse,
                          thresholds=thresholds,
                          label=f"demo:{pathology}")
    return doc, report
