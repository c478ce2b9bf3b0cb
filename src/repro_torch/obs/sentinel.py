"""Regression sentinel: gate CI on a committed run-manifest baseline.

``python -m repro_torch.obs diff`` answers "what changed between these runs?";
the sentinel answers the CI question "is this change acceptable?".  It
compares a freshly produced :class:`~repro_torch.obs.manifest.RunManifest`
against a committed baseline under *per-metric* tolerance rules (simulated
metrics are deterministic, so the default tolerance is tight; individual
metrics can be loosened with ``--tol metric=REL``), and maps the verdict
onto the repo's standard exit-code contract:

* ``0`` — clean: every metric within tolerance, same config and seeds;
* ``3`` — regression: a metric left its band, or a config/seed drifted;
* ``2`` — error: unreadable manifest, kind mismatch, bad tolerance spec.

Each run can be appended to a ``BENCH_doctor.json`` trajectory (one entry
per sentinel invocation with the headline metrics and verdict), so the
perf/diagnosis history is tracked across PRs next to ``BENCH_perf.json``.
"""
from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.obs.manifest import RunManifest

#: trajectory file schema version
TRAJECTORY_SCHEMA = 1

#: default per-metric relative tolerance — tight because the simulators
#: are deterministic; host-FP noise sits far below this
DEFAULT_TOLERANCE = 1e-6

#: headline metrics copied into each trajectory entry (when present)
HEADLINE_METRICS = ("total_seconds", "mfu", "hbm_utilization",
                    "channel_imbalance", "link_imbalance", "makespan_s",
                    "goodput_fraction", "mean_queue_delay_s")


def parse_tolerances(specs: List[str]) -> Dict[str, float]:
    """Parse repeated ``--tol metric=REL`` specs into a rule map."""
    out: Dict[str, float] = {}
    for spec in specs or []:
        name, eq, val = spec.partition("=")
        if not eq or not name:
            raise ValueError(f"bad tolerance spec {spec!r} "
                             "(expected metric=REL, e.g. mfu=0.05)")
        try:
            rel = float(val)
        except ValueError:
            raise ValueError(f"bad tolerance value in {spec!r}")
        if rel < 0:
            raise ValueError(f"negative tolerance in {spec!r}")
        out[name] = rel
    return out


@dataclass
class MetricVerdict:
    """One metric checked against its tolerance band."""

    name: str
    baseline: float
    fresh: float
    tolerance: float
    ok: bool

    @property
    def rel_delta(self) -> float:
        if self.baseline == 0.0:
            return 0.0 if self.fresh == 0.0 else math.inf
        return (self.fresh - self.baseline) / abs(self.baseline)

    def render(self) -> str:
        rel = self.rel_delta
        rel_s = f"{rel:+.3%}" if math.isfinite(rel) else "was 0"
        flag = "ok" if self.ok else "REGRESSED"
        return (f"{self.name:<36s} {self.baseline:>13.6g} -> "
                f"{self.fresh:<13.6g} ({rel_s}; tol {self.tolerance:g}) "
                f"{flag}")


@dataclass
class SentinelReport:
    """Verdict of one baseline-vs-fresh comparison."""

    baseline_label: str
    fresh_label: str
    verdicts: List[MetricVerdict] = field(default_factory=list)
    config_changes: Dict[str, Any] = field(default_factory=dict)
    seed_changes: Dict[str, Any] = field(default_factory=dict)
    identical_digest: bool = False

    @property
    def regressions(self) -> List[MetricVerdict]:
        return [v for v in self.verdicts if not v.ok]

    @property
    def clean(self) -> bool:
        return (not self.regressions and not self.config_changes
                and not self.seed_changes)

    def to_doc(self) -> Dict[str, Any]:
        return {"baseline": self.baseline_label, "fresh": self.fresh_label,
                "clean": self.clean,
                "identical_digest": self.identical_digest,
                "config_changes": dict(self.config_changes),
                "seed_changes": dict(self.seed_changes),
                "regressions": [{
                    "name": v.name, "baseline": v.baseline,
                    "fresh": v.fresh, "tolerance": v.tolerance,
                    "rel_delta": v.rel_delta
                    if math.isfinite(v.rel_delta) else None,
                } for v in self.regressions]}

    def render(self, verbose: bool = False) -> str:
        lines = [f"sentinel: {self.fresh_label!r} vs baseline "
                 f"{self.baseline_label!r} — "
                 f"{'CLEAN' if self.clean else 'REGRESSION'}"]
        if self.identical_digest:
            lines.append("  identical digest (bit-identical run)")
        for k, (va, vb) in sorted(self.config_changes.items()):
            lines.append(f"  config drift: {k} {va!r} -> {vb!r}")
        for k, (va, vb) in sorted(self.seed_changes.items()):
            lines.append(f"  seed drift: {k} {va!r} -> {vb!r}")
        shown = self.verdicts if verbose else self.regressions
        for v in shown:
            lines.append("  " + v.render())
        if self.clean and not verbose:
            lines.append(f"  {len(self.verdicts)} metrics within tolerance")
        return "\n".join(lines)


def sentinel_compare(baseline: RunManifest, fresh: RunManifest,
                     default_tol: float = DEFAULT_TOLERANCE,
                     tolerances: Optional[Dict[str, float]] = None
                     ) -> SentinelReport:
    """Check every baseline metric against the fresh run's value.

    A metric missing from the fresh run counts as regressed (the summary
    lost a field); metrics only the fresh run has are ignored (new fields
    are not regressions — re-baseline to start tracking them).  Config or
    seed drift is always a regression: a CI gate must not silently accept
    "the knobs changed, so the numbers did too".

    Raises ``ValueError`` on kind mismatch (engine vs cluster baselines
    are not comparable).
    """
    if baseline.kind != fresh.kind:
        raise ValueError(f"kind mismatch: baseline is {baseline.kind!r}, "
                         f"fresh is {fresh.kind!r} — not comparable")
    tolerances = tolerances or {}
    rep = SentinelReport(baseline.label or "baseline",
                         fresh.label or "fresh",
                         identical_digest=baseline.digest == fresh.digest)
    for k in sorted(set(baseline.config) | set(fresh.config)):
        va, vb = baseline.config.get(k), fresh.config.get(k)
        if va != vb:
            rep.config_changes[k] = (va, vb)
    for k in sorted(set(baseline.seeds) | set(fresh.seeds)):
        va, vb = baseline.seeds.get(k), fresh.seeds.get(k)
        if va != vb:
            rep.seed_changes[k] = (va, vb)
    for name in sorted(baseline.metrics):
        want = baseline.metrics[name]
        got = fresh.metrics.get(name)
        tol = tolerances.get(name, default_tol)
        if got is None:
            rep.verdicts.append(MetricVerdict(name, want, float("nan"),
                                              tol, ok=False))
            continue
        ok = abs(got - want) <= tol * max(abs(want), abs(got)) \
            or got == want
        rep.verdicts.append(MetricVerdict(name, want, got, tol, ok))
    return rep


# ----------------------------------------------------------------------
# BENCH_doctor.json trajectory
# ----------------------------------------------------------------------
def trajectory_entry(fresh: RunManifest, report: SentinelReport,
                     doctor_doc: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """One trajectory record: run identity + verdict + headline metrics
    (+ the doctor's ranked findings when a diagnosis rode along)."""
    entry: Dict[str, Any] = {
        "label": fresh.label, "kind": fresh.kind, "digest": fresh.digest,
        "recorded_unix": int(time.time()),
        "clean": report.clean,
        "regressions": len(report.regressions),
        "metrics": {k: fresh.metrics[k] for k in HEADLINE_METRICS
                    if k in fresh.metrics},
    }
    if doctor_doc is not None:
        entry["findings"] = [
            {"slug": f["slug"],
             "recoverable_seconds": f["recoverable_seconds"],
             "method": f["method"]}
            for f in doctor_doc.get("findings", [])]
    return entry


def append_trajectory(path: str, entry: Dict[str, Any]) -> int:
    """Append one entry to the trajectory file; returns the new length."""
    doc: Dict[str, Any] = {"schema": TRAJECTORY_SCHEMA, "runs": []}
    if os.path.exists(path):
        with open(path) as f:
            doc = json.load(f)
        if doc.get("schema", TRAJECTORY_SCHEMA) > TRAJECTORY_SCHEMA:
            raise ValueError(f"trajectory schema {doc.get('schema')} is "
                             f"newer than supported {TRAJECTORY_SCHEMA}")
        doc.setdefault("runs", [])
    doc["runs"].append(entry)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return len(doc["runs"])
