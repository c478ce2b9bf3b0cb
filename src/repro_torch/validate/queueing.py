"""Analytic queueing cross-checks: prove the fleet accounting, don't trust it.

The paper's methodology is correlation against an independent reference
(simulated kernels vs real hardware, §IV).  The cluster layer's analogue
is queueing theory: a :class:`~repro_torch.cluster.events.ClusterReport` makes
claims (mean queueing delay, utilization, goodput) that classical results
predict independently from the arrival/service processes alone.  Two
families of checks:

**Conservation laws** (exact — any residual is a simulator bug):

* *Little's law, fleet-wide*: time-average jobs in system ``L`` —
  integrated from the slice tape and the waiting-room depth deltas, the
  same data the exports render — must equal ``lambda * W`` computed from
  the per-job records.  The two sides come from independent accounting
  paths (slices vs records), so drift means the tape and the records
  disagree about history.
* *Little's law, waiting room*: queue length integral vs
  ``lambda * mean_total_queue_delay_s``.  This is the check that caught
  the requeue-wait bug: the legacy ``queue_delay_s`` (first wait only)
  understated ``W`` by up to ~50x on time-sliced runs.
* *Utilization / busy-time identities*: ``ClusterReport.utilization``
  vs the per-device ledger (including fault down-time), per-device busy
  vs the slice tape, engine-vs-busy reconciliation, goodput identity,
  and non-negative idle (occupancy and down-time never overlap).

**M/G/k approximation** (tolerance-banded, not exact): the Allen–Cunneen
correction of the Erlang-C M/M/k waiting time,

    Wq(M/G/k) ~= (Ca^2 + Cs^2) / 2 * Wq(M/M/k),

predicts the mean queueing delay from the measured arrival rate, service
moments and device count.  It is an approximation (and assumes FCFS-ish
single-server jobs), so it gates itself: checked only below a utilization
ceiling and when gang jobs are a small minority, with a 25% band.

Everything lands in a :class:`ValidationReport` that renders as a table,
serializes for manifests, and converts failing checks into
:class:`repro_torch.obs.detectors.Finding` rows so the doctor/diff machinery
attributes divergences like any other pathology.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

#: default band for exact conservation laws (residuals are ~1e-12 on a
#: healthy simulator; 1% absorbs float noise on huge tapes)
CONSERVATION_TOL = 0.01
#: default band for the M/G/k approximation (it IS an approximation)
QUEUEING_TOL = 0.25
#: utilization ceiling above which the M/G/k check gates itself off
#: (heavy-traffic + policy effects blow past any constant-factor band)
QUEUEING_MAX_UTIL = 0.70
#: gang-job share above which the M/G/k check gates itself off
QUEUEING_MAX_GANG_FRACTION = 0.25
#: mean SCV ((Ca^2+Cs^2)/2) beyond which Allen–Cunneen's constant-factor
#: correction is known to degrade badly — gate rather than cry wolf
QUEUEING_MAX_VARIABILITY = 5.0


# ---------------------------------------------------------------------------
# analytic building blocks
# ---------------------------------------------------------------------------

def erlang_c(k: int, offered_load: float) -> float:
    """P(wait) in M/M/k at offered load ``a = lambda * E[S]`` (< k).

    Computed with the numerically safe running-sum recurrence (no
    factorials)."""
    if k <= 0:
        raise ValueError(f"need k >= 1 servers, got {k}")
    a = offered_load
    if a <= 0:
        return 0.0
    if a >= k:
        return 1.0
    # term_i = a^i / i!, accumulated iteratively
    term, acc = 1.0, 1.0
    for i in range(1, k):
        term *= a / i
        acc += term
    term_k = term * a / k
    pk = term_k / (1.0 - a / k)
    return pk / (acc + pk)


def mmk_wq(lam: float, mean_service_s: float, k: int) -> float:
    """Mean waiting time in M/M/k (Erlang-C)."""
    a = lam * mean_service_s
    if a >= k or lam <= 0:
        return math.inf
    pw = erlang_c(k, a)
    return pw * mean_service_s / (k * (1.0 - a / k))


def allen_cunneen_wq(lam: float, mean_service_s: float, scv_service: float,
                     k: int, scv_arrival: float = 1.0) -> float:
    """Allen–Cunneen G/G/k mean-wait approximation.

    ``scv_arrival``/``scv_service`` are the squared coefficients of
    variation of inter-arrival and service times (1.0 = exponential)."""
    base = mmk_wq(lam, mean_service_s, k)
    if not math.isfinite(base):
        return base
    return base * (scv_arrival + scv_service) / 2.0


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

@dataclass
class Check:
    """One identity or approximation tested against the simulator."""

    name: str
    simulated: float
    predicted: float
    tol: float
    detail: str = ""
    #: absolute residual (|sim - pred|) instead of relative — for
    #: quantities whose reference value is exactly 0
    absolute: bool = False
    #: exact identities fail on ANY drift; approximations (M/G/k) only
    #: on leaving their tolerance band — and stay out of worst_residual
    exact: bool = True
    #: the check's preconditions failed (e.g. utilization too high for
    #: M/G/k): recorded but not counted as pass or fail
    gated: bool = False

    @property
    def residual(self) -> float:
        err = abs(self.simulated - self.predicted)
        if self.absolute:
            return err
        denom = max(abs(self.predicted), abs(self.simulated))
        if denom <= 1e-12:
            return 0.0
        return err / denom

    @property
    def ok(self) -> bool:
        return self.gated or self.residual <= self.tol

    def render(self) -> str:
        if self.gated:
            return (f"{self.name:<26s} GATED        ({self.detail})")
        unit = "" if self.absolute else "%"
        r = self.residual if self.absolute else self.residual * 100
        t = self.tol if self.absolute else self.tol * 100
        flag = "ok" if self.ok else "FAILED"
        out = (f"{self.name:<26s} sim {self.simulated:>12.6g}  "
               f"pred {self.predicted:>12.6g}  resid {r:.4g}{unit} "
               f"(tol {t:g}{unit}) {flag}")
        if self.detail:
            out += f"  [{self.detail}]"
        return out

    def to_doc(self) -> Dict[str, Any]:
        return {"name": self.name, "simulated": self.simulated,
                "predicted": self.predicted, "residual": self.residual,
                "tol": self.tol, "ok": self.ok, "gated": self.gated,
                "absolute": self.absolute, "exact": self.exact,
                "detail": self.detail}


@dataclass
class ValidationReport:
    """All checks for one run, plus the fit diagnostics that fed them."""

    label: str
    checks: List[Check] = field(default_factory=list)
    fit_lines: List[str] = field(default_factory=list)

    @property
    def failed(self) -> List[Check]:
        return [c for c in self.checks if not c.ok]

    @property
    def passed(self) -> bool:
        return not self.failed

    @property
    def worst_residual(self) -> float:
        """Worst RELATIVE residual over the EXACT conservation laws
        (gated / absolute / approximation-band checks excluded — they
        carry their own scales)."""
        rs = [c.residual for c in self.checks
              if not c.gated and not c.absolute and c.exact]
        return max(rs) if rs else 0.0

    def metrics(self) -> Dict[str, float]:
        """Flat metric map for run manifests (sentinel-trackable)."""
        out = {"validate_worst_residual": self.worst_residual,
               "validate_failed_checks": float(len(self.failed))}
        for c in self.checks:
            if not c.gated:
                out[f"validate_{c.name.replace('-', '_')}_residual"] = \
                    c.residual
        return out

    def render(self) -> str:
        lines = [f"validation: {self.label} — "
                 f"{'PASSED' if self.passed else 'FAILED'} "
                 f"({len([c for c in self.checks if not c.gated])} checks, "
                 f"worst residual {self.worst_residual * 100:.4g}%)"]
        lines += [f"  {c.render()}" for c in self.checks]
        if self.fit_lines:
            lines.append("fitted distributions:")
            lines += [f"  {l}" for l in self.fit_lines]
        return "\n".join(lines)

    def to_doc(self) -> Dict[str, Any]:
        return {"label": self.label, "passed": self.passed,
                "worst_residual": self.worst_residual,
                "checks": [c.to_doc() for c in self.checks],
                "fits": list(self.fit_lines)}

    def to_findings(self) -> List[Any]:
        """Failing checks as obs Findings, so doctor/diff attribute them."""
        from repro_torch.obs.detectors import Finding
        out = []
        for c in self.failed:
            out.append(Finding(
                f"validate-{c.name}",
                f"conservation check {c.name} failed: simulated "
                f"{c.simulated:.6g} vs predicted {c.predicted:.6g}",
                evidence={"simulated": c.simulated,
                          "predicted": c.predicted,
                          "residual": c.residual, "tolerance": c.tol},
                method="analytic",
                detail=c.detail or "accounting identity violated — a "
                                   "simulator bug, not a workload effect"))
        return out


def _occupancy_union(report) -> Dict[str, float]:
    """Per-job union of its slice spans (gang slices share spans)."""
    spans: Dict[str, List] = {}
    for s in report.slices:
        spans.setdefault(s.job_id, []).append((s.t0, s.t1))
    out: Dict[str, float] = {}
    for job_id, ivs in spans.items():
        ivs.sort()
        total, reach = 0.0, -math.inf
        for t0, t1 in ivs:
            if t0 > reach:
                total += t1 - t0
                reach = t1
            elif t1 > reach:
                total += t1 - reach
                reach = t1
        out[job_id] = total
    return out


def _waiting_area(report) -> float:
    """Integral of the waiting-room depth over the run — from the same
    (+1/-1) deltas the exports integrate."""
    from repro_torch.cluster.export import _queue_depth_events
    area, depth, prev = 0.0, 0, 0.0
    for t, delta in _queue_depth_events(report):
        area += depth * (t - prev)
        depth += delta
        prev = t
    return area


def conservation_checks(report, tol: float = CONSERVATION_TOL
                        ) -> List[Check]:
    """The exact identities.  Any failure here is a bug in the simulator's
    accounting — the PR contract is fix, not file."""
    checks: List[Check] = []
    T = report.makespan_s
    n = len(report.jobs)
    if T <= 0 or n == 0:
        return checks
    union = _occupancy_union(report)
    wait_area = _waiting_area(report)

    # Little's law over the whole system: slices + queue-depth tape (L) vs
    # per-job records (lambda * W)
    l_sim = (wait_area + sum(union.values())) / T
    l_pred = sum(j.latency_s for j in report.jobs) / T
    checks.append(Check(
        "littles-law-system", l_sim, l_pred, tol,
        detail="time-avg jobs in system: slice tape + queue depth vs "
               "sum(latency)/T"))

    # Little's law over the waiting room: catches dropped requeue waits
    lq_sim = wait_area / T
    lq_pred = n / T * report.mean_total_queue_delay_s
    checks.append(Check(
        "littles-law-queue", lq_sim, lq_pred, tol,
        detail="queue-depth integral vs lambda * mean TOTAL queue delay "
               "(first wait + requeue gaps)"))

    # utilization identity: report property vs the per-device ledger
    acc = report.time_accounting()
    occupied = sum(a["busy"] + a["setup"] + a["checkpoint"] + a["restore"]
                   + a["lost"] for a in acc.values())
    checks.append(Check(
        "utilization-identity", report.utilization,
        occupied / (T * report.num_devices), tol,
        detail="occupancy fraction vs time_accounting ledger (incl. "
               "fault down-time separation)"))

    # per-device busy: the tape's per-device sums vs the report's dict
    worst_dev = 0.0
    for dev, a in acc.items():
        want = report.per_device_busy.get(dev, 0.0)
        denom = max(abs(want), abs(a["busy"]), 1e-12)
        worst_dev = max(worst_dev, abs(want - a["busy"]) / denom
                        if denom > 1e-12 else 0.0)
    checks.append(Check(
        "per-device-busy", worst_dev, 0.0, tol, absolute=True,
        detail="worst per-device |ledger busy - per_device_busy| rel "
               "residual (Little's law per device)"))

    # busy time vs re-priced engine makespans (the acceptance invariant)
    checks.append(Check(
        "busy-engine-reconcile", report.fleet_busy_seconds,
        report.engine_service_seconds, tol,
        detail="event-loop busy seconds vs sum of engine-priced steps"))

    # non-negative idle: occupancy and down-time never overlap
    worst_idle = max((max(-a["idle"], 0.0) / a["horizon"]
                      for a in acc.values() if a["horizon"] > 0),
                     default=0.0)
    checks.append(Check(
        "time-conservation", worst_idle, 0.0, tol, absolute=True,
        detail="worst negative-idle fraction "
               "(busy+setup+ckpt+restore+lost+down <= horizon)"))

    # goodput identity
    denom = (report.fleet_busy_seconds + report.lost_work_seconds
             + report.checkpoint_seconds + report.restore_seconds)
    goodput = report.fleet_busy_seconds / denom if denom > 0 else 1.0
    checks.append(Check(
        "goodput-identity", report.goodput_fraction, goodput, tol,
        detail="useful / (useful + lost + ckpt + restore)"))
    return checks


def queueing_checks(report, tol: float = QUEUEING_TOL,
                    max_util: float = QUEUEING_MAX_UTIL) -> List[Check]:
    """The M/G/k band check — self-gating where the approximation does
    not apply (heavy traffic, gang-dominated mixes, degenerate traces)."""
    n = len(report.jobs)
    if n < 30:
        return [Check("mgk-queueing-delay", 0.0, 0.0, tol, gated=True,
                      detail=f"only {n} jobs — too few for a stable "
                             "mean-wait estimate")]
    arrivals = sorted(j.arrival_s for j in report.jobs)
    span = arrivals[-1] - arrivals[0]
    if span <= 0:
        return [Check("mgk-queueing-delay", 0.0, 0.0, tol, gated=True,
                      detail="all jobs arrive at once")]
    lam = (n - 1) / span
    gaps = [b - a for a, b in zip(arrivals, arrivals[1:])]
    mean_gap = sum(gaps) / len(gaps)
    var_gap = sum((g - mean_gap) ** 2 for g in gaps) / len(gaps)
    ca2 = var_gap / (mean_gap * mean_gap) if mean_gap > 0 else 1.0
    # service in DEVICE-seconds: a gang of g devices consumes g server-
    # seconds per wall second, and the offered load a = lambda * E[S]
    # must count that work or rho understates true occupancy
    gang_size: Dict[str, int] = {}
    for s in report.slices:
        if s.group:
            gang_size[s.job_id] = max(gang_size.get(s.job_id, 1),
                                      len(s.group))
    services = [j.service_s * gang_size.get(j.job_id, 1)
                for j in report.jobs if j.service_s > 0]
    if not services:
        return [Check("mgk-queueing-delay", 0.0, 0.0, tol, gated=True,
                      detail="no completed service")]
    mean_s = sum(services) / len(services)
    var_s = sum((s - mean_s) ** 2 for s in services) / len(services)
    cs2 = var_s / (mean_s * mean_s) if mean_s > 0 else 0.0
    k = report.num_devices
    gang_frac = len(gang_size) / n
    rho = lam * mean_s / k
    if rho > max_util:
        return [Check("mgk-queueing-delay", 0.0, 0.0, tol, gated=True,
                      detail=f"utilization {rho:.2f} above the "
                             f"{max_util:g} applicability ceiling")]
    if gang_frac > QUEUEING_MAX_GANG_FRACTION:
        return [Check("mgk-queueing-delay", 0.0, 0.0, tol, gated=True,
                      detail=f"{gang_frac * 100:.0f}% gang jobs "
                             f"({len(gang_size)} of {n}) — M/G/k assumes "
                             "single-server jobs")]
    if (ca2 + cs2) / 2 > QUEUEING_MAX_VARIABILITY:
        return [Check("mgk-queueing-delay", 0.0, 0.0, tol, gated=True,
                      detail=f"Ca2={ca2:.3g} Cs2={cs2:.3g} — variability "
                             "beyond the Allen-Cunneen comfort zone")]
    pred = allen_cunneen_wq(lam, mean_s, cs2, k, scv_arrival=ca2)
    sim = report.mean_total_queue_delay_s
    if max(sim, pred) < 0.1 * mean_s:
        return [Check("mgk-queueing-delay", sim, pred, tol, gated=True,
                      detail=f"negligible waiting (Wq < 0.1 E[S] at "
                             f"rho={rho:.3f}) — relative error is noise")]
    return [Check(
        "mgk-queueing-delay", sim, pred, tol, exact=False,
        detail=f"Allen-Cunneen: lambda={lam:.4g}/s E[S]={mean_s:.4g}s "
               f"Ca2={ca2:.3g} Cs2={cs2:.3g} k={k} rho={rho:.3f}")]


def validate_cluster(report, tol: float = CONSERVATION_TOL,
                     queueing_tol: float = QUEUEING_TOL,
                     max_util: float = QUEUEING_MAX_UTIL,
                     fit_lines: Optional[List[str]] = None
                     ) -> ValidationReport:
    """Run every check against one :class:`ClusterReport`."""
    rep = ValidationReport(
        f"{report.trace_name} x {report.policy} x "
        f"{report.num_devices} devices",
        fit_lines=list(fit_lines or []))
    rep.checks.extend(conservation_checks(report, tol=tol))
    rep.checks.extend(queueing_checks(report, tol=queueing_tol,
                                      max_util=max_util))
    return rep
