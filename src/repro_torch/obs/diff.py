"""Manifest diffing: the regression attributor behind ``repro_torch.obs diff``.

Given two :class:`~repro_torch.obs.manifest.RunManifest` files, report *what*
changed (config knobs), *how much* each metric moved, *which simulator
layer* each moved metric belongs to (engine / memory / topology /
cluster / faults — inferred from the metric name), and *where in time*
the runs diverged (the first / worst time-lapse intervals whose series
disagree).  This is the paper's time-lapse methodology turned into a
regression tool: instead of eyeballing two AerialVision plots, the diff
names the interval and the series that moved.

Exit-code contract (used by the CI smoke step): identical manifests diff
empty; a single-knob change (``--policy fifo`` vs ``sjf``) must surface
that knob under config changes and the affected metrics under deltas.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs.manifest import RunManifest

#: metric-name prefixes/substrings -> owning simulator layer, first match
#: wins (order matters: "exposed_ici_seconds" is topology, not engine)
_LAYER_RULES: Tuple[Tuple[str, str], ...] = (
    ("channel_", "memory"), ("peak_hbm", "memory"), ("spill_", "memory"),
    ("hbm_utilization", "memory"),
    ("link_", "topology"), ("ici_seconds", "topology"),
    ("exposed_ici", "topology"), ("total_ici_bytes", "topology"),
    ("unit_ici", "topology"),
    ("failure", "faults"), ("recover", "faults"), ("checkpoint", "faults"),
    ("restore", "faults"), ("lost_work", "faults"), ("reshape", "faults"),
    ("goodput", "faults"),
    ("queue", "cluster"), ("latency", "cluster"), ("hol_", "cluster"),
    ("makespan", "cluster"), ("fleet_", "cluster"), ("cache_", "cluster"),
    ("utilization", "cluster"), ("num_devices", "cluster"),
    ("num_jobs", "cluster"), ("preempt", "cluster"),
    ("cold_start", "cluster"),
)


def metric_layer(name: str) -> str:
    """Which simulator layer owns a summary metric, by naming convention."""
    for needle, layer in _LAYER_RULES:
        if needle in name:
            return layer
    return "engine"


def _rel(a: float, b: float) -> float:
    """Relative delta; ±inf for a zero baseline (0 -> nonzero)."""
    if a == 0.0:
        return 0.0 if b == 0.0 else math.copysign(math.inf, b)
    return (b - a) / abs(a)


def _fmt_rel(rel: float) -> str:
    return f"{rel:+.2%}" if math.isfinite(rel) else "was 0"


@dataclass
class MetricDelta:
    """One summary metric that moved between the two runs."""

    name: str
    a: float
    b: float
    layer: str

    @property
    def abs_delta(self) -> float:
        return self.b - self.a

    @property
    def rel_delta(self) -> float:
        """(b - a) / |a|; ±inf when the baseline is exactly zero."""
        return _rel(self.a, self.b)

    def render(self) -> str:
        return (f"{self.name:<40s} {self.a:>14.6g} -> {self.b:<14.6g} "
                f"({_fmt_rel(self.rel_delta)}) [{self.layer}]")


@dataclass
class LapseDivergence:
    """One time-lapse interval/series where the two runs disagree."""

    index: int
    t0: float
    series: str                  # e.g. "busy_mxu", "queue_depth"
    a: float
    b: float

    @property
    def rel_delta(self) -> float:
        return _rel(self.a, self.b)

    def render(self) -> str:
        return (f"interval {self.index:>4d} @ {self.t0:.4g}s  "
                f"{self.series:<24s} {self.a:.6g} -> {self.b:.6g} "
                f"({_fmt_rel(self.rel_delta)})")


@dataclass
class ManifestDiff:
    """Structured comparison of two run manifests."""

    a_label: str
    b_label: str
    identical_digest: bool
    kind_mismatch: Optional[Tuple[str, str]] = None
    config_changes: Dict[str, Tuple[Any, Any]] = field(default_factory=dict)
    seed_changes: Dict[str, Tuple[Any, Any]] = field(default_factory=dict)
    metric_deltas: List[MetricDelta] = field(default_factory=list)
    lapse_divergences: List[LapseDivergence] = field(default_factory=list)
    #: set when the two lapses had different interval counts and were
    #: resampled to the coarser grid before comparison
    lapse_note: str = ""

    @property
    def empty(self) -> bool:
        """True when the runs are indistinguishable (the self-diff case)."""
        return (self.kind_mismatch is None and not self.config_changes
                and not self.seed_changes and not self.metric_deltas
                and not self.lapse_divergences)

    def layers(self) -> Dict[str, int]:
        """Moved-metric count per simulator layer (the attribution)."""
        out: Dict[str, int] = {}
        for d in self.metric_deltas:
            out[d.layer] = out.get(d.layer, 0) + 1
        return out

    def to_doc(self) -> Dict[str, Any]:
        return {
            "a": self.a_label, "b": self.b_label, "empty": self.empty,
            "identical_digest": self.identical_digest,
            "kind_mismatch": list(self.kind_mismatch)
            if self.kind_mismatch else None,
            "config_changes": {k: list(v)
                               for k, v in self.config_changes.items()},
            "seed_changes": {k: list(v)
                             for k, v in self.seed_changes.items()},
            "layers": self.layers(),
            "metric_deltas": [{
                "name": d.name, "a": d.a, "b": d.b, "layer": d.layer,
                "abs_delta": d.abs_delta,
                # None, not Infinity: keep the doc strict-JSON
                "rel_delta": d.rel_delta
                if math.isfinite(d.rel_delta) else None,
            } for d in self.metric_deltas],
            "lapse_divergences": [{
                "index": d.index, "t0": d.t0, "series": d.series,
                "a": d.a, "b": d.b,
                "rel_delta": d.rel_delta
                if math.isfinite(d.rel_delta) else None,
            } for d in self.lapse_divergences],
            "lapse_note": self.lapse_note or None,
        }

    def render(self, top: int = 12) -> str:
        lines = [f"diff: {self.a_label!r} vs {self.b_label!r}"]
        if self.kind_mismatch:
            lines.append(f"  KIND MISMATCH: {self.kind_mismatch[0]} vs "
                         f"{self.kind_mismatch[1]} — not comparable")
            return "\n".join(lines)
        if self.empty:
            lines.append("  identical: no config, seed, metric, or "
                         "time-lapse differences")
            if self.lapse_note:
                lines.append(f"  note: {self.lapse_note}")
            return "\n".join(lines)
        if self.config_changes:
            lines.append("  config changes:")
            for k, (va, vb) in sorted(self.config_changes.items()):
                lines.append(f"    {k:<24s} {va!r} -> {vb!r}")
        if self.seed_changes:
            lines.append("  seed changes:")
            for k, (va, vb) in sorted(self.seed_changes.items()):
                lines.append(f"    {k:<24s} {va!r} -> {vb!r}")
        if self.metric_deltas:
            layers = ", ".join(f"{l}: {n}"
                               for l, n in sorted(self.layers().items()))
            lines.append(f"  metric deltas ({len(self.metric_deltas)} "
                         f"moved; by layer — {layers}):")
            for d in self.metric_deltas[:top]:
                lines.append("    " + d.render())
            if len(self.metric_deltas) > top:
                lines.append(f"    ... {len(self.metric_deltas) - top} "
                             f"more (use --top)")
        if self.lapse_note:
            lines.append(f"  note: {self.lapse_note}")
        if self.lapse_divergences:
            lines.append(f"  time-lapse divergences "
                         f"({len(self.lapse_divergences)} intervals; "
                         f"first/worst shown):")
            for d in self.lapse_divergences[:top]:
                lines.append("    " + d.render())
            if len(self.lapse_divergences) > top:
                lines.append(f"    ... {len(self.lapse_divergences) - top} "
                             f"more")
        return "\n".join(lines)


def resample_lapse_doc(doc: Dict[str, Any], n: int) -> Dict[str, Any]:
    """Rebucket a TimeLapse doc onto ``n`` equal intervals of the same
    span.  Additive series (busy/channel/link/camping/ops) distribute by
    proportional overlap — exactly the smearing ``TimeLapse.from_report``
    uses, so resampling a fine grid reproduces the coarse grid up to FP;
    ``queue_depth`` (a mean) is width-weighted.  Used by
    :func:`diff_manifests` when two manifests were produced with
    different ``--lapse-intervals`` counts.
    """
    intervals = doc.get("intervals", [])
    if not intervals or n <= 0 or len(intervals) == n:
        return doc
    end = max(intervals[-1].get("t1", 0.0), 1e-12)
    width = end / n
    out = [{"t0": i * width, "t1": (i + 1) * width, "busy_seconds": {},
            "channel_busy": [], "link_busy": {}, "camping_seconds": 0.0,
            "ops_retired": 0.0, "queue_depth": 0.0} for i in range(n)]
    for iv in intervals:
        t0, t1 = iv.get("t0", 0.0), iv.get("t1", 0.0)
        w = t1 - t0
        if w <= 0:
            continue
        b0 = min(int(t0 / width), n - 1)
        b1 = min(int(t1 / width), n - 1)
        for bi in range(b0, b1 + 1):
            o = out[bi]
            ov = max(min(t1, o["t1"]) - max(t0, o["t0"]), 0.0)
            frac = ov / w
            if frac <= 0 and b0 != b1:
                continue
            if b0 == b1:
                frac, ov = 1.0, w    # guard FP loss: fits one bucket
            for k, v in iv.get("busy_seconds", {}).items():
                o["busy_seconds"][k] = o["busy_seconds"].get(k, 0.0) \
                    + v * frac
            cb = iv.get("channel_busy", [])
            if cb:
                if len(o["channel_busy"]) < len(cb):
                    o["channel_busy"].extend(
                        [0.0] * (len(cb) - len(o["channel_busy"])))
                for c, v in enumerate(cb):
                    o["channel_busy"][c] += v * frac
            for l, v in iv.get("link_busy", {}).items():
                o["link_busy"][l] = o["link_busy"].get(l, 0.0) + v * frac
            o["camping_seconds"] += iv.get("camping_seconds", 0.0) * frac
            o["ops_retired"] += iv.get("ops_retired", 0.0) * frac
            o["queue_depth"] += iv.get("queue_depth", 0.0) * ov / width
    for o in out:
        cb = o["channel_busy"]
        mean = sum(cb) / len(cb) if cb else 0.0
        o["channel_imbalance"] = max(cb) / mean if mean > 0 else 1.0
    return {**doc, "num_intervals": n, "intervals": out}


def _lapse_series(doc: Dict[str, Any]) -> Dict[int, Dict[str, float]]:
    """Flatten a TimeLapse doc into {interval: {series: value}}."""
    out: Dict[int, Dict[str, float]] = {}
    for i, iv in enumerate(doc.get("intervals", [])):
        row: Dict[str, float] = {}
        for k, v in iv.get("busy_seconds", {}).items():
            row[f"busy_{k}"] = v
        for c, v in enumerate(iv.get("channel_busy", [])):
            row[f"channel_{c}"] = v
        for l, v in iv.get("link_busy", {}).items():
            row[f"link_{l}"] = v
        if iv.get("camping_seconds"):
            row["camping_seconds"] = iv["camping_seconds"]
        if iv.get("queue_depth"):
            row["queue_depth"] = iv["queue_depth"]
        out[i] = row
    return out


def diff_manifests(a: RunManifest, b: RunManifest,
                   rel_tol: float = 1e-9,
                   abs_tol: float = 1e-12) -> ManifestDiff:
    """Compare two manifests; values within tolerance are *not* reported.

    ``rel_tol`` is deliberately tiny by default: the simulators are
    deterministic, so a same-seed same-knob pair must diff empty without
    any forgiveness window, while FP-noise-level differences between
    hosts can be absorbed by raising it (``--rel-tol``).
    """
    d = ManifestDiff(a.label or "a", b.label or "b",
                     identical_digest=(a.digest == b.digest))
    if a.kind != b.kind:
        d.kind_mismatch = (a.kind, b.kind)
        return d

    def _close(va: float, vb: float) -> bool:
        return abs(vb - va) <= max(abs_tol, rel_tol * max(abs(va), abs(vb)))

    for k in sorted(set(a.config) | set(b.config)):
        va, vb = a.config.get(k), b.config.get(k)
        if va != vb:
            d.config_changes[k] = (va, vb)
    for k in sorted(set(a.seeds) | set(b.seeds)):
        va, vb = a.seeds.get(k), b.seeds.get(k)
        if va != vb:
            d.seed_changes[k] = (va, vb)

    for k in sorted(set(a.metrics) | set(b.metrics)):
        va, vb = a.metrics.get(k, 0.0), b.metrics.get(k, 0.0)
        if not _close(va, vb):
            d.metric_deltas.append(MetricDelta(k, va, vb, metric_layer(k)))
    d.metric_deltas.sort(key=lambda m: abs(m.rel_delta), reverse=True)

    if a.timelapse and b.timelapse:
        la, lb = a.timelapse, b.timelapse
        na = len(la.get("intervals", []))
        nb = len(lb.get("intervals", []))
        if na != nb and na > 0 and nb > 0:
            # different --lapse-intervals counts: degrade gracefully by
            # resampling both onto the coarser grid instead of failing
            # the interval-by-interval compare
            n = min(na, nb)
            la, lb = resample_lapse_doc(la, n), resample_lapse_doc(lb, n)
            d.lapse_note = (f"time-lapse grids differ ({na} vs {nb} "
                            f"intervals); both resampled to the coarser "
                            f"{n}-interval grid before comparison")
        sa, sb = _lapse_series(la), _lapse_series(lb)
        for i in sorted(set(sa) | set(sb)):
            ra, rb = sa.get(i, {}), sb.get(i, {})
            t0 = (la.get("intervals", [{}] * (i + 1))[i]
                  .get("t0", 0.0)) if i < len(
                la.get("intervals", [])) else 0.0
            for series in sorted(set(ra) | set(rb)):
                va, vb = ra.get(series, 0.0), rb.get(series, 0.0)
                if not _close(va, vb):
                    d.lapse_divergences.append(
                        LapseDivergence(i, t0, series, va, vb))
        d.lapse_divergences.sort(
            key=lambda x: (abs(x.rel_delta), x.index), reverse=True)
    return d
