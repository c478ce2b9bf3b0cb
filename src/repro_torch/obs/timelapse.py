"""AerialVision-style time-lapse: fixed-interval time series of a run.

The paper's AerialVision tool (§IV) plots per-interval IPC and DRAM
efficiency over a kernel's lifetime because aggregate counters hide the
"many varying phases" inside one cuDNN call, and its partition-camping
finding (§V) is only visible as a *per-interval* DRAM-bank imbalance.
This module is that view for the TPU stack, derived entirely from
timelines the simulators already produce — no second simulation:

* :meth:`TimeLapse.from_report` — per-unit occupancy, per-HBM-channel
  busy time + channel-imbalance ("camping") index, and per-ICI-link
  utilization for one engine run;
* :meth:`TimeLapse.from_cluster` — per-device occupancy and waiting-job
  queue depth for one fleet run.

Conservation property (tested, the acceptance bar): summing any busy
quantity over all intervals reproduces the corresponding ``SimReport``
/ ``ClusterReport`` total within 1%, because each timeline entry is
smeared over its true span exactly as :mod:`repro_torch.analysis.intervals`
does — the per-channel seconds reconstruct ``MemoryModel.account``
(``channel_bytes[c] / hbm_channel_bw * scale``) and per-link seconds
come from the entry's recorded ``link_seconds``.

Exporters: :meth:`to_json` / :meth:`to_csv` for notebooks,
:meth:`heat_strips` for terminals (the shared :data:`~repro_torch.obs.export.
SHADES` ramp), :meth:`to_chrome_events` for composed trace files, and
:meth:`to_doc` / :meth:`from_doc` for embedding in run manifests.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.obs.export import SHADES, counter_event, shade, thread_meta

#: engine functional units shown per interval (matches analysis.UNITS)
UNITS = ("mxu", "vpu", "hbm", "ici")

#: chrome-trace counter-track tids for time-lapse series (pid 0 —
#: simulated time — after the fleet queue/fabric tracks at 1000/1001)
_LAPSE_TID = 1100


@dataclass
class LapseInterval:
    """One fixed-width time bucket of a time-lapse series.

    ``busy_seconds`` keys are functional units for engine lapses and
    device ids for cluster lapses; the channel/link/camping fields are
    engine-only and stay empty on cluster lapses.
    """

    index: int
    t0: float
    t1: float
    busy_seconds: Dict[str, float] = field(default_factory=dict)
    #: per-HBM-channel transfer busy seconds inside this bucket
    channel_busy: List[float] = field(default_factory=list)
    #: per-ICI-link busy seconds ("ici:<src>-<dst>" keys) inside this bucket
    link_busy: Dict[str, float] = field(default_factory=dict)
    #: busy seconds contributed by camping-class ops (gather/scatter/...)
    camping_seconds: float = 0.0
    #: scale-weighted HLO ops (engine) or job-slice count (cluster) here
    ops_retired: float = 0.0
    #: mean waiting-job queue depth over this bucket (cluster lapses)
    queue_depth: float = 0.0

    @property
    def width(self) -> float:
        return self.t1 - self.t0

    def occupancy(self, key: str) -> float:
        """Busy fraction for one unit/device, clamped to [0, 1] for display
        (trip-count-scaled regions can exceed the bucket width)."""
        if self.width <= 0:
            return 0.0
        return min(self.busy_seconds.get(key, 0.0) / self.width, 1.0)

    @property
    def channel_imbalance(self) -> float:
        """Busiest-channel / mean busy seconds in this bucket — the
        per-interval partition-camping index (1.0 = balanced).  Camped
        intervals read well above the module-level CAMPED_THRESHOLD."""
        if not self.channel_busy:
            return 1.0
        mean = sum(self.channel_busy) / len(self.channel_busy)
        if mean <= 0:
            return 1.0
        return max(self.channel_busy) / mean

    def to_doc(self) -> Dict[str, Any]:
        return {"t0": self.t0, "t1": self.t1,
                "busy_seconds": dict(self.busy_seconds),
                "channel_busy": list(self.channel_busy),
                "link_busy": dict(self.link_busy),
                "channel_imbalance": self.channel_imbalance,
                "camping_seconds": self.camping_seconds,
                "ops_retired": self.ops_retired,
                "queue_depth": self.queue_depth}


#: per-interval channel-imbalance above this marks the bucket as camped —
#: hoisted to the shared pathology-threshold config so the doctor's camping
#: verdicts always agree with the "!" markers rendered here
from repro_torch.obs.thresholds import CAMPED_THRESHOLD  # noqa: E402


@dataclass
class TimeLapse:
    """A fixed-interval time series over one run (engine or cluster)."""

    kind: str                       # "engine" | "cluster"
    label: str                      # workload / trace x policy name
    intervals: List[LapseInterval]
    #: the reference totals this lapse must reconcile against
    reference: Dict[str, float] = field(default_factory=dict)

    @property
    def end_time(self) -> float:
        return self.intervals[-1].t1 if self.intervals else 0.0

    @property
    def keys(self) -> List[str]:
        """Every busy-series key present (units or device ids), sorted —
        engine lapses keep the canonical UNITS order."""
        seen = set()
        for iv in self.intervals:
            seen.update(iv.busy_seconds)
        if self.kind == "engine":
            return [u for u in UNITS if u in seen] + \
                sorted(seen - set(UNITS))
        return sorted(seen)

    def camped_intervals(self) -> List[int]:
        """Indices whose channel-imbalance index exceeds the camping bar."""
        return [iv.index for iv in self.intervals
                if iv.channel_busy and sum(iv.channel_busy) > 0
                and iv.channel_imbalance > CAMPED_THRESHOLD]

    # -- conservation ---------------------------------------------------
    def totals(self) -> Dict[str, float]:
        """Sums over all intervals, keyed to match :attr:`reference`."""
        out: Dict[str, float] = {}
        for iv in self.intervals:
            for k, v in iv.busy_seconds.items():
                out[f"busy_{k}_seconds"] = out.get(f"busy_{k}_seconds",
                                                   0.0) + v
            for c, v in enumerate(iv.channel_busy):
                out[f"channel_{c}_seconds"] = out.get(
                    f"channel_{c}_seconds", 0.0) + v
            for l, v in iv.link_busy.items():
                out[f"link_{l}_seconds"] = out.get(f"link_{l}_seconds",
                                                   0.0) + v
        return out

    def reconcile(self) -> float:
        """Max relative error between interval sums and reference totals.

        The subsystem's acceptance bar: < 1% on full (non-windowed) runs.
        """
        got = self.totals()
        worst = 0.0
        for key, expect in self.reference.items():
            if expect <= 0:
                continue
            worst = max(worst, abs(got.get(key, 0.0) - expect) / expect)
        return worst

    # -- constructors ---------------------------------------------------
    @classmethod
    def from_report(cls, report, num_intervals: int = 64,
                    label: str = "") -> "TimeLapse":
        """Time-lapse of one engine :class:`~repro_torch.core.engine.SimReport`.

        Smears each timeline entry over its wall-clock span exactly as
        :func:`repro_torch.analysis.intervals.profile_intervals` does, but
        additionally splits the busy time by HBM channel (reconstructing
        ``MemoryModel.account``'s ``bytes/bw*scale``) and by ICI link
        (the entry's recorded ``link_seconds``).
        """
        from repro_torch.memory.channels import is_camping_op
        if num_intervals <= 0:
            raise ValueError(
                f"num_intervals must be positive, got {num_intervals}")
        n_ch = len(report.channel_busy_seconds)
        ref = {f"busy_{u}_seconds": report.unit_seconds.get(u, 0.0)
               for u in UNITS}
        ref.update({f"channel_{c}_seconds": s
                    for c, s in enumerate(report.channel_busy_seconds)})
        ref.update({f"link_{l}_seconds": s
                    for l, s in report.link_busy_seconds.items()})
        if not report.timeline:
            return cls("engine", label, [], ref)
        end = max(e.start + e.duration * e.scale for e in report.timeline)
        end = max(end, report.total_seconds, 1e-12)
        width = end / num_intervals
        ivs = [LapseInterval(i, i * width, (i + 1) * width,
                             channel_busy=[0.0] * n_ch)
               for i in range(num_intervals)]
        bw = report.hw.hbm_channel_bw

        for e in report.timeline:
            span = e.duration * e.scale
            camping = is_camping_op(e.opcode, e.name)
            if span <= 0:
                bi = min(int(e.start / width), num_intervals - 1)
                ivs[bi].ops_retired += e.scale
                continue
            t0, t1 = e.start, e.start + span
            b0 = min(int(t0 / width), num_intervals - 1)
            b1 = min(int(t1 / width), num_intervals - 1)
            link_seconds = getattr(e, "link_seconds", None)
            for bi in range(b0, b1 + 1):
                iv = ivs[bi]
                frac = max(min(t1, iv.t1) - max(t0, iv.t0), 0.0) / span
                if frac <= 0 and not (b0 == b1):
                    continue
                if b0 == b1:
                    frac = 1.0   # guard FP loss: entry fits one bucket
                iv.busy_seconds[e.unit] = (iv.busy_seconds.get(e.unit, 0.0)
                                           + span * frac)
                iv.ops_retired += e.scale * frac
                if camping:
                    iv.camping_seconds += span * frac
                if e.channel_bytes and bw > 0:
                    for c, v in enumerate(e.channel_bytes):
                        iv.channel_busy[c] += v / bw * e.scale * frac
                if link_seconds:
                    for l, sec in link_seconds.items():
                        iv.link_busy[l] = (iv.link_busy.get(l, 0.0)
                                           + sec * e.scale * frac)
        return cls("engine", label, ivs, ref)

    @classmethod
    def from_cluster(cls, report, num_intervals: int = 64,
                     label: str = "") -> "TimeLapse":
        """Time-lapse of one fleet :class:`~repro_torch.cluster.events.
        ClusterReport`: per-device occupancy + waiting-job queue depth."""
        from repro_torch.cluster.export import _queue_depth_events
        if num_intervals <= 0:
            raise ValueError(
                f"num_intervals must be positive, got {num_intervals}")
        label = label or f"{report.trace_name} x {report.policy}"
        ref = {f"busy_{d}_seconds": s
               for d, s in report.per_device_busy.items()}
        if not report.slices or report.makespan_s <= 0:
            return cls("cluster", label, [], ref)
        end = max(report.makespan_s,
                  max(s.t1 for s in report.slices), 1e-12)
        width = end / num_intervals
        ivs = [LapseInterval(i, i * width, (i + 1) * width)
               for i in range(num_intervals)]

        for s in report.slices:
            # only "run" slices count toward per_device_busy; setup/ckpt/
            # restore kinds are accounted separately by time_accounting()
            if s.kind != "run":
                continue
            span = s.t1 - s.t0
            if span <= 0:
                continue
            b0 = min(int(s.t0 / width), num_intervals - 1)
            b1 = min(int(s.t1 / width), num_intervals - 1)
            for bi in range(b0, b1 + 1):
                iv = ivs[bi]
                frac = max(min(s.t1, iv.t1) - max(s.t0, iv.t0), 0.0) / span
                if frac <= 0 and not (b0 == b1):
                    continue
                if b0 == b1:
                    frac = 1.0
                iv.busy_seconds[s.device_id] = (
                    iv.busy_seconds.get(s.device_id, 0.0) + span * frac)
                iv.ops_retired += frac

        # queue depth: integrate the (+1/-1) waiting deltas per bucket
        deltas = _queue_depth_events(report)
        depth, di = 0, 0
        for iv in ivs:
            area = 0.0
            t = iv.t0
            while di < len(deltas) and deltas[di][0] < iv.t1:
                dt_ev = max(deltas[di][0], iv.t0)
                area += depth * (dt_ev - t)
                depth += deltas[di][1]
                t = dt_ev
                di += 1
            area += depth * (iv.t1 - t)
            iv.queue_depth = area / iv.width if iv.width > 0 else 0.0
        return cls("cluster", label, ivs, ref)

    # -- exporters ------------------------------------------------------
    def to_doc(self) -> Dict[str, Any]:
        """Plain-dict form for manifests (:meth:`from_doc` round-trips)."""
        return {"kind": self.kind, "label": self.label,
                "num_intervals": len(self.intervals),
                "end_time": self.end_time,
                "reconcile_max_rel_error": self.reconcile(),
                "camped_intervals": self.camped_intervals(),
                "reference": dict(self.reference),
                "intervals": [iv.to_doc() for iv in self.intervals]}

    @classmethod
    def from_doc(cls, doc: Dict[str, Any]) -> "TimeLapse":
        ivs = [LapseInterval(
            i, d["t0"], d["t1"],
            busy_seconds=dict(d.get("busy_seconds", {})),
            channel_busy=list(d.get("channel_busy", [])),
            link_busy=dict(d.get("link_busy", {})),
            camping_seconds=d.get("camping_seconds", 0.0),
            ops_retired=d.get("ops_retired", 0.0),
            queue_depth=d.get("queue_depth", 0.0))
            for i, d in enumerate(doc.get("intervals", []))]
        return cls(doc.get("kind", "engine"), doc.get("label", ""), ivs,
                   dict(doc.get("reference", {})))

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_doc(), indent=indent)

    def to_csv(self) -> str:
        """One row per interval; channel/link series as flat columns."""
        n_ch = max((len(iv.channel_busy) for iv in self.intervals),
                   default=0)
        links = sorted({l for iv in self.intervals for l in iv.link_busy})
        keys = self.keys
        cols = (["index", "t0", "t1"]
                + [f"busy_{k}_s" for k in keys]
                + [f"channel_{c}_s" for c in range(n_ch)]
                + ["channel_imbalance", "camping_s"]
                + [f"{l}_s" for l in links]
                + ["ops_retired", "queue_depth"])
        lines = [",".join(cols)]
        for iv in self.intervals:
            row = ([str(iv.index), f"{iv.t0:.9g}", f"{iv.t1:.9g}"]
                   + [f"{iv.busy_seconds.get(k, 0.0):.9g}" for k in keys]
                   + [f"{iv.channel_busy[c]:.9g}" if c < len(iv.channel_busy)
                      else "0" for c in range(n_ch)]
                   + [f"{iv.channel_imbalance:.4g}",
                      f"{iv.camping_seconds:.9g}"]
                   + [f"{iv.link_busy.get(l, 0.0):.9g}" for l in links]
                   + [f"{iv.ops_retired:.9g}", f"{iv.queue_depth:.4g}"])
            lines.append(",".join(row))
        return "\n".join(lines)

    def heat_strips(self, width: int = 72) -> str:
        """Terminal heat-strip rendering, one shaded row per series.

        Engine lapses add a ``camp`` row (per-interval channel-imbalance,
        ``!`` above the camped threshold) — the terminal analogue of the
        paper's per-interval DRAM-efficiency dip under partition camping.
        """
        if not self.intervals:
            return "(empty time-lapse)"
        n = len(self.intervals)
        stride = max(-(-n // width), 1)
        cols = list(range(0, n, stride))

        def mean_over(fn) -> List[float]:
            out = []
            for i in cols:
                window = self.intervals[i:i + stride]
                out.append(sum(fn(iv) for iv in window) / len(window))
            return out

        pad = max((len(k) for k in self.keys), default=4)
        pad = max(pad, 5)
        lines = []
        for key in self.keys:
            vals = mean_over(lambda iv, k=key: iv.occupancy(k))
            lines.append(f"{key:>{pad}s} |"
                         f"{''.join(shade(v) for v in vals)}|")
        if any(iv.channel_busy for iv in self.intervals):
            camp = mean_over(lambda iv: iv.channel_imbalance)
            cells = "".join("!" if v > CAMPED_THRESHOLD
                            else shade((v - 1.0) / max(CAMPED_THRESHOLD, 1))
                            for v in camp)
            lines.append(f"{'camp':>{pad}s} |{cells}|")
        if self.kind == "cluster":
            q = mean_over(lambda iv: iv.queue_depth)
            strip = "".join("*" if v > 9 else (str(int(v)) if v >= 1
                                               else ".") for v in q)
            lines.append(f"{'queue':>{pad}s} |{strip}|")
        lines.append(f"{'':>{pad}s}  0s {'-' * max(len(cols) - 14, 4)} "
                     f"{self.end_time:.3e}s")
        if any(iv.channel_busy for iv in self.intervals):
            lines.append(f"{'':>{pad}s}  camp row: channel-imbalance "
                         f"(!: camped, index > {CAMPED_THRESHOLD})")
        return "\n".join(lines)

    def to_chrome_events(self, pid: int = 0) -> List[dict]:
        """Counter tracks (``ph: C``) composing with op/fleet/span tracks."""
        if not self.intervals:
            return []
        events = [thread_meta("timelapse", tid=_LAPSE_TID, pid=pid)]
        for iv in self.intervals:
            events.append(counter_event(
                "lapse_occupancy", "timelapse", iv.t0,
                {k: round(iv.occupancy(k), 4) for k in iv.busy_seconds},
                pid=pid, tid=_LAPSE_TID))
            if iv.channel_busy:
                events.append(counter_event(
                    "lapse_channel_imbalance", "timelapse", iv.t0,
                    {"index": round(iv.channel_imbalance, 4)},
                    pid=pid, tid=_LAPSE_TID))
            if self.kind == "cluster":
                events.append(counter_event(
                    "lapse_queue_depth", "timelapse", iv.t0,
                    {"jobs_waiting": round(iv.queue_depth, 3)},
                    pid=pid, tid=_LAPSE_TID))
        return events
