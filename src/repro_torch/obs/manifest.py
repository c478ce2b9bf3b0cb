"""Run manifests: the comparable, diffable record of one simulation.

A report answers "what happened in this run"; a *manifest* makes two runs
answerable against each other — the DeepProf-style question ("which
phase/unit/metric diverged between these runs?") needs the config knobs,
seeds, summary metrics, stage timings, and time-lapse series captured in
one self-describing JSON document.  Both CLIs grow a ``--manifest PATH``
flag writing one of these; ``python -m repro_torch.obs diff a.json b.json``
(:mod:`repro_torch.obs.diff`) consumes them.

The ``digest`` field is a SHA-256 over the canonicalized config+seeds+
metrics, so "are these runs identical?" is one string compare, and a
regression bisect can fingerprint runs without parsing them.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

#: manifest schema version — bump when field semantics change
SCHEMA = 1


def _canonical(obj: Any) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


@dataclass
class RunManifest:
    """One run's identity + results, as written by ``--manifest``."""

    kind: str                              # "engine" | "cluster"
    label: str                             # workload / "trace x policy"
    config: Dict[str, Any] = field(default_factory=dict)   # CLI knobs
    seeds: Dict[str, int] = field(default_factory=dict)
    metrics: Dict[str, float] = field(default_factory=dict)  # summary()
    stage_seconds: Dict[str, float] = field(default_factory=dict)
    timelapse: Optional[Dict[str, Any]] = None   # TimeLapse.to_doc()

    @property
    def digest(self) -> str:
        """SHA-256 fingerprint of config + seeds + metrics (not wall-clock
        stage timings or the lapse — those vary run to run / host to host
        even when the simulation is bit-identical)."""
        payload = _canonical({"kind": self.kind, "label": self.label,
                              "config": self.config, "seeds": self.seeds,
                              "metrics": self.metrics})
        return hashlib.sha256(payload.encode()).hexdigest()

    def to_doc(self) -> Dict[str, Any]:
        return {"schema": SCHEMA, "kind": self.kind, "label": self.label,
                "digest": self.digest, "config": self.config,
                "seeds": self.seeds, "metrics": self.metrics,
                "stage_seconds": self.stage_seconds,
                "timelapse": self.timelapse}

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_doc(), indent=indent, sort_keys=True)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_doc(cls, doc: Dict[str, Any]) -> "RunManifest":
        schema = doc.get("schema", SCHEMA)
        if schema > SCHEMA:
            raise ValueError(
                f"manifest schema {schema} is newer than supported {SCHEMA}")
        return cls(kind=doc.get("kind", "engine"),
                   label=doc.get("label", ""),
                   config=dict(doc.get("config", {})),
                   seeds=dict(doc.get("seeds", {})),
                   metrics=dict(doc.get("metrics", {})),
                   stage_seconds=dict(doc.get("stage_seconds", {})),
                   timelapse=doc.get("timelapse"))

    @classmethod
    def load(cls, path: str) -> "RunManifest":
        with open(path) as f:
            return cls.from_doc(json.load(f))


def engine_manifest(report, config: Dict[str, Any],
                    seeds: Optional[Dict[str, int]] = None,
                    label: str = "",
                    stage_seconds: Optional[Dict[str, float]] = None,
                    timelapse=None) -> RunManifest:
    """Manifest for one engine run (``report`` is a ``SimReport``)."""
    lapse_doc = timelapse.to_doc() if timelapse is not None else None
    metrics = {k: v for k, v in report.summary().items()
               if isinstance(v, (int, float))}
    return RunManifest("engine", label, config=dict(config),
                       seeds=dict(seeds or {}), metrics=metrics,
                       stage_seconds=dict(stage_seconds or {}),
                       timelapse=lapse_doc)


def cluster_manifest(report, config: Dict[str, Any],
                     seeds: Optional[Dict[str, int]] = None,
                     label: str = "",
                     stage_seconds: Optional[Dict[str, float]] = None,
                     timelapse=None,
                     extra_metrics: Optional[Dict[str, float]] = None
                     ) -> RunManifest:
    """Manifest for one fleet run (``report`` is a ``ClusterReport``).

    ``extra_metrics`` merges additional numeric series into the metric
    map — the cluster CLI feeds ``repro_torch.validate`` residuals through it,
    so manifest diffs and the regression sentinel track conservation
    drift like any other metric.
    """
    lapse_doc = timelapse.to_doc() if timelapse is not None else None
    metrics = {k: v for k, v in report.summary().items()
               if isinstance(v, (int, float)) and not isinstance(v, bool)}
    metrics.update(extra_metrics or {})
    return RunManifest(
        "cluster", label or f"{report.trace_name} x {report.policy}",
        config=dict(config), seeds=dict(seeds or {}), metrics=metrics,
        stage_seconds=dict(stage_seconds or {}), timelapse=lapse_doc)
