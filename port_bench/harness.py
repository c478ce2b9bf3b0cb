"""The benchmark's harness: finds a cell's files by the names in
``BENCHMARK.json``, runs its loop, reads its per-layer metrics and makes
the result's line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name:

* ``configs/<config>.json`` (the path the manifest's ``file`` gives): the
  configuration as it is run, in the published config's keys;
* ``traffic/<traffic>.json``: the mix's parameters, whose ``loop`` names
  the loop in ``loops/<loop>.py`` that runs it;
* ``limits/<workload>.json``: each number the cell's comparison holds, with
  its limit and the readings the limit was set from;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``,
  returning a number or None where the run has nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

#: top-level module names that no run may load: JAX, and the JAX package
#: (the port's name begins with it, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Run:
    """One run of one cell: its inputs, and what its loop measured."""
    root: Path
    bench: Path
    manifest: dict
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float
    setup_s: Optional[float] = None
    e2e: Dict[str, float] = field(default_factory=dict)
    records: Dict[str, Any] = field(default_factory=dict)
    checks: Dict[str, Dict[str, float]] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak: int = 0
    tracer: Any = None

    def check(self, name: str, value: float) -> None:
        """Hold ``value`` to the cell's limit for ``name``."""
        self.checks[name] = {"value": value, "limit": self.limits[name]["limit"]}

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"]
            for c in self.checks.values())


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The module in ``path``, loaded under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _by_name(items: List[dict], name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def prepare(root: Path, bench: Path, workload: str, seed: int, seconds: float,
            trace: bool, device: str, t0: float) -> Run:
    manifest = load_json(root / "BENCHMARK.json")
    cell = _by_name(manifest["workloads"], workload, "workload")
    conf = _by_name(manifest["configs"], cell["config"], "configuration")
    return Run(root=root, bench=bench, manifest=manifest, workload=cell,
               config=load_json(root / conf["file"]),
               traffic=load_json(bench / "traffic" / f"{cell['traffic']}.json"),
               limits=load_json(bench / "limits" / f"{workload}.json"),
               seed=seed, seconds=seconds, trace=trace, device=device, t0=t0)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metrics_of(run: Run) -> Dict[str, Dict[str, Any]]:
    """The cell's end-to-end metrics (untraced) or per-layer ones (traced),
    each as {"value", "unit"}."""
    cell = run.workload["name"]
    out = {}
    if not run.trace:
        for m in run.manifest["end_to_end"]:
            if _reports(m, cell):
                if m["name"] not in run.e2e:
                    raise RuntimeError(f"the loop measured no {m['name']} in {cell}")
                out[m["name"]] = {"value": run.e2e[m["name"]], "unit": m["unit"]}
        return out
    e2e = {m["name"] for m in run.manifest["end_to_end"] if _reports(m, cell)}
    for m in run.manifest["per_layer"]:
        listed = m.get("workloads")
        if (cell not in listed) if listed is not None else (m["moves"] not in e2e):
            continue
        reader = load_module(run.bench / "metrics" / f"{m['name']}.py",
                         "port_bench_metric_" + m["name"].replace(".", "_").replace("-", "_"))
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def result(run: Run, device_info: dict) -> dict:
    out = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics_of(run), "device": device_info}
    if run.trace and run.tracer is not None and run.tracer.trace is not None:
        out["breakdown"] = run.tracer.trace.breakdown()
    out["checks"] = run.checks
    return out


def device_info(run: Run, chips: int) -> dict:
    import torch
    info = {"platform": "gpu" if run.device == "cuda" else run.device,
            "kind": torch.cuda.get_device_name(0) if run.device == "cuda" else "cpu",
            "count": chips, "memory_peak_bytes": run.memory_peak}
    if run.trace and run.tracer is not None and run.tracer.trace is not None:
        info["busy_s"] = run.tracer.trace.busy_s()
        info["window_s"] = run.tracer.trace.window_s()
    if run.device == "cuda":
        info["power_limit"] = _power_limit()
    return info


def _power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it (a card below its
    700 W runs slower under load), or why it could not be read."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read: {e}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else f"not read: {out.stderr.strip()[:100]}"


def run_cell(root: Path, bench: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: str, t0: Optional[float] = None) -> Run:
    """Run one cell's loop (``loops/<loop>.py``'s ``run``) and return the
    :class:`Run` it filled."""
    run = prepare(root, bench, workload, seed, seconds, trace, device,
                  time.perf_counter() if t0 is None else t0)
    loop = load_module(bench / "loops" / f"{run.traffic['loop']}.py",
                   "port_bench_loop_" + run.traffic["loop"])
    loop.run(run)
    return run


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100)."""
    vals = sorted(values)
    return vals[max(0, math.ceil(q / 100 * len(vals)) - 1)]


def log(run: Run, what: str) -> None:
    """A progress line on standard error, with the seconds since the start."""
    print(f"[{time.perf_counter() - run.t0:8.2f} s] {what}", file=sys.stderr, flush=True)


def print_checks(run: Run, stream=sys.stderr) -> None:
    for name, c in run.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=stream)
