"""CLI: diff manifests, diagnose runs, and gate CI on a baseline.

    PYTHONPATH=src python -m repro_torch.obs diff a.json b.json
    PYTHONPATH=src python -m repro_torch.obs doctor              # camping demo
    PYTHONPATH=src python -m repro_torch.obs doctor clean --expect-clean
    PYTHONPATH=src python -m repro_torch.obs doctor lenet        # capture on cuda
    PYTHONPATH=src python -m repro_torch.obs doctor lenet --device cpu
    PYTHONPATH=src python -m repro_torch.obs sentinel baseline.json fresh.json

Exit codes (relied on by the CI smoke steps):

* 0 — clean (identical manifests / zero-or-expected findings / sentinel
  within tolerance);
* 3 — divergence (diff found changes; sentinel found a regression;
  ``--expect-top``/``--expect-clean`` mismatched);
* 2 — usage or load error (missing file, malformed manifest,
  engine-vs-cluster kind mismatch, unknown workload);
* 1 — an architecture workload without a GPU and without ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys

#: built-in demo workloads `doctor` can run without a capture (no device)
DEMO_WORKLOADS = ("camping", "clean", "no-overlap")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Observability toolbox for repro_torch run artifacts.")
    sub = p.add_subparsers(dest="command", required=True)

    d = sub.add_parser(
        "diff", help="compare two --manifest JSONs and attribute "
                     "which layer/metric/interval diverged")
    d.add_argument("a", help="baseline manifest JSON path")
    d.add_argument("b", help="candidate manifest JSON path")
    d.add_argument("--rel-tol", type=float, default=1e-9,
                   help="relative tolerance below which a metric delta "
                        "is noise (default 1e-9: deterministic sims "
                        "must match exactly)")
    d.add_argument("--top", type=int, default=12,
                   help="rows shown per section in the text report")
    d.add_argument("--json", action="store_true",
                   help="emit the structured diff document instead of text")

    doc = sub.add_parser(
        "doctor", help="diagnose a run: ranked findings with "
                       "counterfactual recoverable_seconds")
    doc.add_argument("workload", nargs="?", default="camping",
                     help="built-in demo (camping | clean | no-overlap) "
                          "or a registered architecture id to capture "
                          "(e.g. lenet; captured on --device). Default: camping")
    doc.add_argument("--hw", default="tpu-v5e",
                     help="chip spec (tpu-v5e|tpu-v5p)")
    doc.add_argument("--device", default=None,
                     help="torch device of an architecture capture's fake "
                          "tensors (default: cuda; fails without a GPU)")
    doc.add_argument("--seq-len", type=int, default=32,
                     help="capture seq len for architecture workloads")
    doc.add_argument("--batch", type=int, default=8,
                     help="capture global batch for architecture workloads")
    doc.add_argument("--lapse-intervals", type=int, default=32,
                     help="time-lapse grid the findings localize on")
    doc.add_argument("--json", metavar="PATH",
                     help="write the DoctorReport JSON here ('-' stdout)")
    doc.add_argument("--chrome-trace", metavar="PATH",
                     help="write a chrome trace with the doctor "
                          "annotation overlay here ('-' for stdout)")
    doc.add_argument("--expect-top", metavar="SLUG",
                     help="exit 3 unless the top-ranked finding is SLUG "
                          "(CI gate)")
    doc.add_argument("--expect-clean", action="store_true",
                     help="exit 3 unless there are zero findings (CI gate)")

    s = sub.add_parser(
        "sentinel", help="gate CI: compare a fresh manifest against a "
                         "committed baseline with per-metric tolerances")
    s.add_argument("baseline", help="committed baseline manifest JSON")
    s.add_argument("fresh", help="freshly produced manifest JSON")
    s.add_argument("--default-tol", type=float, default=None,
                   help="relative tolerance for metrics without a --tol "
                        "rule (default 1e-6)")
    s.add_argument("--tol", action="append", default=[], metavar="M=REL",
                   help="per-metric tolerance rule, repeatable "
                        "(e.g. --tol mfu=0.05 --tol total_seconds=0.01)")
    s.add_argument("--append", metavar="PATH",
                   help="append this run to the BENCH_doctor.json "
                        "trajectory at PATH")
    s.add_argument("--json", action="store_true",
                   help="emit the structured verdict instead of text")
    s.add_argument("--verbose", action="store_true",
                   help="list every checked metric, not just regressions")
    return p


def _write(path: str, payload: str) -> None:
    if path == "-":
        print(payload)
    else:
        with open(path, "w") as f:
            f.write(payload)
        print(f"wrote {path}", file=sys.stderr)


def _cmd_diff(args) -> int:
    from repro_torch.obs.diff import diff_manifests
    from repro_torch.obs.manifest import RunManifest
    try:
        a = RunManifest.load(args.a)
        b = RunManifest.load(args.b)
    except (OSError, ValueError, KeyError) as e:
        print(f"error loading manifest: {e}", file=sys.stderr)
        return 2
    d = diff_manifests(a, b, rel_tol=args.rel_tol)
    try:
        if args.json:
            print(json.dumps(d.to_doc(), indent=2))
        else:
            print(d.render(top=args.top))
    except BrokenPipeError:     # `... | head` closed stdout; not an error
        sys.stderr.close()      # suppress the interpreter's flush warning
    if d.kind_mismatch:
        return 2
    return 0 if d.empty else 3


def _cmd_doctor(args) -> int:
    from repro_torch.core import CHIPS
    from repro_torch.obs.doctor import diagnose_demo, diagnose_engine
    if args.hw not in CHIPS:
        print(f"unknown --hw {args.hw!r}; known: {sorted(CHIPS)}",
              file=sys.stderr)
        return 2
    hw = CHIPS[args.hw]

    if args.workload in DEMO_WORKLOADS:
        doc, report = diagnose_demo(args.workload, hw=hw)
    else:
        # a registered architecture: capture + simulate + diagnose (the
        # same pipeline `python -m repro_torch.analysis <arch> --doctor` runs)
        from repro_torch import config as C
        from repro_torch.core import Simulator
        from repro_torch.device import resolve_device
        from repro_torch.obs.timelapse import TimeLapse
        from repro_torch.runtime.steps import train_bundle
        try:
            entry = C.get(args.workload)
        except KeyError as e:
            print(e.args[0], file=sys.stderr)
            print(f"(built-in demos: {', '.join(DEMO_WORKLOADS)})",
                  file=sys.stderr)
            return 2
        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            print(e.args[0], file=sys.stderr)
            return 1
        shape = C.ShapeConfig("doctor", seq_len=args.seq_len,
                              global_batch=args.batch, kind="train")
        rc = C.RunConfig(model=entry.smoke, shape=shape, mesh=C.SMOKE_MESH)
        sim = Simulator(hw=hw)
        print(f"capturing {args.workload} train step (seq={args.seq_len}, "
              f"batch={args.batch}, {args.hw}, fake tensors on {device}) ...",
              file=sys.stderr)
        cap = sim.capture_bundle(train_bundle(rc),
                                 name=f"{args.workload}_doctor", device=device)
        report = sim.performance(cap)
        lapse = TimeLapse.from_report(report,
                                      num_intervals=args.lapse_intervals,
                                      label=args.workload)
        doc = diagnose_engine(report, engine=sim.engine, module=cap.module,
                              lapse=lapse, label=args.workload)

    print(doc.table())
    if args.json:
        _write(args.json, doc.to_json(indent=2))
    if args.chrome_trace:
        from repro_torch.obs.export import trace_json
        _write(args.chrome_trace, trace_json(doc.to_chrome_events()))

    if args.expect_clean and doc.findings:
        print(f"expected a clean bill, found "
              f"{[f.slug for f in doc.findings]}", file=sys.stderr)
        return 3
    if args.expect_top:
        top = doc.top.slug if doc.top else None
        if top != args.expect_top:
            print(f"expected top finding {args.expect_top!r}, got "
                  f"{top!r}", file=sys.stderr)
            return 3
    return 0


def _cmd_sentinel(args) -> int:
    from repro_torch.obs.manifest import RunManifest
    from repro_torch.obs.sentinel import (DEFAULT_TOLERANCE, append_trajectory,
                                          parse_tolerances, sentinel_compare,
                                          trajectory_entry)
    try:
        tols = parse_tolerances(args.tol)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        baseline = RunManifest.load(args.baseline)
        fresh = RunManifest.load(args.fresh)
        rep = sentinel_compare(
            baseline, fresh,
            default_tol=args.default_tol if args.default_tol is not None
            else DEFAULT_TOLERANCE,
            tolerances=tols)
    except (OSError, ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(rep.to_doc(), indent=2))
    else:
        print(rep.render(verbose=args.verbose))
    if args.append:
        n = append_trajectory(args.append, trajectory_entry(fresh, rep))
        print(f"appended run #{n} to {args.append}", file=sys.stderr)
    return 0 if rep.clean else 3


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "diff":
        return _cmd_diff(args)
    if args.command == "doctor":
        return _cmd_doctor(args)
    return _cmd_sentinel(args)


if __name__ == "__main__":
    sys.exit(main())
