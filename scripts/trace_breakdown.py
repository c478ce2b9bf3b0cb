#!/usr/bin/env python3
"""Where a benchmark cell's traced device time and idle time go, and what
tracing costs, on one GPU.

    python3 scripts/trace_breakdown.py --workload <cell> [--seed N] [--seconds S]
                                       [--out PATH]

Runs the cell's own loop through the benchmark's harness
(``port_bench/harness.py``'s ``run_cell``, as ``port_bench/run.py --trace 1``
does: set-up, an untraced window of S seconds, the traced calls or steps,
the check), then reads its device trace with the benchmark's readers'
tools (``port_bench/replays.py``).  It reports the run's per-layer metrics
as the harness reads them, and:

* each phase's device busy time, and each compiled step's device time by
  region over the whole replays launched in the phase that hold their
  table's node count, with the event counts of those that do not;
* each phase's idle device time by what the host was doing (the innermost
  ``repro.*`` span around it), with the part of it inside a replay
  (between one replay's graph nodes);
* the cost of tracing: the untraced window's median time to first token
  and decode step (a serving cell) or step (the training cell) beside the
  same times of the traced calls, read from the harness's ``bench.<phase>``
  ranges.

Prints a summary and one JSON line, and writes the JSON to ``--out``.
"""
from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "port_bench"
INSIDE_REPLAY = "inside a replay (between graph nodes)"
OUTSIDE_SPANS = "outside every repro span"
#: each loop's phases, and the compiled step replayed in each
PHASES = {"serve": {"prefill": "prefill", "decode": "decode"}, "train": {"step": "train"}}
PHASES["serve_hybrid"] = PHASES["serve"]


def _gaps(device, lo, hi):
    """The intervals of [lo, hi) in which no device event ran."""
    out, end = [], lo
    for _, s, e in device:                 # sorted by start
        if s >= hi:
            break
        if s > end:
            out.append((end, s))
        end = max(end, e)
    if end < hi:
        out.append((end, hi))
    return out


def _innermost(trace):
    """The host's timeline as (start, end, innermost repro span) pieces."""
    marks = []
    for name, s, e in trace.host:
        if name.startswith("repro."):
            marks += [(s, 1, name[len("repro."):]), (e, 0, name[len("repro."):])]
    marks.sort()
    stack, pieces, last = [], [], None
    for t, opening, name in marks:
        if last is not None and t > last:
            pieces.append((last, t, stack[-1] if stack else OUTSIDE_SPANS))
        if opening:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
        last = t
    return pieces


def _idle_by_span(trace, phase, replays):
    """Seconds of the phase's idle device time by the innermost ``repro.*``
    span the host was in, and the part of it inside one of ``replays``."""
    pieces = _innermost(trace)
    starts = [p[0] for p in pieces]
    firsts = [r.t0 for r in replays]
    by_span = {INSIDE_REPLAY: 0.0}
    for lo, hi in trace.ranges.get("bench." + phase, []):
        for gs, ge in _gaps(trace.device, lo, hi):
            i = bisect.bisect_right(firsts, gs) - 1
            if i >= 0 and ge <= replays[i].t1:
                by_span[INSIDE_REPLAY] += (ge - gs) / 1e9
            j = max(bisect.bisect_right(starts, gs) - 1, 0)
            covered = 0
            while j < len(pieces) and pieces[j][0] < ge:
                a, b = max(pieces[j][0], gs), min(pieces[j][1], ge)
                if b > a:
                    by_span[pieces[j][2]] = by_span.get(pieces[j][2], 0.0) + (b - a) / 1e9
                    covered += b - a
                j += 1
            if ge - gs > covered:
                by_span[OUTSIDE_SPANS] = by_span.get(OUTSIDE_SPANS, 0.0) \
                    + (ge - gs - covered) / 1e9
    return by_span


def analyse(trace, phases):
    """Each phase's busy time, its compiled step's device time by region
    and its idle time by span."""
    import replays as RP
    pairs = RP.launched(trace.device, trace.host) or []
    out = {}
    for phase, step in phases.items():
        spans = trace.ranges.get("bench." + phase, [])
        mine = [rp for t, rp in pairs if any(lo <= t < hi for lo, hi in spans)]
        got = RP.phase_replays(trace, step, phase)
        table, good = got if got is not None else (None, [])
        out[phase] = {
            "busy_s": sum(trace.busy_ns(lo, hi) for lo, hi in spans) / 1e9,
            "span_s": sum(hi - lo for lo, hi in spans) / 1e9,
            "nodes": getattr(table, "nodes", None),
            "replays": len(mine), "whole": len(good),
            "others": [len(rp.events) for rp in mine if rp not in good],
            "replay_ms": 1e3 * statistics.mean(r.elapsed_s for r in good) if good else None,
            "regions_s": RP.put_down(good, table) if good else None,
            "idle_s": _idle_by_span(trace, phase, mine)}
    return out


def cost(run, trace):
    """The untraced window's median times beside the traced calls' (ms)."""
    ranges = {k[len("bench."):]: [(e - s) / 1e6 for s, e in v] for k, v in trace.ranges.items()}
    if run.traffic["loop"] == "train":
        return {"train_step_ms": {
            "untraced": statistics.median(1e3 * (s["t1"] - s["t0"]) for s in run.records["steps"]),
            "traced": statistics.median(ranges["step"])}}
    steps = run.traffic["new_tokens"] - 1
    calls = run.records["calls"]
    return {"ttft_ms": {"untraced": statistics.median(1e3 * (c["first"] - c["t0"]) for c in calls),
                        "traced": statistics.median(ranges["prefill"])},
            "decode_step_ms": {
                "untraced": statistics.median(1e3 * c["decode_s"] / c["decode_steps"]
                                              for c in calls),
                "traced": statistics.median(d / steps for d in ranges["decode"])}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=20261018)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(BENCH)]
    import torch

    import harness
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    run = harness.run_cell(ROOT, BENCH, args.workload, args.seed, args.seconds, True, "cuda",
                           time.perf_counter())
    trace = run.tracer.trace
    result = {"workload": args.workload, "seed": args.seed, "correct": run.correct,
              "device": torch.cuda.get_device_name(0), "power_limit": harness._power_limit(),
              "memory_peak_bytes": run.memory_peak, "metrics": harness.metrics_of(run),
              "cost": cost(run, trace),
              "phases": analyse(trace, PHASES[run.traffic["loop"]])}
    for name, c in result["cost"].items():
        print(f"{name}: untraced {c['untraced']:.3f}, traced {c['traced']:.3f}")
    text = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
