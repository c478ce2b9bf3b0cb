"""CLI: simulate an arrival trace against a device fleet under a policy.

    PYTHONPATH=src python -m repro_torch.cluster --policy sjf \\
        --trace synthetic:bursty --devices 4

Examples::

    python -m repro_torch.cluster --policy fifo --trace synthetic:poisson \\
        --jobs 60 --rate 2.0 --devices 2xtpu-v5e+2xtpu-v5p
    python -m repro_torch.cluster --policy sjf --trace /tmp/trace.json \\
        --cost synthetic --chrome-trace /tmp/fleet.json
    python -m repro_torch.cluster --trace synthetic:bursty --save-trace /tmp/t.json

    python -m repro_torch.cluster --devices 4xh100 --device cpu

Builds (or loads) the trace, prices each job class through the memoized
device Engine, runs the discrete-event loop, and prints the ClusterReport:
per-job table, fleet summary (queueing delay, p50/p95/p99 latency,
utilization, HoL and cache counters), the ASCII fleet timeline, and the
busy-time-vs-engine-makespan reconciliation.
"""
from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.cluster",
        description="Trace-driven multi-tenant fleet simulation on top of "
                    "the device Engine.")
    p.add_argument("--trace", default="synthetic:poisson",
                   help="'synthetic:poisson' | 'synthetic:bursty' | "
                        "'synthetic:multislice' (multi-device gang jobs) | "
                        "path to a saved trace JSON "
                        "(default synthetic:poisson)")
    p.add_argument("--policy", default="fifo",
                   help="fifo | sjf | best-fit-hbm | locality")
    p.add_argument("--devices", default="4",
                   help="fleet spec: '4' (v5e), '4xtpu-v5p', or "
                        "'2xtpu-v5e+2xtpu-v5p'")
    p.add_argument("--topology", metavar="SPEC", default=None,
                   help="fleet interconnect: 'ring', 'torus:4x4', 'fc' — "
                        "enables topology-aware (minimal-diameter sub-slice) "
                        "placement of multi-device jobs under "
                        "--policy locality")
    p.add_argument("--jobs", type=int, default=40,
                   help="synthetic traces: number of jobs (default 40)")
    p.add_argument("--rate", type=float, default=1.0,
                   help="synthetic traces: arrival rate in jobs/s")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cost", default="capture",
                   choices=("capture", "synthetic"),
                   help="job cost model: 'capture' traces each class's "
                        "smoke train step on --device (detailed); "
                        "'synthetic' uses capture-free HLO chains (fast)")
    p.add_argument("--device", default=None,
                   help="torch device of the capture's fake tensors (default: "
                        "cuda; fails without a GPU); --cost synthetic needs "
                        "none")
    p.add_argument("--cold-start", type=float, default=0.0, metavar="S",
                   help="setup seconds charged when a device switches job "
                        "class (what the locality policy avoids)")
    p.add_argument("--quantum", type=float, default=None, metavar="S",
                   help="time-slice seconds: preempt and requeue longer jobs")
    p.add_argument("--failures", metavar="SPEC", default=None,
                   help="inject seeded stochastic outages: "
                        "'mtbf:600,mttr:60' (devices), "
                        "'mtbf:1h,mttr:2m,dist:weibull:0.7' (heavy tail), "
                        "'mtbf:600,links:3600,link-mttr:30' (+ ICI links), "
                        "'...,seed:3'")
    p.add_argument("--checkpoint", metavar="SPEC", default=None,
                   help="checkpoint-restore pricing: 'every:600' "
                        "(hardware-priced save/restore), "
                        "'every:10m,write:2,restore:5' (fixed costs)")
    p.add_argument("--legacy-scheduler", action="store_true",
                   help="price jobs with the retained per-op reference walk "
                        "instead of the batched tape scheduler (identical "
                        "results, slower)")
    p.add_argument("--no-elastic", action="store_true",
                   help="killed gangs wait for repairs at full size instead "
                        "of reshaping onto the surviving devices")
    p.add_argument("--save-trace", metavar="PATH",
                   help="write the (possibly generated) trace JSON here")
    p.add_argument("--chrome-trace", metavar="PATH",
                   help="write the fleet chrome://tracing JSON here "
                        "('-' for stdout); time-lapse counter tracks and "
                        "self-spans (when --timelapse / --spans are active) "
                        "compose into the same file")
    p.add_argument("--json", metavar="PATH",
                   help="write the full report JSON here ('-' for stdout)")
    p.add_argument("--timelapse", metavar="PATH",
                   help="write the fleet time-lapse JSON here "
                        "('-' for stdout); also renders the ASCII heat "
                        "strips")
    p.add_argument("--lapse-intervals", type=int, default=64,
                   help="fixed sampling intervals for --timelapse "
                        "(default 64)")
    p.add_argument("--manifest", metavar="PATH",
                   help="write a repro_torch.obs run manifest here (compare runs "
                        "with `python -m repro_torch.obs diff A B`)")
    p.add_argument("--doctor", action="store_true",
                   help="run repro_torch.obs.doctor over the fleet report: ranked "
                        "findings (HoL blocking, gang stragglers, checkpoint "
                        "cadence vs Young-Daly, cache miss storms)")
    p.add_argument("--validate", action="store_true",
                   help="cross-check the report against conservation laws "
                        "(Little's law, busy-time/utilization identities) "
                        "and the analytic M/G/k queueing band "
                        "(repro_torch.validate); exit 1 on any failed identity")
    p.add_argument("--spans", metavar="PATH",
                   help="enable the simulator self-span tracer and write its "
                        "chrome trace here ('-' for stdout)")
    p.add_argument("--width", type=int, default=72,
                   help="ASCII fleet timeline width in columns")
    p.add_argument("--self-profile", action="store_true",
                   help="print wall-clock seconds per simulator stage "
                        "(setup/pricing/events/render/export) to stderr, and "
                        "record them on ClusterReport.stage_seconds")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from repro_torch.cluster import (ClusterSim, Fleet, Trace, cost_model_for,
                                     fleet_ascii, fleet_chrome_trace, make_policy,
                                     synthetic_trace, to_json)
    from repro_torch.faults import parse_checkpoint_spec, parse_failure_spec
    from repro_torch.obs.metrics import StageTimer
    from repro_torch.obs.trace import TRACER

    timer = StageTimer("cluster")
    mark = timer.mark
    if args.cost == "capture":
        from repro_torch.device import resolve_device
        try:
            resolve_device(args.device)
        except RuntimeError as e:
            print(e.args[0], file=sys.stderr)
            return 1
    if args.spans:
        TRACER.enable()

    try:
        policy = make_policy(args.policy)
        fleet = Fleet.from_spec(args.devices, topology=args.topology)
        if args.trace.startswith("synthetic"):
            trace = synthetic_trace(args.trace, n_jobs=args.jobs,
                                    rate_jobs_per_s=args.rate,
                                    seed=args.seed)
        else:
            trace = Trace.load(args.trace)
        cost = cost_model_for(
            trace, args.cost, device=args.device,
            scheduler="legacy" if args.legacy_scheduler else "batched")
        faults = parse_failure_spec(args.failures) if args.failures else None
        ckpt = parse_checkpoint_spec(args.checkpoint) \
            if args.checkpoint else None
    except (KeyError, ValueError, FileNotFoundError) as e:
        # KeyError's str() wraps the message in quotes; FileNotFoundError's
        # args[0] is a bare errno int — unpack each to the readable form
        print(e.args[0] if isinstance(e, KeyError) else str(e),
              file=sys.stderr)
        return 2

    if args.save_trace:
        trace.save(args.save_trace)
        print(f"wrote {args.save_trace}", file=sys.stderr)

    classes = sorted({j.job_class for j in trace.jobs})
    topo_note = f", topology={fleet.topology.name}" if fleet.topology else ""
    print(f"simulating {len(trace.jobs)} jobs ({', '.join(classes)}) on "
          f"{len(fleet)} devices{topo_note}, policy={policy.name}, "
          f"cost={args.cost} ...", file=sys.stderr)
    sim = ClusterSim(fleet, cost, policy, cold_start_s=args.cold_start,
                     quantum_s=args.quantum, faults=faults, checkpoint=ckpt,
                     elastic=not args.no_elastic)
    mark("setup")
    if args.self_profile:
        # pre-warm the memoized cost model so per-class pricing (capture +
        # engine simulation) is measured apart from the event loop; the
        # loop would hit the same memo either way, so results are identical
        for jc in classes:
            for hw in {d.hw for d in fleet.slots}:
                cost.report(jc, hw)
        mark("pricing")
    rep = sim.run(trace)
    mark("events")

    s = rep.summary()
    print(f"== {rep.trace_name} x {rep.policy} x {rep.num_devices} devices: "
          f"makespan {s['makespan_s']:.2f} s, utilization "
          f"{s['utilization'] * 100:.1f}%, mean queue delay "
          f"{s['mean_queue_delay_s']:.2f} s ==")
    print(f"   latency p50/p95/p99: {s['p50_latency_s']:.2f} / "
          f"{s['p95_latency_s']:.2f} / {s['p99_latency_s']:.2f} s; "
          f"HoL events {s['hol_events']}, bypasses {s['hol_bypasses']}; "
          f"sim cache {s['cache_hits']} hits / {s['cache_misses']} misses "
          f"({s['cache_hit_rate'] * 100:.0f}%)")
    if faults is not None or ckpt is not None:
        print(f"   goodput {s['goodput_fraction'] * 100:.1f}%: "
              f"{s['fleet_busy_seconds']:.1f} s useful, "
              f"{s['lost_work_seconds']:.1f} s lost, "
              f"{s['checkpoint_seconds']:.1f} s checkpointing, "
              f"{s['restore_seconds']:.1f} s restoring; "
              f"{s['device_failures']} device + {s['link_failures']} link "
              f"failures, {s['recoveries']} recoveries, "
              f"{s['gang_reshapes']} elastic reshapes")
    print()
    print(rep.table())
    print()
    print(fleet_ascii(rep, width=args.width))
    err = rep.reconcile_busy()
    print(f"\nfleet busy {rep.fleet_busy_seconds:.3f} s vs sum of per-job "
          f"engine makespans {rep.engine_service_seconds:.3f} s "
          f"(rel error {err * 100:.3f}%)")
    if err > 0.01:
        print("RECONCILIATION FAILED (> 1%)", file=sys.stderr)
        return 1
    if faults is not None or ckpt is not None:
        # per-device time conservation: occupancy + down + idle == horizon
        acc = rep.time_accounting()
        worst = max((max(-a["idle"], 0.0) / a["horizon"]
                     if a["horizon"] > 0 else 0.0
                     for a in acc.values()), default=0.0)
        down = sum(a["down"] for a in acc.values())
        print(f"time accounting: {down:.1f} s device down-time; "
              f"busy+setup+ckpt+restore+lost+down+idle == horizon on all "
              f"{len(acc)} devices (worst residual {worst * 100:.3f}%)")
        if worst > 0.01:
            print("TIME ACCOUNTING FAILED (> 1%)", file=sys.stderr)
            return 1
    mark("render")
    rep.stage_seconds.update(timer.stage_seconds)

    lapse = None
    if args.timelapse or args.manifest or args.chrome_trace or args.doctor:
        from repro_torch.obs.timelapse import TimeLapse
        lapse = TimeLapse.from_cluster(
            rep, num_intervals=args.lapse_intervals,
            label=f"{rep.trace_name} x {rep.policy}")
    if args.timelapse:
        print()
        print(lapse.heat_strips(width=args.width))

    doctor_rep = None
    if args.doctor:
        from repro_torch.obs.doctor import diagnose_cluster
        context = {}
        if ckpt is not None:
            context["checkpoint"] = ckpt
        if faults is not None:
            context["mtbf_s"] = faults.mtbf_s
        doctor_rep = diagnose_cluster(rep, lapse=lapse,
                                      context=context or None)
        print()
        print(doctor_rep.table(width=args.width))

    vrep = None
    if args.validate:
        from repro_torch.validate.queueing import validate_cluster
        vrep = validate_cluster(rep)
        print()
        print(vrep.render())

    outputs = []
    if args.chrome_trace:
        extra: list = lapse.to_chrome_events() if lapse is not None else []
        if doctor_rep is not None:
            extra = extra + doctor_rep.to_chrome_events()
        if TRACER.enabled:
            extra = extra + TRACER.to_chrome_events()
        outputs.append((args.chrome_trace,
                        fleet_chrome_trace(rep, extra_events=extra)))
    if args.json:
        outputs.append((args.json, to_json(rep, indent=2)))
    if args.timelapse:
        outputs.append((args.timelapse, lapse.to_json(indent=2)))
    if args.manifest:
        from repro_torch.obs.manifest import cluster_manifest
        man = cluster_manifest(
            rep,
            config={"trace": args.trace, "policy": args.policy,
                    "devices": args.devices, "topology": args.topology,
                    "jobs": args.jobs, "rate": args.rate, "cost": args.cost,
                    "cold_start_s": args.cold_start,
                    "quantum_s": args.quantum, "failures": args.failures,
                    "checkpoint": args.checkpoint,
                    "scheduler": ("legacy" if args.legacy_scheduler
                                  else "batched"),
                    "elastic": not args.no_elastic},
            seeds={"seed": args.seed},
            stage_seconds=timer.stage_seconds, timelapse=lapse,
            extra_metrics=vrep.metrics() if vrep is not None else None)
        outputs.append((args.manifest, man.to_json()))
    for path, payload in outputs:
        if path == "-":
            print(payload)
        else:
            with open(path, "w") as f:
                f.write(payload)
            print(f"wrote {path}", file=sys.stderr)
    mark("export")
    rep.stage_seconds.update(timer.stage_seconds)
    if args.spans:
        from repro_torch.obs.export import trace_json
        payload = trace_json(TRACER.to_chrome_events())
        if args.spans == "-":
            print(payload)
        else:
            with open(args.spans, "w") as f:
                f.write(payload)
            print(f"wrote {args.spans} "
                  f"({len(TRACER.records)} spans)", file=sys.stderr)
    if args.self_profile:
        print(timer.render(), file=sys.stderr)
    if vrep is not None and not vrep.passed:
        print("VALIDATION FAILED (conservation/queueing cross-checks)",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
