"""CLI: ingest -> fit -> simulate -> cross-check, in one command.

    PYTHONPATH=src python -m repro_torch.validate \\
        --trace tests/data/alibaba_fixture --policy sjf

``--trace`` accepts three forms:

* a **directory** holding Alibaba cluster-trace-gpu-v2020 tables
  (``pai_job_table.csv`` + ``pai_task_table.csv``): jobs are ingested,
  classed by (gpu type, gang size), and replayed through a
  :class:`~repro_torch.cluster.devices.TableCostModel` so simulated service
  matches the recorded durations;
* a saved trace **JSON** (``Trace.save`` format);
* a ``synthetic:<name>`` spec — including ``synthetic:alibaba-like``,
  the generator refit from ingested distributions.

The run then passes through the full conservation/queueing check suite
(:func:`repro_torch.validate.queueing.validate_cluster`).  Exit codes: 0 all
checks pass, 3 a check failed, 2 bad arguments, 1 ``--cost capture`` of
a synthetic or JSON trace without a GPU and without ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.validate",
        description="Validate fleet-simulator accounting against real "
                    "traces, fitted distributions, and analytic queueing.")
    p.add_argument("--trace", default="synthetic:alibaba-like",
                   help="Alibaba trace directory | trace JSON | "
                        "'synthetic:<name>' (default synthetic:alibaba-like)")
    p.add_argument("--policy", default="fifo",
                   help="fifo | sjf | best-fit-hbm | locality")
    p.add_argument("--devices", default="4",
                   help="fleet spec, e.g. '4' or '2xtpu-v5e+2xtpu-v5p'")
    p.add_argument("--topology", metavar="SPEC", default=None)
    p.add_argument("--jobs", type=int, default=40,
                   help="synthetic traces: number of jobs")
    p.add_argument("--rate", type=float, default=1.0,
                   help="synthetic traces: arrival rate in jobs/s")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-jobs", type=int, default=None,
                   help="cap the number of ingested trace jobs")
    p.add_argument("--cost", default="synthetic",
                   choices=("capture", "synthetic"),
                   help="cost model for synthetic/JSON traces (ingested "
                        "directories always replay recorded durations)")
    p.add_argument("--device", default=None,
                   help="torch device of --cost capture's fake tensors "
                        "(default: cuda; fails without a GPU)")
    p.add_argument("--cold-start", type=float, default=0.0, metavar="S")
    p.add_argument("--quantum", type=float, default=None, metavar="S")
    p.add_argument("--failures", metavar="SPEC", default=None,
                   help="failure spec, as in repro_torch.cluster")
    p.add_argument("--refit", type=int, metavar="N", default=None,
                   help="instead of replaying the ingested trace, fit its "
                        "distributions and simulate N regenerated "
                        "alibaba-like jobs at the fitted rate")
    p.add_argument("--tol", type=float, default=None,
                   help="conservation-law residual tolerance "
                        "(default 0.01 = 1%%)")
    p.add_argument("--queueing-tol", type=float, default=None,
                   help="M/G/k prediction band (default 0.25 = 25%%)")
    p.add_argument("--max-util", type=float, default=None,
                   help="utilization ceiling for the M/G/k check "
                        "(default 0.7)")
    p.add_argument("--json", metavar="PATH",
                   help="write the validation report JSON here "
                        "('-' for stdout)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import json

    from repro_torch.cluster import (ClusterSim, Fleet, Trace, cost_model_for,
                                     make_policy, synthetic_trace)
    from repro_torch.faults import parse_failure_spec
    from repro_torch.validate.fitting import fit_report
    from repro_torch.validate.ingest import (alibaba_like_trace, load_alibaba,
                                             profile_from_trace, table_cost_model)
    from repro_torch.validate.queueing import (CONSERVATION_TOL,
                                               QUEUEING_MAX_UTIL, QUEUEING_TOL,
                                               validate_cluster)

    tol = CONSERVATION_TOL if args.tol is None else args.tol
    qtol = QUEUEING_TOL if args.queueing_tol is None else args.queueing_tol
    max_util = QUEUEING_MAX_UTIL if args.max_util is None else args.max_util

    try:
        policy = make_policy(args.policy)
        fleet = Fleet.from_spec(args.devices, topology=args.topology)
        faults = parse_failure_spec(args.failures) if args.failures else None
        if os.path.isdir(args.trace):
            trace, stats = load_alibaba(args.trace, max_jobs=args.max_jobs)
            print(stats.render(), file=sys.stderr)
            if args.refit:
                prof = profile_from_trace(trace)
                trace = alibaba_like_trace(
                    n_jobs=args.refit, rate_jobs_per_s=prof.rate_jobs_per_s,
                    seed=args.seed, profile=prof,
                    name=f"{trace.name}-refit")
                cost = table_cost_model(trace)
            else:
                cost = table_cost_model(trace)
        elif args.trace.startswith("synthetic"):
            trace = synthetic_trace(args.trace, n_jobs=args.jobs,
                                    rate_jobs_per_s=args.rate,
                                    seed=args.seed)
            cost = cost_model_for(trace, args.cost, device=args.device)
        else:
            trace = Trace.load(args.trace)
            cost = cost_model_for(trace, args.cost, device=args.device)
    except RuntimeError as e:     # a capture without a GPU or --device cpu
        print(e.args[0], file=sys.stderr)
        return 1
    except (KeyError, ValueError, FileNotFoundError) as e:
        print(e.args[0] if isinstance(e, KeyError) else str(e),
              file=sys.stderr)
        return 2

    print(f"validating {len(trace.jobs)} jobs on {len(fleet)} devices, "
          f"policy={policy.name} ...", file=sys.stderr)
    sim = ClusterSim(fleet, cost, policy, cold_start_s=args.cold_start,
                     quantum_s=args.quantum, faults=faults)
    rep = sim.run(trace)

    # fit the observed arrival/service processes: these diagnostics feed
    # the alibaba-like generator and StochasticFailures.from_fit, and give
    # the M/G/k check's inputs a human-readable face
    fit_lines = []
    arrivals = sorted(j.arrival_s for j in rep.jobs)
    gaps = [b - a for a, b in zip(arrivals, arrivals[1:]) if b > a]
    if len(gaps) >= 3:
        fit_lines.append(fit_report(gaps, "inter-arrival"))
    services = [j.service_s for j in rep.jobs if j.service_s > 0]
    if len(services) >= 3:
        fit_lines.append(fit_report(services, "service"))

    vrep = validate_cluster(rep, tol=tol, queueing_tol=qtol,
                            max_util=max_util, fit_lines=fit_lines)
    print(vrep.render())

    if args.json:
        doc = vrep.to_doc()
        doc["summary"] = rep.summary()
        payload = json.dumps(doc, indent=2)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w") as f:
                f.write(payload)
            print(f"wrote {args.json}", file=sys.stderr)

    return 0 if vrep.passed else 3


if __name__ == "__main__":
    sys.exit(main())
