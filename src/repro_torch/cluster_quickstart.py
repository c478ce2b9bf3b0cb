"""Cluster-simulation quickstart: one bursty trace, four devices, two
policies — and the cluster-level numbers come from the detailed device
Engine, not from trace-recorded durations.

    PYTHONPATH=src python -m repro_torch.cluster_quickstart
    PYTHONPATH=src python -m repro_torch.cluster_quickstart --capture --device cpu
    PYTHONPATH=src python -m repro_torch.cluster_quickstart --capture   # on cuda

The port of ``examples/cluster_quickstart.py``.  By default it uses the
capture-free synthetic cost model, which needs no device and runs in under
a second; ``--capture`` prices the job classes by tracing each class's
smoke training step (lenet / llama3-8b / qwen3-moe-30b) on fake tensors on
``--device`` (cuda unless ``--device cpu`` is given) and simulating it — a
few seconds per class, once, thanks to the shared SimulationCache.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from repro_torch.cluster import (ClusterSim, Fleet, bursty_trace, cost_model_for,
                                 fleet_ascii, make_policy)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.cluster_quickstart",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--capture", action="store_true",
                    help="price the classes by capturing their smoke train steps")
    ap.add_argument("--device", default=None,
                    help="torch device of --capture's fake tensors (default: cuda; "
                         "fails without a GPU)")
    args = ap.parse_args(argv)
    backend = "capture" if args.capture else "synthetic"
    trace = bursty_trace(n_jobs=40, rate_jobs_per_s=8.0, seed=3)
    try:
        cost = cost_model_for(trace, backend, device=args.device)
    except RuntimeError as e:
        print(e.args[0], file=sys.stderr)
        return 1

    print(f"trace: {len(trace.jobs)} jobs, classes "
          f"{sorted({j.job_class for j in trace.jobs})}, cost={backend}\n")
    reports = {}
    for policy in ("fifo", "sjf"):
        sim = ClusterSim(Fleet.from_spec("4"), cost, make_policy(policy))
        rep = sim.run(trace)
        reports[policy] = rep
        s = rep.summary()
        print(f"{policy:>5s}: makespan {s['makespan_s']:.2f} s, "
              f"mean queue delay {s['mean_queue_delay_s']:.3f} s, "
              f"p95 latency {s['p95_latency_s']:.2f} s, "
              f"utilization {s['utilization'] * 100:.0f}%, "
              f"cache hit rate {s['cache_hit_rate'] * 100:.0f}%")
        assert rep.reconcile_busy() <= 0.01, \
            "fleet busy time must reconcile with engine makespans"

    print()
    print("fleet under sjf:")
    print(fleet_ascii(reports["sjf"], width=68))

    fifo_d = reports["fifo"].mean_queue_delay_s
    sjf_d = reports["sjf"].mean_queue_delay_s
    assert sjf_d <= fifo_d, (sjf_d, fifo_d)
    print(f"\nSJF cut mean queueing delay {fifo_d:.3f} s -> {sjf_d:.3f} s "
          f"on the same trace — the heavy-tailed mix is why.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
