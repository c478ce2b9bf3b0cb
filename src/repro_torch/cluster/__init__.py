"""repro_torch.cluster — trace-driven multi-tenant fleet simulation on the Engine.

The paper's simulator explains where time goes inside ONE device; this
subsystem asks the next question up the stack — what happens when a *fleet*
of those devices serves a stream of competing jobs (the "MLaaS in the Wild"
setting).  It is a discrete-event cluster simulator whose per-job costs are
not trace-recorded numbers but detailed ``Engine.simulate`` runs of each
job class's captured HLO: queueing delay, utilization and tail latency all
inherit the device model's fidelity (per-channel HBM, launch overhead,
dataflow overlap), and a hardware knob — say ``hbm_channels`` or a v5p swap
— propagates all the way to cluster SLOs.

Layers (each its own module):

* :mod:`~repro_torch.cluster.workload`  — jobs, job-class catalog, Poisson/bursty
  synthetic traces, JSON round-trip;
* :mod:`~repro_torch.cluster.devices`   — the device fleet + memoized cost models
  (capture-backed, synthetic-HLO, or fixed-table);
* :mod:`~repro_torch.cluster.scheduler` — placement policies (fifo, sjf,
  best-fit-hbm, locality) behind one ``Policy`` interface;
* :mod:`~repro_torch.cluster.events`    — the event-heap loop producing a
  :class:`ClusterReport`;
* :mod:`~repro_torch.cluster.export`    — fleet chrome://tracing + ASCII views.

Failure and elasticity come from :mod:`repro_torch.faults`: pass ``faults=``
(a :class:`repro_torch.faults.FailureProcess`) and ``checkpoint=``
(a :class:`repro_torch.faults.CheckpointModel`) to :class:`ClusterSim` and the
loop injects device/link outages, prices checkpoint-restore cycles on the
simulated clock, reshapes elastic gangs onto surviving devices, and
reports ``goodput_fraction`` plus a per-device time-conservation ledger.

Usage::

    from repro_torch.cluster import (ClusterSim, Fleet, cost_model_for,
                                     make_policy, synthetic_trace)

    trace = synthetic_trace("synthetic:bursty", n_jobs=40, seed=0)
    sim = ClusterSim(Fleet.from_spec("4"),
                     cost_model_for(trace, "capture"), make_policy("sjf"))
    report = sim.run(trace)
    print(report.table())
    print(report.summary()["p95_latency_s"], report.cache_hit_rate)

CLI::

    PYTHONPATH=src python -m repro_torch.cluster \\
        --policy sjf --trace synthetic:bursty --devices 4
"""
from __future__ import annotations

from repro_torch.cluster.devices import (CostModel, DeviceSlot, Fleet,
                                         TableCostModel, captured_modules,
                                         cost_model_for, synthetic_module,
                                         synthetic_modules)
from repro_torch.cluster.events import (ClusterReport, ClusterSim, JobRecord,
                                        Slice, percentile)
from repro_torch.cluster.export import fleet_ascii, fleet_chrome_trace, to_json
from repro_torch.cluster.scheduler import (POLICIES, BestFitHBM, FIFO, Locality,
                                           Policy, QueuedJob, SJF, make_policy)
from repro_torch.cluster.workload import (DEFAULT_CLASSES, GENERATORS,
                                          MULTISLICE_CLASSES, Job, JobClass, Trace,
                                          bursty_trace, multislice_trace,
                                          poisson_trace, synthetic_trace)

__all__ = [
    "Job", "JobClass", "Trace", "DEFAULT_CLASSES", "MULTISLICE_CLASSES",
    "GENERATORS",
    "poisson_trace", "bursty_trace", "multislice_trace", "synthetic_trace",
    "DeviceSlot", "Fleet", "CostModel", "TableCostModel", "cost_model_for",
    "captured_modules", "synthetic_modules", "synthetic_module",
    "Policy", "QueuedJob", "FIFO", "SJF", "BestFitHBM", "Locality",
    "POLICIES", "make_policy",
    "ClusterSim", "ClusterReport", "JobRecord", "Slice", "percentile",
    "fleet_chrome_trace", "fleet_ascii", "to_json",
]
