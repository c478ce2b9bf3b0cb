"""repro_torch.faults — failure processes, checkpoint pricing, and degraded-fabric
rerouting for the fleet simulator.

The paper's simulator prices *healthy* execution; real fleets spend a
measurable fraction of their hours failing, restoring, and running
degraded.  This package supplies the three ingredients the cluster event
loop (:mod:`repro_torch.cluster.events`) composes into that story:

* :mod:`repro_torch.faults.processes` — *who breaks, when*: seeded renewal
  failure processes (exponential / heavy-tailed Weibull MTBF, exponential
  MTTR) and explicit planned-outage lists, per device and per undirected
  ICI link, plus the CLI's ``--failures mtbf:...`` grammar;
* :mod:`repro_torch.faults.pricing` — *what recovery costs*: checkpoint save /
  restore cycles priced from the chip spec (HBM + DCN + gang re-shard
  over ICI), cadence conversion, and the Young/Daly optimal interval the
  sweep benchmark validates against;
* :mod:`repro_torch.faults.reroute` — *how survivors slow down*: the gang
  dilation factor from lowering the gang's all-reduce over the surviving
  fabric only.

Event flow on a failure: **fail** (outage event fires, gang killed, work
since the last checkpoint is lost) -> **detect** (job requeued; an elastic
gang reshapes onto the largest surviving sub-slice) -> **restore** (priced
checkpoint read + re-shard) -> **resume** (remaining steps, possibly
dilated by broken links).  See ``docs/ARCHITECTURE.md``.
"""
from repro_torch.faults.pricing import (CheckpointModel, daly_interval,
                                        parse_checkpoint_spec, tree_nbytes)
from repro_torch.faults.processes import (DEVICE, LINK, FailureProcess, Outage,
                                          PlannedFailures, StochasticFailures,
                                          link_key, parse_failure_spec,
                                          parse_seconds)
from repro_torch.faults.reroute import PROBE_BYTES, gang_dilation

__all__ = [
    "DEVICE",
    "LINK",
    "Outage",
    "FailureProcess",
    "PlannedFailures",
    "StochasticFailures",
    "link_key",
    "parse_failure_spec",
    "parse_seconds",
    "CheckpointModel",
    "parse_checkpoint_spec",
    "daly_interval",
    "tree_nbytes",
    "PROBE_BYTES",
    "gang_dilation",
]
