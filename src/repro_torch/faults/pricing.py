"""Checkpoint/restore costs priced by the hardware model, plus Young/Daly.

The dormant seed checkpoint code (:mod:`repro_torch.checkpoint.store`,
:mod:`repro_torch.core.sim_checkpoint`) measures real wall-clock writes; the
fleet simulator needs the same flow as *simulated, priced events*.  A
:class:`CheckpointModel` prices one checkpoint cycle from the chip spec:

* **save** — the training state (the store's ``arrays.npz`` payload,
  :func:`tree_nbytes` of the state tree, or the allocator's
  ``peak_hbm_bytes`` when only a SimReport is available) is read out of
  HBM at ``hbm_bw`` and shipped off-chip at ``dcn_bw`` — the same
  "snapshot global memory" step the paper's §III-F fidelity switch takes
  before resuming in detailed mode;
* **restore** — the reverse path (host -> HBM), plus, for a multi-device
  gang, one re-shard sweep over the ICI: each member holds ``1/g`` of the
  state after its host pull and all-gathers the rest, the textbook
  ``(g-1)/g * S`` bytes per link direction — so restoring onto a
  different (or smaller) sub-slice genuinely pays fabric traffic.

``write_s``/``restore_s`` override the computed costs with fixed values
for hand-computable scenario tests and Young/Daly sweeps.

:func:`daly_interval` is the analytic optimum the checkpoint-interval
sweep benchmark validates against: for checkpoint cost ``w`` and MTBF
``M``, overhead/step-loss is minimized near ``sqrt(2 * w * M)`` (Young
1974; Daly 2006 first-order form).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

from repro_torch.core.hw import HardwareSpec


def tree_nbytes(tree: Any) -> int:
    """Checkpoint payload bytes of a state tree — what
    :func:`repro_torch.checkpoint.store.save` writes to ``arrays.npz``: the
    leaves as the store flattens them, each whole (a DTensor's global
    shape, which rank 0 writes, not this rank's shard)."""
    import numpy as np
    import torch

    from repro_torch.checkpoint.store import _flatten

    return int(sum(leaf.numel() * leaf.element_size() if isinstance(leaf, torch.Tensor)
                   else np.asarray(leaf).nbytes for _, leaf in _flatten(tree)))


@dataclass(frozen=True)
class CheckpointModel:
    """Cadence + priced costs of the checkpoint-restore cycle.

    ``interval_s`` is the target cadence on the *simulated* clock; the
    cluster loop converts it to a whole number of training steps per job
    (at least one step between checkpoints).  ``interval_s <= 0`` keeps
    the pricing (restores still cost time) but disables cadenced saves.
    """

    interval_s: float = 0.0
    write_s: Optional[float] = None     # fixed save cost override
    restore_s: Optional[float] = None   # fixed restore cost override
    base_s: float = 0.0                 # per-cycle quiesce/barrier cost

    def save_seconds(self, state_bytes: float, hw: HardwareSpec) -> float:
        """One cadenced checkpoint write on the simulated clock."""
        if self.write_s is not None:
            return self.write_s
        return (self.base_s + state_bytes / hw.hbm_bw
                + state_bytes / hw.dcn_bw)

    def restore_seconds(self, state_bytes: float, hw: HardwareSpec,
                        gang: int = 1) -> float:
        """Restore (+ re-shard for a gang) before a failed job resumes."""
        if self.restore_s is not None:
            return self.restore_s
        g = max(gang, 1)
        seconds = (self.base_s + state_bytes / g / hw.dcn_bw
                   + state_bytes / hw.hbm_bw)
        if g > 1:
            ici_bw = hw.ici_links_per_axis * hw.ici_link_bw
            seconds += (g - 1) / g * state_bytes / ici_bw \
                + (g - 1) * hw.ici_latency_s
        return seconds

    def steps_per_checkpoint(self, per_step_s: float) -> int:
        """Cadence in whole training steps (0 = checkpointing disabled)."""
        if self.interval_s <= 0 or per_step_s <= 0:
            return 0
        return max(int(round(self.interval_s / per_step_s)), 1)

    def cache_key(self) -> tuple:
        """Hashable identity for simulation-cache keys: two engine prices
        computed under different checkpoint specs must never alias."""
        return ("ckpt", self.interval_s, self.write_s, self.restore_s,
                self.base_s)


def parse_checkpoint_spec(spec: str) -> CheckpointModel:
    """CLI grammar for ``--checkpoint``::

        every:10m                       # cadence only, hardware-priced costs
        every:600,write:2,restore:5     # fixed-cost overrides (seconds)
        every:1h,base:0.5               # + per-cycle quiesce cost
    """
    from repro_torch.faults.processes import parse_seconds

    kw = {}
    fields = {"every": "interval_s", "write": "write_s",
              "restore": "restore_s", "base": "base_s"}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        key, _, value = part.partition(":")
        if not value and key not in fields:
            # bare duration shorthand: "--checkpoint 600" = every:600
            kw["interval_s"] = parse_seconds(key)
            continue
        if key not in fields:
            raise KeyError(f"unknown checkpoint spec field {key!r} "
                           f"(expected {' | '.join(sorted(fields))})")
        kw[fields[key]] = parse_seconds(value)
    if not kw:
        raise KeyError(f"empty checkpoint spec {spec!r}")
    return CheckpointModel(**kw)


def daly_interval(write_s: float, mtbf_s: float) -> float:
    """Young/Daly first-order optimal checkpoint interval
    ``sqrt(2 * w * MTBF)`` (work between checkpoints, excluding the
    checkpoint itself)."""
    if write_s <= 0 or not math.isfinite(mtbf_s):
        return math.inf
    return math.sqrt(2.0 * write_s * mtbf_s)
