"""Fidelity-switching checkpoint (paper §III-F, Figures 4-5).

The paper's flow: run the app in cheap Functional mode to (kernel x, CTA M),
snapshot GPU state, resume the region of interest in slow Performance mode.

Here the granularity ladder is step -> HLO-op:

* ``fast_forward``: run N real training steps eagerly (functional mode),
  snapshotting state via the checkpoint store (repro_torch.checkpoint) —
  the "global memory" snapshot;
* ``detailed_window``: performance-simulate the step's captured program
  with only ops [M, M+t) in the detailed timeline (everything outside the
  window is charged analytically) — the CTA-window analogue;
* the ratio (functional step time) vs (engine walk time) is recorded, the
  paper's 7-8x functional/performance gap measurement.

The port of ``repro.core.sim_checkpoint``: the steps run eagerly on their
tensors' device, and the fast-forward clock stops only once the device has
finished them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

from repro_torch.checkpoint import save as ckpt_save
from repro_torch.core.capture import Captured
from repro_torch.core.engine import Engine, SimReport
from repro_torch.core.functional import _synchronize
from repro_torch.core.hw import H100, HardwareSpec


@dataclass
class CheckpointedSim:
    state: Any
    fast_forward_steps: int
    fast_forward_seconds: float
    report: SimReport
    engine_seconds: float

    @property
    def perf_over_functional(self) -> float:
        """How much slower per step detailed simulation is vs functional."""
        if self.fast_forward_steps == 0 or self.fast_forward_seconds == 0:
            return float("inf")
        per_step_func = self.fast_forward_seconds / self.fast_forward_steps
        return self.engine_seconds / per_step_func if per_step_func else float("inf")


def simulate_from_checkpoint(step_fn: Callable, state: Any, batch_iter,
                             captured: Captured, *,
                             fast_forward: int = 0,
                             window: Optional[Tuple[int, int]] = None,
                             checkpoint_dir: Optional[str] = None,
                             hw: HardwareSpec = H100) -> CheckpointedSim:
    """Fast-forward ``fast_forward`` functional steps (``step_fn(state,
    batch) -> (state, aux)``), optionally snapshot, then
    performance-simulate the next step (detailed in ``window``)."""
    t0 = time.time()
    for _ in range(fast_forward):
        state, _ = step_fn(state, next(batch_iter))
    _synchronize(state)
    ff_seconds = time.time() - t0
    if checkpoint_dir:
        ckpt_save(checkpoint_dir, fast_forward, state, blocking=True)

    t1 = time.time()
    engine = Engine(hw)
    report = engine.simulate(captured.module, window=window)
    engine_seconds = time.time() - t1
    return CheckpointedSim(state, fast_forward, ff_seconds, report,
                           engine_seconds)
