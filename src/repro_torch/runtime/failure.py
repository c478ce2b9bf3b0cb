"""Failure & straggler injection for the fault-tolerance loop.

A copy of ``repro.runtime.failure``, which holds no framework code.

On real clusters failures arrive as device errors / heartbeat timeouts; here a
``FailurePlan`` injects them deterministically so the recovery logic is
testable: the trainer must (a) checkpoint at cadence, (b) detect the failure,
(c) rebuild a (possibly smaller) mesh, (d) restore and continue — the
elastic-rescale path exercised by tests/test_fault_tolerance.py.

Two clock modes:

* **live** (default): :meth:`FailurePlan.straggle` really sleeps, so the
  trainer's wall-clock straggler detector sees the delay the way a real
  slow host would produce it;
* **simulated** (``simulated=True``): no real sleep — ``straggle`` just
  *returns* the injected seconds and the trainer folds them into its
  measured step time.  Tests (and the fleet simulator, which prices
  everything on a virtual clock) exercise the identical detection and
  elastic-rescale paths without burning wall-clock time.

Failures registered for the same step accumulate (two hosts dying in the
same heartbeat window lose the sum of their devices), matching how the
cluster loop drains simultaneous outage events.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class NodeFailure(RuntimeError):
    """Raised mid-training when the failure plan triggers."""

    def __init__(self, step: int, lost_devices: int):
        super().__init__(f"injected node failure at step {step} "
                         f"(lost {lost_devices} devices)")
        self.step = step
        self.lost_devices = lost_devices


@dataclass
class FailurePlan:
    """fail_at_step -> number of devices lost."""
    failures: Dict[int, int] = field(default_factory=dict)
    # straggler injection: step -> extra seconds of injected delay
    stragglers: Dict[int, float] = field(default_factory=dict)
    # simulated clock: straggle() reports delays instead of sleeping
    simulated: bool = False
    _fired: set = field(default_factory=set)

    def add_failure(self, step: int, lost_devices: int = 1) -> None:
        """Register one more failure at ``step``; simultaneous failures at
        the same step accumulate their lost-device counts."""
        self.failures[step] = self.failures.get(step, 0) + lost_devices

    def check(self, step: int) -> None:
        if step in self.failures and step not in self._fired:
            self._fired.add(step)
            raise NodeFailure(step, self.failures[step])

    def straggle(self, step: int) -> float:
        """Returns injected per-step delay (the trainer's deadline logic
        measures it and reports mitigation).  Sleeps for real only on the
        live clock; ``simulated`` plans never block."""
        delay = self.stragglers.get(step, 0.0)
        if delay and not self.simulated:
            time.sleep(delay)
        return delay
