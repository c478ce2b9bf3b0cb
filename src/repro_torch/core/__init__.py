"""repro_torch.core — the simulator, driven by PyTorch captures.

Facade:

    sim = Simulator(hw=H100)
    cap = sim.capture(step_fn, *example_args)   # aten graph -> SimOp IR
    rep = sim.performance(cap)                  # detailed timeline (SimReport)

The engine, timing, memory and topology models are copies of the reference
package's; only the capture frontend is new.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.core.capture import Captured, capture
from repro_torch.core.collectives import collective_time
from repro_torch.core.engine import Engine, SimReport, SimulationCache
from repro_torch.core.hlo_ir import SimModule, parse_hlo_module, summarize_collectives
from repro_torch.core.hw import CHIPS, H100, V5E, V5P, HardwareSpec


class Simulator:
    """One-stop facade over capture and the engine."""

    def __init__(self, hw: HardwareSpec = H100, overlap_collectives: bool = True,
                 num_compute_streams: int = 1, memory_model: bool = True,
                 topology_model: bool = True, scheduler: str = "batched"):
        self.hw = hw
        self.engine = Engine(hw, overlap_collectives, num_compute_streams,
                             memory_model=memory_model,
                             topology_model=topology_model,
                             scheduler=scheduler)

    def capture(self, fn, *example_args, **kw) -> Captured:
        return capture(fn, *example_args, **kw)

    def performance(self, captured: Captured,
                    window: Optional[Tuple[int, int]] = None) -> SimReport:
        return self.engine.simulate(captured.module, window=window)


__all__ = [
    "Simulator", "Captured", "capture", "Engine", "SimReport",
    "SimulationCache", "SimModule", "parse_hlo_module", "summarize_collectives",
    "HardwareSpec", "H100", "V5E", "V5P", "CHIPS", "collective_time",
]
