"""repro_torch.core — the simulator, driven by PyTorch captures.

Facade:

    sim = Simulator(hw=H100)
    cap = sim.capture(step_fn, *example_args)   # aten graph -> SimOp IR
    rep = sim.performance(cap)                  # detailed timeline (SimReport)
    out = sim.functional(step_fn, *real_args)   # eager execution, timed
    sim.analysis(rep)                           # phase analysis (repro_torch.analysis)
    sim.vision(rep)                             # legacy single-file vision view
    sim.power(rep)                              # GPUWattch-style breakdown
    sim.correlate(cap)                          # Fig. 6/7 correlation table
    sim.correlate(cap, card_reference(cap, *real_args))   # ... against the card

The engine, timing, memory, topology and analysis models are copies of the
reference package's; the capture frontend, the card's reference times, the
functional mode and the debugger are the port's own.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.core.capture import Captured, capture
from repro_torch.core.collectives import collective_time
from repro_torch.core.correlate import (CardReference, CorrelationReport,
                                        card_reference, correlate)
from repro_torch.core.debug import Divergence, compare_implementations, first_divergence
from repro_torch.core.engine import Engine, SimReport, SimulationCache
from repro_torch.core.functional import FunctionalResult, run_functional
from repro_torch.core.hlo_ir import SimModule, parse_hlo_module, summarize_collectives
from repro_torch.core.hw import CHIPS, H100, V5E, V5P, HardwareSpec
from repro_torch.core.power import PowerReport, analyze_power
from repro_torch.core.sim_checkpoint import CheckpointedSim, simulate_from_checkpoint
from repro_torch.core.trace import to_chrome_trace, to_csv
from repro_torch.core.vision import VisionReport, analyze as vision_analyze


class Simulator:
    """One-stop facade over capture/engine/vision/power/correlate."""

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

    def capture_bundle(self, bundle, name: str = "step", device=None) -> Captured:
        """A step bundle traced whole on fake tensors on ``device``
        (default cuda): :func:`repro_torch.core.capture.capture_bundle`."""
        from repro_torch.core.capture import capture_bundle
        return capture_bundle(bundle, name=name, device=device)

    def performance(self, captured: Captured,
                    window: Optional[Tuple[int, int]] = None) -> SimReport:
        return self.engine.simulate(captured.module, window=window)

    def functional(self, fn, *args, steps: int = 1) -> FunctionalResult:
        return run_functional(fn, *args, steps=steps)

    def analysis(self, report: SimReport, num_buckets: int = 120):
        """Phase analysis: intervals + labeled phases + HBM channel model."""
        from repro_torch.analysis import analyze
        return analyze(report, num_buckets=num_buckets, hw=self.hw)

    def vision(self, report: SimReport, num_buckets: int = 200) -> VisionReport:
        return vision_analyze(report, self.hw, num_buckets)

    def power(self, report: SimReport) -> PowerReport:
        return analyze_power(report, self.hw)

    def correlate(self, captured: Captured, reference=None) -> CorrelationReport:
        return correlate(captured, self.hw, reference)


__all__ = [
    "Simulator", "Captured", "capture", "Engine", "SimReport",
    "SimulationCache", "SimModule", "parse_hlo_module", "summarize_collectives",
    "HardwareSpec", "H100", "V5E", "V5P", "CHIPS", "collective_time",
    "correlate", "card_reference", "CardReference", "CorrelationReport",
    "first_divergence", "compare_implementations", "Divergence",
    "run_functional", "FunctionalResult", "analyze_power", "PowerReport",
    "vision_analyze", "VisionReport", "simulate_from_checkpoint",
    "CheckpointedSim", "to_chrome_trace", "to_csv",
]
