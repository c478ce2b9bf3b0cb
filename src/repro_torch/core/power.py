"""Energy/power model (paper §IV-A, Fig. 8 — GPUWattch analogue).

First-order event energy: E = Σ (pJ/op × ops) per component + static power ×
time.  Components mirror the paper's six categories, mapped to the spec's
units (a TPU's, or the ``h100`` spec's):

    paper (GPU)      TPU spec         h100 spec
    core/ALU     ->  MXU + VPU        tensor cores + CUDA cores
    L1/L2 cache  ->  VMEM traffic     L2 traffic (approximated as 2x HBM
                                      traffic re-use)
    NOC          ->  ICI              NVLink
    DRAM         ->  HBM              HBM3
    Idle         ->  static x makespan

The constants live in :mod:`repro_torch.core.hw`, each marked there as a
data-sheet value, a published estimate or an assumption.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core.engine import SimReport
from repro_torch.core.hw import HardwareSpec, V5E


@dataclass
class PowerReport:
    energy_j: Dict[str, float]
    total_j: float
    avg_watts: float
    shares: Dict[str, float]

    def table(self) -> str:
        rows = ["component,energy_J,share"]
        for k in sorted(self.shares, key=self.shares.get, reverse=True):
            rows.append(f"{k},{self.energy_j[k]:.4f},{self.shares[k]*100:.1f}%")
        rows.append(f"TOTAL,{self.total_j:.4f},100%  (avg {self.avg_watts:.1f} W)")
        return "\n".join(rows)


def analyze_power(report: SimReport, hw: HardwareSpec = V5E,
                  vmem_reuse_factor: float = 2.0) -> PowerReport:
    mxu_flops = sum(e.flops * e.scale for e in report.timeline if e.unit == "mxu")
    vpu_flops = report.total_flops - mxu_flops
    e = {
        "mxu": mxu_flops * hw.pj_per_mxu_flop * 1e-12,
        "vpu": vpu_flops * hw.pj_per_vpu_flop * 1e-12,
        "hbm": report.total_hbm_bytes * hw.pj_per_hbm_byte * 1e-12,
        "vmem": report.total_hbm_bytes * vmem_reuse_factor
                * hw.pj_per_vmem_byte * 1e-12,
        "ici": report.total_ici_bytes * hw.pj_per_ici_byte * 1e-12,
        "idle/static": hw.static_watts * report.total_seconds,
    }
    total = sum(e.values()) or 1e-30
    return PowerReport(
        energy_j=e, total_j=total,
        avg_watts=total / max(report.total_seconds, 1e-12),
        shares={k: v / total for k, v in e.items()},
    )
