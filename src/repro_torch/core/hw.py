"""Hardware specifications for the performance model.

All timing/energy constants live here (one dataclass per chip) so the
simulator retargets by swapping the spec — the GPGPU-Sim analogue of the
gpgpusim.config file describing the GTX1080Ti/GTX1050 in the paper.

The TPU specs (``V5E``, ``V5P``) are kept verbatim from the reference
package so the engine parity tests compare like with like; ``H100`` is the
port's own target.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Tuple


@dataclass(frozen=True)
class HardwareSpec:
    name: str = "tpu-v5e"

    # --- compute ---
    peak_bf16_flops: float = 197e12       # per chip
    peak_f32_flops: float = 49e12         # MXU fp32 ~= 1/4 bf16
    vpu_flops: float = 4e12               # vector unit (elementwise) FLOP/s
    transcendental_flops: float = 1e12    # exp/tanh/... throughput
    mxu_tile: Tuple[int, int] = (128, 128)
    vpu_lanes: Tuple[int, int] = (8, 128)

    # --- memory ---
    hbm_bytes: int = 16 * 2**30
    hbm_bw: float = 819e9                 # B/s
    hbm_channels: int = 16                # channel model for "bank camping"
    hbm_interleave_bytes: int = 512       # address-interleave stripe width
    vmem_bytes: int = 128 * 2**20         # on-chip working-set capacity
    vmem_bw: float = 10e12                # ~VMEM bandwidth

    # --- interconnect ---
    ici_link_bw: float = 50e9             # B/s per link per direction
    ici_links_per_axis: int = 2           # bidirectional torus ring per axis
    ici_latency_s: float = 1e-6           # per-hop launch latency
    dcn_bw: float = 12.5e9                # inter-pod (DCN) per host share
    #: fabric shape for repro_torch.topology ("ring" | "ring:N" | "torus:AxB[xC]"
    #: | "fc[:N]").  The unsized default builds a per-collective-group ring,
    #: which reproduces the flat analytic model's totals exactly; a sized
    #: spec pins collectives onto one shared fabric so different replica
    #: groups contend for (or provably avoid) the same physical links.
    ici_topology: str = "ring"

    # --- overheads ---
    op_launch_overhead_s: float = 0.5e-6  # per-HLO-op issue cost

    # --- energy model (first-order; W = pJ/op * op/s) ---
    pj_per_mxu_flop: float = 0.25
    pj_per_vpu_flop: float = 1.5
    pj_per_hbm_byte: float = 7.0
    pj_per_vmem_byte: float = 0.4
    pj_per_ici_byte: float = 10.0
    static_watts: float = 60.0            # idle/static per chip

    @property
    def hbm_channel_bw(self) -> float:
        """Per-channel HBM bandwidth (the paper's per-partition bandwidth).

        An evenly interleaved transfer sees ``hbm_bw`` in aggregate; a
        transfer camping on one channel sees only this.
        """
        if self.hbm_channels <= 0:
            return self.hbm_bw
        return self.hbm_bw / self.hbm_channels

    def matmul_efficiency(self, m: int, n: int, k: int) -> float:
        """MXU systolic occupancy: padding waste for non-128-aligned dims.

        The TPU analogue of the paper's warp-occupancy concerns: a (m,n,k)
        matmul runs at peak only when every dim fills the 128x128 array.
        """
        tm, tn = self.mxu_tile

        def frac(dim, tile):
            if dim <= 0:
                return 1.0
            full = (dim + tile - 1) // tile
            return dim / (full * tile)

        return frac(m, tm) * frac(n, tn) * frac(k, 8)   # k packed by 8


def _cached_spec_hash(self: "HardwareSpec") -> int:
    """Memoized field-tuple hash (same value as the dataclass-generated
    one).  Specs key every hot cache in the stack — engine maps, simulation
    caches, lowering plans — and the 25-field tuple hash is measurable in
    the cluster loop, so it is computed once per instance."""
    try:
        return self._hash            # type: ignore[attr-defined]
    except AttributeError:
        h = hash(tuple(getattr(self, f.name)
                       for f in dataclasses.fields(self)))
        object.__setattr__(self, "_hash", h)
        return h


HardwareSpec.__hash__ = _cached_spec_hash      # type: ignore[assignment]

V5E = HardwareSpec()

V5P = HardwareSpec(
    name="tpu-v5p", peak_bf16_flops=459e12, peak_f32_flops=115e12,
    vpu_flops=8e12, hbm_bytes=95 * 2**30, hbm_bw=2765e9, hbm_channels=32,
    ici_link_bw=100e9, ici_links_per_axis=2, vmem_bytes=128 * 2**20,
)

#: NVIDIA H100 SXM.  Every rate below is a DATA-SHEET value (NVIDIA H100
#: data sheet / Hopper white paper, dense, no sparsity), not a measurement,
#: and assumes the part's full 700 W power limit; a card capped below it
#: runs slower under load.  The port runs fp32 products in full fp32 (TF32
#: off), so ``peak_f32_flops`` is the 67 TFLOP/s rate outside the tensor
#: cores, not the 495 TFLOP/s TF32 tensor-core rate.
H100 = HardwareSpec(
    name="h100",
    peak_bf16_flops=989e12,        # data sheet: bf16 tensor cores, dense
    peak_f32_flops=67e12,          # data sheet: fp32, non-tensor-core
    vpu_flops=67e12,               # data sheet: fp32 CUDA-core rate
    # assumption: 16 SFU results/clk/SM x 132 SMs x 1.98 GHz boost clock
    transcendental_flops=4.18e12,
    # assumption: the 64x64 output tile of the port's default tiled_matmul
    mxu_tile=(64, 64),
    vpu_lanes=(4, 32),             # assumption: 4 warps x 32 lanes per SM
    hbm_bytes=80 * 10**9,          # data sheet: 80 GB HBM3
    hbm_bw=3.35e12,                # data sheet: 3.35 TB/s
    # assumption: one channel per 512-bit memory controller (ten in the
    # white paper's full GH100 die)
    hbm_channels=10,
    # assumption: the 50 MB L2 (data sheet) plays VMEM's on-chip role
    vmem_bytes=50 * 10**6,
    vmem_bw=10e12,                 # assumption: L2 bandwidth, not published
    ici_link_bw=450e9,             # data sheet: NVLink 900 GB/s = 450 each way
    ici_links_per_axis=1,          # NVSwitch: one aggregate port per GPU
    ici_latency_s=1e-6,            # assumption, not measured
    dcn_bw=50e9,                   # assumption: one 400 Gb/s NIC per GPU
    # assumption: eager PyTorch dispatch + CUDA launch per op, not measured
    op_launch_overhead_s=5e-6,
    # --- energy (read by repro_torch.core.power.analyze_power) ---
    # assumption: half of the 700 W board limit spent at the dense bf16
    # tensor-core peak (data sheet): 350 W / 989e12 FLOP/s
    pj_per_mxu_flop=0.354,
    # published estimate: Horowitz, ISSCC 2014, 45 nm: an fp32 multiply
    # (3.7 pJ) and add (0.9 pJ) per 2-FLOP FMA, not scaled to the H100's
    # 4N process, so an upper bound
    pj_per_vpu_flop=2.3,
    # published estimate: O'Connor et al., MICRO 2017: HBM2 at 3.9 pJ/bit
    pj_per_hbm_byte=31.2,
    # published estimate: Horowitz, ISSCC 2014: a 64-bit read of an 8 KB
    # SRAM, 10 pJ (45 nm), for the on-chip traffic the model charges
    pj_per_vmem_byte=1.25,
    # assumption: NVLink's SerDes at 5 pJ/bit (NVIDIA quotes 1.3 pJ/bit for
    # the in-package NVLink-C2C, which is shorter)
    pj_per_ici_byte=40.0,
    # measured: the card's power.draw by nvidia-smi while it is idle with a
    # live context right after load (the serving phases), the mean of 45
    # samples over 4.5 s; other runs read 123.1-132.9 W.  The card
    # draws 70.8-73.4 W idle before any work: the static share of a step
    # is taken as the draw between kernels of a running workload, with
    # its clocks still raised (chip_smoke.py phases 1 and 13, NVIDIA H100
    # 80GB HBM3 at a 700.00 W power limit)
    static_watts=129.3,
)

CHIPS: Dict[str, HardwareSpec] = {"tpu-v5e": V5E, "tpu-v5p": V5P,
                                  "h100": H100}
