"""Per-op timing model (the detailed performance model of the paper, for TPU).

Each HLO op is assigned a duration = max over the hardware resources it
occupies (MXU, VPU, transcendental unit, HBM) — i.e. a per-op roofline with
occupancy corrections:

* dot/conv: FLOPs / (peak * mxu_efficiency(M,N,K)), where efficiency models
  128x128 systolic-tile padding waste (the TPU analogue of warp occupancy);
* fusions: interior FLOPs on VPU + boundary bytes on HBM;
* dtype awareness: fp32 dots run at 1/4 bf16 peak;
* a fixed per-op issue overhead (XLA dispatch), which dominates tiny decode
  ops exactly the way kernel-launch overhead dominates small cuDNN kernels
  in the paper's Fig. 7 (LRN/CGEMM discrepancy discussion).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.hlo_ir import Computation, SimModule, SimOp, _CONTRACT_RE
from repro_torch.core.hw import HardwareSpec


@dataclass
class OpTime:
    seconds: float         # modeled duration, INCLUDING launch overhead
    unit: str              # "mxu" | "vpu" | "hbm" | "ici" | "overhead"
    flops: float
    hbm_bytes: float
    ici_bytes: float = 0.0
    detail: str = ""
    overhead_s: float = 0.0  # issue-cost portion of ``seconds`` (XLA dispatch)
    #: per-link busy seconds / bytes of a topology-lowered collective
    #: (keys = "ici:<src>-<dst>"); None on non-collectives and the flat path
    link_seconds: Optional[Dict[str, float]] = None
    link_bytes: Optional[Dict[str, float]] = None


def _dot_dims(mod: SimModule, comp: Computation, op: SimOp):
    """(M*batch, N, K) estimate for MXU efficiency."""
    out_elems = op.out_elems
    k = 1
    lhs = mod.op_shape(comp, op.operands[0]) if op.operands else []
    m = _CONTRACT_RE.search(op.raw)
    if lhs and m:
        for d in [int(x) for x in m.group(1).split(",") if x]:
            if d < len(lhs[0].dims):
                k *= lhs[0].dims[d]
    n = op.outputs[0].dims[-1] if op.outputs and op.outputs[0].dims else 1
    mrows = max(out_elems // max(n, 1), 1)
    return mrows, n, k


def op_time(mod: SimModule, comp: Computation, op: SimOp,
            hw: HardwareSpec, fabric=None) -> OpTime:
    """``fabric`` (a :class:`repro_torch.topology.FabricModel`) switches collective
    timing from the flat analytic path to per-link topology lowering — the
    engine passes its fabric when ``topology_model`` is on."""
    oc = op.opcode
    flops = mod.op_flops(comp, op)
    hbm = mod.op_hbm_bytes(comp, op)
    ci = mod.collective_info(op)
    if ci:
        from repro_torch.core.collectives import collective_time
        ct = collective_time(ci["kind"], ci["payload"], ci["group"], hw,
                             inter_pod=ci["group"] > 256, fabric=fabric,
                             members=ci.get("members"),
                             pairs=ci.get("pairs"))
        sched = ct.schedule
        return OpTime(ct.seconds + hw.op_launch_overhead_s, "ici",
                      0.0, hbm, ct.link_bytes,
                      detail=f"g={ci['group']}" + (
                          f" alg={sched.algorithm}" if sched else ""),
                      overhead_s=hw.op_launch_overhead_s,
                      link_seconds=dict(sched.link_seconds) if sched else None,
                      link_bytes=dict(sched.link_bytes) if sched else None)

    dtype = op.outputs[0].dtype if op.outputs else "f32"
    mxu_peak = hw.peak_bf16_flops if dtype in ("bf16", "f16") else hw.peak_f32_flops

    t_mxu = 0.0
    if flops["mxu"] > 0:
        eff = 1.0
        if oc == "dot":
            m, n, k = _dot_dims(mod, comp, op)
            eff = max(hw.matmul_efficiency(m, n, k), 1e-3)
        t_mxu = flops["mxu"] / (mxu_peak * eff)
    t_vpu = flops["vpu"] / hw.vpu_flops if flops["vpu"] else 0.0
    t_trans = flops["trans"] / hw.transcendental_flops if flops["trans"] else 0.0
    t_hbm = hbm / hw.hbm_bw

    times = {"mxu": t_mxu, "vpu": t_vpu + t_trans, "hbm": t_hbm}
    unit = max(times, key=times.get)
    dur = max(times.values())
    if dur <= 0:
        # zero-work ops still pay the documented fixed issue cost (XLA
        # dispatch) — exactly the launch-overhead tax that dominates tiny
        # kernels in the paper's Fig. 7, so they must occupy timeline span
        return OpTime(hw.op_launch_overhead_s, "overhead", 0.0, 0.0,
                      overhead_s=hw.op_launch_overhead_s)
    total_flops = flops["mxu"] + flops["vpu"] + flops["trans"]
    return OpTime(dur + hw.op_launch_overhead_s, unit, total_flops, hbm,
                  detail=f"mxu={t_mxu:.2e} vpu={t_vpu:.2e} hbm={t_hbm:.2e}",
                  overhead_s=hw.op_launch_overhead_s)
