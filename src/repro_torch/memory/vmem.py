"""VMEM working-set model: over-capacity working sets become spill traffic.

TPU compute streams operands through VMEM (the on-chip scratchpad,
``HardwareSpec.vmem_bytes``).  First-order residency model: an op's working
set is the sum of its boundary tensors (operands + outputs — fusion
interiors never leave VMEM by construction, so boundaries are exactly what
must be resident).  When the working set exceeds capacity the compiler has
to spill: the overflow is written back to HBM and re-read, so the op pays
``2 x overflow`` extra HBM bytes.  The spill stream is compiler-managed and
contiguous, so it stripes evenly across channels (it never camps).

This is the piece that turns "this model is too big for VMEM" from a silent
non-event into extra simulated HBM time — the memory-hierarchy fidelity the
end-to-end-simulator surveys call out as separating usable simulators from
toy analytical models.
"""
from __future__ import annotations

from repro_torch.core.hlo_ir import Computation, SimModule, SimOp


def working_set_bytes(mod: SimModule, comp: Computation, op: SimOp) -> int:
    """Boundary bytes that must be VMEM-resident while ``op`` runs."""
    total = op.out_bytes
    for name in op.operands:
        for s in mod.op_shape(comp, name):
            total += s.bytes
    return total


def spill_bytes(working_set: int, vmem_capacity: int) -> int:
    """Extra HBM traffic from a VMEM-overflowing working set.

    ``2 x max(ws - capacity, 0)``: the overflow is spilled (written) and
    filled (re-read) once.  Zero/negative capacity disables the model
    (infinite VMEM) rather than spilling everything.
    """
    if vmem_capacity <= 0:
        return 0
    return 2 * max(int(working_set) - int(vmem_capacity), 0)
