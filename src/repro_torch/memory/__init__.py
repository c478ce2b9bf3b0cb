"""repro_torch.memory — the memory hierarchy as a first-class simulated resource.

The paper's partition-camping finding (§V, Figs. 22-25) is a *memory*
pathology: aggregate DRAM bandwidth looks healthy while a few partitions
saturate and gate the kernel.  Before this subsystem the repo only
*detected* camping post hoc (:mod:`repro_torch.analysis.channels` re-hashed bytes
after the run) while the engine timed every op against one flat ``hbm``
clock — camping could never actually slow the simulated timeline.  This
package makes memory mechanism, not annotation:

* :mod:`repro_torch.memory.allocator` — live-range buffer allocator over the
  ``hlo_ir`` def-use edges (linear scan in schedule order): HBM placements,
  peak footprint, oversubscription report;
* :mod:`repro_torch.memory.channels` — address-interleaved per-channel HBM
  model + the single-sourced camping classifier (previously duplicated in
  ``repro_torch.core.vision`` and ``repro_torch.analysis.channels``);
* :mod:`repro_torch.memory.vmem`     — VMEM working-set model: over-capacity
  working sets become spill HBM traffic;
* :class:`MemoryModel`          — the per-simulation facade the engine
  drives: one :meth:`visit` per op in schedule order (allocator step), one
  :meth:`time_op` per scheduled op (channel split + spill + HBM re-timing).

``Engine.simulate`` consults it by default (``memory_model=True``): HBM op
durations become ``max_over_channels(bytes_on_channel / per_channel_bw)``,
HBM ops contend per channel instead of on one flat clock, and ``SimReport``
gains ``peak_hbm_bytes`` / ``spill_bytes`` / ``channel_busy_seconds``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.hlo_ir import Computation, SimModule, SimOp
from repro_torch.core.hw import HardwareSpec
from repro_torch.core.timing import OpTime
from repro_torch.memory.allocator import AllocationMap, Buffer, LinearScanAllocator
from repro_torch.memory.channels import (
    CAMPING_FRACTION, CAMPING_OPS, add_striped, camped_channel_count,
    camped_start_channel, channel_bytes_for, channel_time,
    hbm_transfer_seconds, is_camping_op, legacy_channel_bytes,
)
from repro_torch.memory.vmem import spill_bytes, working_set_bytes

#: opcodes whose output aliases (a view of) their operands — no new buffer.
ALIAS_OPS = ("tuple", "get-tuple-element", "bitcast", "after-all", "domain",
             "opt-barrier", "while")

#: opcodes that neither define nor alias trackable storage here.
NO_BUFFER_OPS = ("partition-id", "replica-id", "call", "conditional")


@dataclass
class MemOp:
    """Memory-model verdict for one scheduled op."""

    ot: OpTime                          # (possibly re-timed) op time
    channel_bytes: Optional[List[float]]  # per-iteration HBM bytes per channel
    channels: Optional[List[int]]       # channel clocks an hbm op must claim
    spill_bytes: int                    # per-iteration VMEM spill traffic
    working_set: int                    # boundary bytes during execution


@dataclass
class _InvState:
    """Per-invocation linear-scan bookkeeping."""

    comp: str
    index: int = 0                                  # next op's program index
    defined: List[Buffer] = field(default_factory=list)
    lu_of: Dict[str, int] = field(default_factory=dict)
    # buffer node_id -> current release index (-1 = at invocation close);
    # alias ops BUMP their sources' indices, so a value threaded through
    # tuple/get-tuple-element/while stays live as long as its last view
    by_lu: Dict[int, List[Buffer]] = field(default_factory=dict)
    # release index -> buffers dying there (kept in sync with lu_of, so a
    # release touches only the buffers actually dying, not every buffer
    # the invocation ever defined)
    deferred: Dict[str, int] = field(default_factory=dict)
    # while/call op name -> its index: operand releases held until the
    # sub-invocation finishes (the carry/arguments stay live inside it)

    def set_lu(self, buf: Buffer, lu: int) -> None:
        cur = self.lu_of.get(buf.node_id)
        if cur == lu:
            return
        if cur is not None:
            old = self.by_lu.get(cur)
            if old is not None:
                old[:] = [b for b in old if b is not buf]
        self.lu_of[buf.node_id] = lu
        self.by_lu.setdefault(lu, []).append(buf)


class MemoryModel:
    """Per-simulation memory state: allocator + channel splitter + VMEM.

    One instance per :meth:`Engine.simulate` call.  The engine calls
    :meth:`visit` for EVERY op in program order (aliases included, so
    last-use indices line up), :meth:`time_op` for each scheduled op,
    :meth:`account` with the op's trip scale, and :meth:`close_invocation`
    when a computation invocation returns.  :meth:`finish` seals the
    allocation map.
    """

    def __init__(self, mod: SimModule, hw: HardwareSpec):
        self.mod = mod
        self.hw = hw
        self.alloc = LinearScanAllocator(hw.hbm_bytes)
        self.channel_busy: List[float] = [0.0] * hw.hbm_channels
        self._placements: Dict[Tuple[int, str], List[Buffer]] = {}
        self._inv: Dict[int, _InvState] = {}
        self._last_use_cache: Dict[str, Dict[str, int]] = {}
        self._entry_inv: Optional[int] = None

    # ------------------------------------------------------------------
    # allocator walk
    # ------------------------------------------------------------------
    def visit(self, inv: int, comp: Computation, op: SimOp) -> None:
        """Linear-scan step for one op, in program order."""
        if self._entry_inv is None:
            self._entry_inv = inv
        state = self._inv.setdefault(inv, _InvState(comp.name))
        idx = state.index
        state.index += 1
        last_use = self._last_use(comp)

        if op.opcode in ALIAS_OPS:
            # a view: propagate the operands' buffers, allocate nothing —
            # and keep the sources alive as long as the VIEW is (a value
            # threaded through tuple/gte/while must not be freed at the
            # alias op while consumers of the view still read it)
            bufs: List[Buffer] = []
            for name in op.operands:
                bufs.extend(self._placements.get((inv, name), ()))
            self._placements[(inv, op.name)] = bufs
            alias_lu = last_use.get(op.name, -1)
            if op.name == comp.root:
                alias_lu = -1
            for buf in bufs:
                cur = state.lu_of.get(buf.node_id)
                if cur is None or cur == -1:
                    continue
                state.set_lu(buf, -1 if alias_lu == -1
                             else max(cur, alias_lu))
        elif op.opcode in NO_BUFFER_OPS:
            self._placements[(inv, op.name)] = []
        elif op.opcode == "parameter" and inv != self._entry_inv:
            # sub-computation parameters alias caller values we do not track
            # across the call boundary; entry parameters below ARE buffers
            # (the resident weights — the footprint's floor)
            self._placements[(inv, op.name)] = []
        else:
            node_id = f"{inv}:{comp.name}/{op.name}"
            buf = self.alloc.define(node_id, op.name, comp.name, op.out_bytes)
            lu = last_use.get(op.name, -1)
            if op.opcode == "parameter" or op.name == comp.root:
                lu = -1        # resident until the invocation closes
            state.defined.append(buf)
            state.set_lu(buf, lu)
            self._placements[(inv, op.name)] = [buf]

        # free buffers whose live range ends at this op (AFTER it executes,
        # so an op's inputs and output coexist at the peak).  A while/call
        # keeps its operands live until the sub-invocation it triggers has
        # finished — the engine recurses into the body/callee after this
        # visit returns, and the loop carry / call arguments must not be
        # reused for body buffers while the body still reads them; the
        # engine signals completion via :meth:`after_subcomputation`.
        if op.opcode in ("while", "call"):
            state.deferred[op.name] = idx
        else:
            self._release_at(state, idx)

    def after_subcomputation(self, inv: int, op: SimOp) -> None:
        """Perform the releases deferred at a while/call op's visit, once
        the engine has finished simulating the sub-invocation."""
        state = self._inv.get(inv)
        if state is None:
            return
        idx = state.deferred.pop(op.name, None)
        if idx is not None:
            self._release_at(state, idx)

    def _release_at(self, state: _InvState, idx: int) -> None:
        for buf in state.by_lu.pop(idx, ()):
            self.alloc.release(buf.node_id)

    def close_invocation(self, inv: int) -> None:
        """Release everything the invocation still holds (params, root)."""
        state = self._inv.get(inv)
        if state is None:
            return
        for buf in state.defined:
            self.alloc.release(buf.node_id)

    def finish(self) -> AllocationMap:
        return self.alloc.finish()

    def _last_use(self, comp: Computation) -> Dict[str, int]:
        """Cached :meth:`hlo_ir.Computation.last_use` for ``comp``."""
        cached = self._last_use_cache.get(comp.name)
        if cached is None:
            cached = comp.last_use()
            self._last_use_cache[comp.name] = cached
        return cached

    # ------------------------------------------------------------------
    # timing
    # ------------------------------------------------------------------
    def time_op(self, inv: int, comp: Computation, op: SimOp,
                ot: OpTime) -> MemOp:
        """Re-time one scheduled op under the memory hierarchy.

        Splits its HBM traffic (plus any VMEM spill) into a per-channel
        vector and replaces the flat-clock HBM time with the busiest
        channel's time; an op the channel model makes bandwidth-gated flips
        to the ``hbm`` unit.  Collectives keep their ICI timing (their HBM
        side is staged behind the transfer) but still report a channel
        split for the analysis layer.
        """
        n_ch = self.hw.hbm_channels
        ws = working_set_bytes(self.mod, comp, op)
        if ot.unit == "ici":
            vec = channel_bytes_for(op.opcode, op.name, ot.hbm_bytes, n_ch,
                                    self._base_offset(inv, op),
                                    self.hw.hbm_interleave_bytes)
            return MemOp(ot, vec, None, 0, ws)
        if ot.hbm_bytes <= 0 and ot.flops <= 0:
            return MemOp(ot, None, None, 0, ws)

        spill = spill_bytes(ws, self.hw.vmem_bytes)
        vec = channel_bytes_for(op.opcode, op.name, ot.hbm_bytes, n_ch,
                                self._base_offset(inv, op),
                                self.hw.hbm_interleave_bytes)
        add_striped(vec, spill)   # spill streams are contiguous: never camp
        t_hbm = channel_time(vec, self.hw.hbm_channel_bw)

        core = ot.seconds - ot.overhead_s
        unit, seconds = ot.unit, ot.seconds
        if t_hbm > core:
            unit = "hbm"
            seconds = t_hbm + ot.overhead_s
        elif ot.unit == "hbm":
            seconds = max(t_hbm, core) + ot.overhead_s
        new_ot = OpTime(seconds, unit, ot.flops, ot.hbm_bytes + spill,
                        ot.ici_bytes, detail=ot.detail,
                        overhead_s=ot.overhead_s)
        channels = [c for c, v in enumerate(vec) if v > 0] \
            if unit == "hbm" else None
        return MemOp(new_ot, vec, channels, spill, ws)

    def account(self, mo: MemOp, scale: float) -> None:
        """Accumulate per-channel transfer busy seconds (trip-scaled)."""
        if not mo.channel_bytes:
            return
        bw = self.hw.hbm_channel_bw
        if bw <= 0:
            return
        for c, v in enumerate(mo.channel_bytes):
            self.channel_busy[c] += v / bw * scale

    def _base_offset(self, inv: int, op: SimOp) -> Optional[int]:
        """Address anchor for a camping subset: the first placed operand
        (the table a gather reads), else the op's own output buffer."""
        for name in op.operands:
            for buf in self._placements.get((inv, name), ()):
                if buf.size > 0:
                    return buf.offset
        for buf in self._placements.get((inv, op.name), ()):
            if buf.size > 0:
                return buf.offset
        return None


__all__ = [
    "MemoryModel", "MemOp", "AllocationMap", "Buffer", "LinearScanAllocator",
    "CAMPING_FRACTION", "CAMPING_OPS", "is_camping_op", "camped_channel_count",
    "camped_start_channel", "channel_bytes_for", "channel_time",
    "hbm_transfer_seconds", "legacy_channel_bytes", "add_striped",
    "spill_bytes", "working_set_bytes", "ALIAS_OPS", "NO_BUFFER_OPS",
]
