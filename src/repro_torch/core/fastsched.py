"""Batched tape scheduler: record one dataflow walk, replay it cheaply.

The legacy :meth:`Engine.simulate` walk interleaves three kinds of work per
op: *structure* (operand resolution, call/while-body regex dispatch),
*pricing* (``op_time`` + the memory model's channel split), and
*scheduling* (claiming unit/channel/link clocks).  Structure and pricing
are pure in ``(module, hw, knobs, fabric)`` — only the scheduling
arithmetic depends on the clock state — so the first walk records them
onto a :class:`ModuleTape` and every later simulation replays the tape as
a tight loop of clock arithmetic over the precomputed dependency slots
(the topological wavefront, flattened into program order).

Replay is *bit-exact* with the legacy walk: steps execute in the same
order, dependency maxima keep the same first-maximal tie-breaks, link
clocks are created in the same lazy order, and every float accumulates in
the same sequence.  The equivalence suite in ``tests/test_fastcore.py``
asserts ``SimReport.summary()`` equality between the two schedulers.

Delta re-simulation tiers (used by :class:`~repro_torch.core.engine.Engine` via
the :class:`~repro_torch.core.engine.SimulationCache` tape registry):

* same ``(module, hw, knobs, faults)`` — replay the tape directly (a
  ``window=`` change re-simulates without re-pricing anything);
* ici-family-only change (a different broken-link set / fabric state) —
  :func:`reprice_ici` rebuilds ONLY the collective steps' prices through
  the new fabric and leaves compute/memory pricing untouched;
* anything else (hw, memory model, stream count) — full re-record.

Step encoding (plain tuples, dispatched on the leading int):

* ``(SKIP, out, deps)`` — zero-cost dataflow plumbing: propagate readiness;
* ``(EXEC, out, deps, idx, node_id, ot, scale, chans, links, cbytes,
  spill, comp_name, op)`` — one priced op claiming its clocks;
* ``(CALL, out, deps, substeps, sub_root, sub_lasts)`` — nested frame;
* ``(WHILE, out, deps, trip, substeps, sub_root, sub_lasts)`` — one
  detailed iteration + resource push-forward, exactly the legacy model.

``deps`` are indices into a flat ready-slot array: each value the walk
publishes gets a fresh slot, and operand lookups are frozen to the slot
they resolved to at record time (re-invocations of a computation allocate
new slots, so stale-read semantics match the legacy dict exactly).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

SKIP, EXEC, CALL, WHILE = 0, 1, 2, 3


class ModuleTape:
    """One recorded entry-walk of a module under fixed (hw, knobs, fabric).

    Holds the flattened step program plus the memory model's whole-run
    outputs (the allocator map is deterministic in program order, so it is
    recorded once and shared by every replayed report — the same
    read-only convention as :class:`SimulationCache` reports).
    """

    __slots__ = ("steps", "root_slot", "last_slots", "n_slots", "has_mem",
                 "mem_peak", "mem_channel_busy", "memmap")

    def __init__(self, steps, root_slot, last_slots, n_slots, has_mem,
                 mem_peak=0.0, mem_channel_busy=(), memmap=None):
        self.steps = steps
        self.root_slot = root_slot
        self.last_slots = last_slots
        self.n_slots = n_slots
        self.has_mem = has_mem
        self.mem_peak = mem_peak
        self.mem_channel_busy = list(mem_channel_busy)
        self.memmap = memmap


class TapeRecorder:
    """Slot allocator + frame side-channel used by the recording walk."""

    __slots__ = ("slot_of", "n", "last_frame", "pending_while")

    def __init__(self):
        self.slot_of: Dict[Tuple[str, str], int] = {}
        self.n = 0
        #: (steps, root_slot, last_slots) of the most recent run_comp frame
        self.last_frame: Optional[tuple] = None
        #: staged body of the most recent run_while (None = no body)
        self.pending_while: Optional[tuple] = None

    def slot(self, key: Tuple[str, str]) -> int:
        i = self.n
        self.n = i + 1
        self.slot_of[key] = i
        return i

    def deps(self, comp_name: str, operands) -> Tuple[int, ...]:
        """Operand ready-slots in lookup order, frozen to the slots the
        names resolve to right now (matching the legacy dict lookup)."""
        so = self.slot_of
        out = []
        for name in operands:
            s = so.get((comp_name, name))
            if s is not None:
                out.append(s)
        return tuple(out)


def replay(tape: ModuleTape, engine, window: Optional[Tuple[int, int]],
           totals_only: bool = False):
    """Re-run a recorded tape against fresh clocks — the batched scheduler.

    Mirrors the legacy walk's scheduling arithmetic statement for
    statement (candidate order, strict-greater tie-breaks, lazy link-clock
    creation, while push-forward), so the produced :class:`SimReport` is
    identical to a cold ``_walk_simulate`` of the same inputs.

    ``totals_only`` skips the report's per-op artifacts (timeline entries,
    exposure spans, critical-path attribution) while keeping the
    scheduling arithmetic bit-identical — for callers that only need the
    makespan and busy totals, like the what-if repricer, which replays
    the tape once per candidate counterfactual.
    """
    from repro_torch.core.engine import (
        Engine, RESOURCES, SimReport, TimelineEntry, _Node,
    )

    hw = engine.hw
    overlap = engine.overlap
    timeline: List[TimelineEntry] = []
    unit_seconds: Dict[str, float] = {}
    link_busy: Dict[str, float] = {}
    tot = {"flops": 0.0, "hbm": 0.0, "ici": 0.0, "spill": 0.0}
    unit_free: Dict[str, float] = {u: 0.0 for u in RESOURCES}
    unit_last: Dict[str, Optional[str]] = {u: None for u in RESOURCES}
    if tape.has_mem:
        for c in range(hw.hbm_channels):
            unit_free[f"hbm:{c}"] = 0.0
            unit_last[f"hbm:{c}"] = None
    streams: List[float] = [0.0] * engine.num_compute_streams
    stream_last: List[Optional[str]] = [None] * engine.num_compute_streams
    slots: List[Tuple[float, Optional[str]]] = [(0.0, None)] * tape.n_slots
    nodes: Dict[str, _Node] = {}
    state = {"makespan": 0.0, "makespan_node": None, "ff_overhead": 0.0}
    ff_spans: List[Tuple[float, float, str]] = []

    def run_frame(steps, base, root_slot, last_slots):
        base_t, base_pred = base
        for st in steps:
            kind = st[0]
            if kind == EXEC:
                (_k, out, deps, idx, node_id, ot, scale, chans, links,
                 cbytes, spill, comp_name, op) = st
                t, pred = base_t, base_pred
                for s in deps:
                    v = slots[s]
                    if v[0] > t:
                        t, pred = v
                unit = ot.unit
                on_ici = unit == "ici"
                cands = [(t, pred)]
                if chans:
                    for c in chans:
                        ck = f"hbm:{c}"
                        cands.append((unit_free[ck], unit_last[ck]))
                elif links:
                    for l in links:
                        cands.append((unit_free.setdefault(l, 0.0),
                                      unit_last.setdefault(l, None)))
                else:
                    cands.append((unit_free[unit], unit_last[unit]))
                si = None
                if on_ici and not overlap:
                    bi = max(range(len(streams)), key=streams.__getitem__)
                    cands.append((streams[bi], stream_last[bi]))
                elif not on_ici:
                    si = min(range(len(streams)), key=streams.__getitem__)
                    cands.append((streams[si], stream_last[si]))
                start, spred = cands[0]
                for cv in cands:
                    if cv[0] > start:
                        start, spred = cv
                finish = start + ot.seconds
                if chans:
                    for c in chans:
                        ck = f"hbm:{c}"
                        unit_free[ck] = finish
                        unit_last[ck] = node_id
                elif links:
                    for l in links:
                        unit_free[l] = finish
                        unit_last[l] = node_id
                else:
                    unit_free[unit] = finish
                    unit_last[unit] = node_id
                if on_ici and not overlap:
                    for i in range(len(streams)):
                        streams[i] = finish
                        stream_last[i] = node_id
                elif si is not None:
                    streams[si] = finish
                    stream_last[si] = node_id
                if not totals_only:
                    nodes[node_id] = _Node(unit, ot.seconds * scale,
                                           finish, spred)
                if finish > state["makespan"]:
                    state["makespan"] = finish
                    state["makespan_node"] = node_id
                if window and not (window[0] <= idx < window[1]):
                    state["ff_overhead"] += ot.overhead_s * scale
                    ff_spans.append((start, ot.seconds * scale, unit))
                elif not totals_only:
                    timeline.append(TimelineEntry(
                        op.name, op.opcode, unit, start, ot.seconds, scale,
                        ot.flops, ot.hbm_bytes, ot.ici_bytes, comp_name,
                        overhead_s=ot.overhead_s, channel_bytes=cbytes,
                        spill_bytes=spill, link_bytes=ot.link_bytes,
                        link_seconds=ot.link_seconds))
                tot["flops"] += ot.flops * scale
                tot["hbm"] += ot.hbm_bytes * scale
                tot["ici"] += ot.ici_bytes * scale
                unit_seconds[unit] = \
                    unit_seconds.get(unit, 0.0) + ot.seconds * scale
                if ot.link_seconds:
                    for l, sec in ot.link_seconds.items():
                        link_busy[l] = link_busy.get(l, 0.0) + sec * scale
                tot["spill"] += spill * scale
                slots[out] = (finish, node_id)
            elif kind == SKIP:
                _k, out, deps = st
                t, pred = base_t, base_pred
                for s in deps:
                    v = slots[s]
                    if v[0] > t:
                        t, pred = v
                slots[out] = (t, pred)
            elif kind == CALL:
                _k, out, deps, substeps, sroot, slasts = st
                t, pred = base_t, base_pred
                for s in deps:
                    v = slots[s]
                    if v[0] > t:
                        t, pred = v
                slots[out] = run_frame(substeps, (t, pred), sroot, slasts)
            else:                                  # WHILE
                _k, out, deps, trip, substeps, sroot, slasts = st
                t, pred = base_t, base_pred
                for s in deps:
                    v = slots[s]
                    if v[0] > t:
                        t, pred = v
                # loop entry is a scheduling barrier over every clock
                t0, pred0 = t, pred
                for u, tv in unit_free.items():
                    if tv > t0:
                        t0, pred0 = tv, unit_last[u]
                for i, tv in enumerate(streams):
                    if tv > t0:
                        t0, pred0 = tv, stream_last[i]
                snap_units = dict(unit_free)
                snap_streams = list(streams)
                t1, rpred = run_frame(substeps, (t0, pred0), sroot, slasts)
                t1_res = t1
                for u, tv in unit_free.items():
                    if tv > snap_units.get(u, 0.0) and tv > t1_res:
                        t1_res = tv
                for i, tv in enumerate(streams):
                    if tv > snap_streams[i] and tv > t1_res:
                        t1_res = tv
                iter_time = max(t1_res - t0, 0.0)
                extra = iter_time * (trip - 1)
                for u, tv in unit_free.items():
                    if tv > snap_units.get(u, 0.0):
                        unit_free[u] = tv + extra
                for i in range(len(streams)):
                    if streams[i] > snap_streams[i]:
                        streams[i] += extra
                t_end = t1_res + extra
                if t_end > state["makespan"]:
                    state["makespan"] = t_end
                    state["makespan_node"] = rpred
                slots[out] = (t_end, rpred)
        if root_slot is not None:
            return slots[root_slot]
        t, pred = base_t, base_pred
        for s in last_slots:
            v = slots[s]
            if v[0] > t:
                t, pred = v
        return (t, pred)

    root_t, root_pred = run_frame(tape.steps, (0.0, None), tape.root_slot,
                                  tape.last_slots)
    if root_t > state["makespan"]:
        state["makespan"] = root_t
        state["makespan_node"] = root_pred
    total = state["makespan"]
    compute_seconds = sum(v for u, v in unit_seconds.items() if u != "ici")
    ici_seconds = unit_seconds.get("ici", 0.0)
    if totals_only:
        exposed: Dict[str, float] = {}
        critical_path: Dict[str, float] = {}
    else:
        exposed = Engine._exposure(timeline, ff_spans)
        critical_path = Engine._critical_path(nodes,
                                              state["makespan_node"])
    return SimReport(
        total_seconds=total,
        compute_seconds=compute_seconds,
        ici_seconds=ici_seconds,
        exposed_ici_seconds=exposed.get("ici", 0.0),
        unit_seconds=unit_seconds,
        total_flops=tot["flops"],
        total_hbm_bytes=tot["hbm"],
        total_ici_bytes=tot["ici"],
        timeline=timeline,
        hw=hw,
        exposed_seconds=exposed,
        critical_path_seconds=critical_path,
        ff_overhead_seconds=state["ff_overhead"],
        peak_hbm_bytes=tape.mem_peak if tape.has_mem else 0.0,
        spill_bytes=tot["spill"],
        channel_busy_seconds=list(tape.mem_channel_busy),
        memory=tape.memmap,
        link_busy_seconds=link_busy,
    )


def map_exec_steps(steps, fn):
    """Rebuild a step list with ``fn`` applied to every EXEC tuple,
    recursing through CALL/WHILE sub-frames.  ``fn(step) -> step`` returns
    a replacement EXEC tuple (or the input unchanged); every other step
    kind passes through untouched.  This is the one structural walker the
    delta tiers (:func:`reprice_ici`) and the counterfactual price
    patchers (:mod:`repro_torch.obs.whatif`) share, so a step-encoding change
    only has to be taught here."""
    out = []
    for st in steps:
        kind = st[0]
        if kind == EXEC:
            out.append(fn(st))
        elif kind == CALL:
            out.append((CALL, st[1], st[2], map_exec_steps(st[3], fn),
                        st[4], st[5]))
        elif kind == WHILE:
            out.append((WHILE, st[1], st[2], st[3],
                        map_exec_steps(st[4], fn), st[5], st[6]))
        else:
            out.append(st)
    return out


def patched_tape(tape: ModuleTape, fn) -> ModuleTape:
    """A new tape sharing ``tape``'s structure with ``fn`` mapped over its
    EXEC steps (see :func:`map_exec_steps`).  Slot layout and the memory
    model's whole-run outputs are shared read-only — price patches never
    move allocations."""
    return ModuleTape(map_exec_steps(tape.steps, fn), tape.root_slot,
                      tape.last_slots, tape.n_slots, tape.has_mem,
                      tape.mem_peak, tape.mem_channel_busy, tape.memmap)


def reprice_ici(tape: ModuleTape, mod, hw, fabric) -> Optional[ModuleTape]:
    """Delta tier: rebuild ONLY the collective steps' prices through a new
    fabric state (e.g. a different broken-link set), reusing every
    compute/memory recording.

    Sound because a fabric change can only alter a collective's seconds
    and per-link split — its unit stays ``ici``, its HBM-side bytes (and
    therefore the memory model's channel vector) are payload-determined,
    and the memory allocator never sees the fabric.  Returns ``None`` when
    a repriced step unexpectedly leaves the ici family (caller falls back
    to a full re-record); propagates the same ``ValueError`` a cold
    simulation would raise on a partitioned fabric.
    """
    from repro_torch.core.timing import op_time

    def redo(st):
        if st[5].unit != "ici":
            return st
        (_k, slot_out, deps, idx, node_id, _ot, scale, chans, _lnk,
         cbytes, spill, comp_name, op) = st
        comp = mod.computations[comp_name]
        ot2 = op_time(mod, comp, op, hw, fabric=fabric)
        if ot2.unit != "ici":
            raise _UnitFlip()
        links2 = sorted(ot2.link_seconds) if ot2.link_seconds else None
        return (EXEC, slot_out, deps, idx, node_id, ot2, scale,
                chans, links2, cbytes, spill, comp_name, op)

    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.obs.trace import TRACER
    with TRACER.span("fastsched.reprice_ici"):
        try:
            steps = map_exec_steps(tape.steps, redo)
        except _UnitFlip:
            REGISTRY.counter("tape_reprice_fallbacks_total").inc()
            return None
    REGISTRY.counter("tape_reprices_total").inc()
    return ModuleTape(steps, tape.root_slot, tape.last_slots, tape.n_slots,
                      tape.has_mem, tape.mem_peak, tape.mem_channel_busy,
                      tape.memmap)


class _UnitFlip(Exception):
    """A repriced collective left the ici unit family (see reprice_ici)."""
