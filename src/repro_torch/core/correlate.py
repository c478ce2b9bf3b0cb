"""Correlation harness (paper §IV, Figures 6-7).

The paper correlates GPGPU-Sim cycles against GTX-1050 NVProf cycles per
kernel (72% correlation, within 30% overall).  ``correlate`` produces the
per-kernel (per-op-class) table of Fig. 7 — sim seconds vs reference
seconds and % discrepancy — and the overall Fig. 6 number.  The reference
comes from one of two sources:

  1. the roofline stand-in (the default): the captured ops' FLOPs and bytes
     at the spec's peaks, with no occupancy or overhead corrections — an
     independent cost model in NVProf's role;
  2. :func:`card_reference`: the card's own kernel times for the captured
     program, the counterpart of the reference package's "real TPU
     profile".  It runs the captured aten graph itself on real tensors, node
     by node, under ``torch.profiler``, and sums each node's device time per
     HLO opcode through the instructions the capture emitted for that node
     (a node of several opcodes is a class of its own).  So the ops that
     are simulated are the ops that are timed.
"""
from __future__ import annotations

import bisect
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from repro_torch.core.capture import Captured
from repro_torch.core.engine import Engine
from repro_torch.core.hw import HardwareSpec, V5E

#: prefix of the profiler range around each graph node
NODE_RANGE = "repro_torch.node::"
#: the profiler range around each run of a profiled program
RUN_RANGE = "repro_torch.run"


def _is_range(name: str) -> bool:
    return name.startswith((NODE_RANGE, RUN_RANGE))


@dataclass
class KernelRow:
    kernel: str              # op-class (dot / fusion / all-reduce / ...)
    sim_seconds: float
    ref_seconds: float

    @property
    def discrepancy(self) -> float:
        if self.ref_seconds <= 0:
            return 0.0 if self.sim_seconds <= 0 else float("inf")
        return abs(self.sim_seconds - self.ref_seconds) / self.ref_seconds


@dataclass
class CorrelationReport:
    rows: List[KernelRow]
    sim_total: float
    ref_total: float
    correlation: float       # Pearson r over per-class times

    @property
    def overall_discrepancy(self) -> float:
        if self.ref_total <= 0:
            return float("inf")
        return abs(self.sim_total - self.ref_total) / self.ref_total

    def table(self) -> str:
        rows = ["kernel,sim_s,ref_s,discrepancy"]
        for r in sorted(self.rows, key=lambda r: -r.ref_seconds):
            rows.append(f"{r.kernel},{r.sim_seconds:.3e},{r.ref_seconds:.3e},"
                        f"{r.discrepancy*100:.1f}%")
        rows.append(f"TOTAL,{self.sim_total:.3e},{self.ref_total:.3e},"
                    f"{self.overall_discrepancy*100:.1f}%  r={self.correlation:.3f}")
        return "\n".join(rows)


def _roofline_seconds(mod, comp, op, hw: HardwareSpec) -> float:
    """One instruction's pure-roofline time on ``hw``."""
    ci = mod.collective_info(op)
    if ci:
        from repro_torch.core.collectives import collective_time
        return collective_time(ci["kind"], ci["payload"], ci["group"], hw).seconds
    f = mod.op_flops(comp, op)
    hbm = mod.op_hbm_bytes(comp, op)
    return max(f["mxu"] / hw.peak_bf16_flops,
               (f["vpu"] + f["trans"]) / hw.vpu_flops,
               hbm / hw.hbm_bw)


def _xla_roofline_reference(captured: Captured, hw: HardwareSpec,
                            trip_scale: float) -> Dict[str, float]:
    """Per-op-class reference seconds from my IR's flops/bytes but the PURE
    roofline (no occupancy/overhead corrections) — the independent cost model
    playing NVProf's role, scaled by while-loop trip counts."""
    mod = captured.module
    ref: Dict[str, float] = {}
    for op, comp, scale in mod.walk_entry():
        t = _roofline_seconds(mod, comp, op, hw)
        ref[op.opcode] = ref.get(op.opcode, 0.0) + t * scale
    return ref


def correlate(captured: Captured, hw: HardwareSpec = V5E,
              reference: Optional[Dict[str, float]] = None
              ) -> CorrelationReport:
    """reference: per-op-class seconds (e.g. :func:`card_reference`, whose
    ``instruction_class`` also regroups the simulated side); defaults to
    the roofline stand-in."""
    engine = Engine(hw)
    report = engine.simulate(captured.module)
    regroup = reference.instruction_class if isinstance(reference, CardReference) else {}
    sim: Dict[str, float] = {}
    for e in report.timeline:
        c = regroup.get(e.name, e.opcode)
        sim[c] = sim.get(c, 0.0) + e.duration * e.scale
    ref = reference if reference is not None else _xla_roofline_reference(
        captured, hw, 1.0)
    classes = sorted(set(sim) | set(ref))
    rows = [KernelRow(c, sim.get(c, 0.0), ref.get(c, 0.0)) for c in classes]
    xs = np.array([r.sim_seconds for r in rows])
    ys = np.array([r.ref_seconds for r in rows])
    if len(rows) > 1 and xs.std() > 0 and ys.std() > 0:
        r = float(np.corrcoef(xs, ys)[0, 1])
    else:
        r = 1.0
    return CorrelationReport(rows, float(xs.sum()), float(ys.sum()), r)


class CardReference(dict):
    """Measured seconds a run per op class (the ``reference`` that
    :func:`correlate` takes), with what they were made from:

    * ``clock`` — ``"device"`` (kernel time on the card) or ``"cpu"``
      (profiler CPU time of each node's operators, on CPU tensors);
    * ``node_seconds`` — each timed node's seconds a run, by node name;
    * ``instruction_class`` — the class of each instruction of a node that
      was emitted as several opcodes (the flash op: two ``dot`` and an
      ``exponential``): the node's operator, e.g.
      ``repro_torch::flash_attention``, on both sides of the table, as the
      card times the node and not its instructions;
    * ``profile_seconds`` — all the work the measured runs issued, a run:
      every device kernel, copy and set (the CPU clock: every outermost
      operator);
    * ``counts`` — the same work a run by name, to be held to that of the
      program called as it is (``profile_runs`` of ``captured.graph``);
    * ``unattributed`` — (name, seconds a run) of the work that fell under
      no node's range;
    * ``runs`` — the profiled runs of the graph.
    """

    def __init__(self, per_class: Dict[str, float], *, clock: str,
                 node_seconds: Dict[str, float], instruction_class: Dict[str, str],
                 profile_seconds: float, counts: Dict[str, float],
                 unattributed: List[Tuple[str, float]], runs: int):
        super().__init__(per_class)
        self.clock = clock
        self.node_seconds = node_seconds
        self.instruction_class = instruction_class
        self.profile_seconds = profile_seconds
        self.counts = counts
        self.unattributed = unattributed
        self.runs = runs

    @property
    def attributed_seconds(self) -> float:
        return sum(self.node_seconds.values())


class _NodeRanges(torch.fx.Interpreter):
    """Runs a graph with every computing node inside a profiler range named
    after it."""

    def run_node(self, n: torch.fx.Node):
        if n.op != "call_function":
            return super().run_node(n)
        with torch.profiler.record_function(NODE_RANGE + n.name):
            return super().run_node(n)


def _does_work(mod, comp, op) -> bool:
    """Whether an instruction moves bytes, computes or communicates (a
    ``bitcast`` or a ``tuple`` does none of these)."""
    return bool(mod.collective_info(op)) or mod.op_hbm_bytes(comp, op) > 0 or any(
        v > 0 for v in mod.op_flops(comp, op).values())


def _attribute(items, ranges):
    """Hands each piece of measured work to the node range that holds the
    moment it was issued.

    ``items``: (issued at, microseconds, name), the time ``None`` when the
    issuing call is unknown; ``ranges``: (start, end, node), sorted and not
    overlapping.  Returns (microseconds by node, microseconds by name of the
    work under no range)."""
    starts = [r[0] for r in ranges]
    node_us: Dict[str, float] = {}
    left: Dict[str, float] = {}
    for at, us, name in items:
        i = bisect.bisect_right(starts, at) - 1 if at is not None else -1
        if i >= 0 and at < ranges[i][1]:
            node_us[ranges[i][2]] = node_us.get(ranges[i][2], 0.0) + us
        else:
            left[name] = left.get(name, 0.0) + us
    return node_us, left


def profile_runs(run: Callable[[], object], n: int, cuda: bool):
    """Calls ``run`` n + 2 times under ``torch.profiler``, each call in a
    range of its own and followed by a synchronize, and returns (items,
    events): the profile's events, and as ``items`` (issued at, microseconds,
    name) each piece of work of the middle n calls.  On the card that is each
    kernel, copy and set, issued at the start of the host call that launched
    it (matched by the profiler's correlation id; ``None`` where that call
    was not recorded); on the CPU each outermost operator, at its own start.

    The first and the last call keep the measured ones away from the
    profile's edges: the profiler maps the card's timestamps onto the host's
    clock with an error of a few hundred microseconds
    (``scripts/profiler_clock_skew.py``) and drops the work it stamps
    outside its window, so that the first kernels after it starts can go
    missing.  The host calls that issue the work are stamped on the host's
    own clock, so they choose the calls exactly."""
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        for _ in range(n + 2):
            with record_function(RUN_RANGE):
                run()
            if cuda:
                torch.cuda.synchronize()
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    calls = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == cpu and e.name == RUN_RANGE)
    if len(calls) != n + 2:
        raise RuntimeError(f"the profile holds {len(calls)} of {n + 2} calls")
    start, end = calls[1][0], calls[-2][1]
    if cuda:
        # the spans the profiler also draws on the device's timeline for
        # each range are not device work
        launched_at = {e.id: e.time_range.start for e in events
                       if e.device_type == cpu and e.name.startswith("cu")}
        items = [(launched_at.get(e.id), e.time_range.elapsed_us(), e.name)
                 for e in events if e.device_type != cpu
                 and not getattr(e, "is_user_annotation", False)
                 and not _is_range(e.name)]
    else:
        def outermost(e):
            return e.cpu_parent is None or _is_range(e.cpu_parent.name)
        items = [(e.time_range.start, e.time_range.elapsed_us(), e.name)
                 for e in events if e.device_type == cpu
                 and not _is_range(e.name) and outermost(e)]
    return [it for it in items if it[0] is None or start <= it[0] < end], events


def card_reference(captured: Captured, *args, n: int = 3) -> CardReference:
    """Per-op-class seconds of ``captured``'s own program, measured.

    ``args`` are real inputs of the captured function (the same structure
    as its example arguments).  The captured aten graph (``captured.graph``)
    runs once to warm up, then under ``torch.profiler`` (``profile_runs``:
    ``n`` measured runs between two more) through an ``fx.Interpreter`` that
    puts every node in a ``record_function`` range.  Each piece of work goes
    to the node whose range holds the moment it was issued: on the card each
    kernel, copy and set, at the start of the host call that launched it
    (matched by the profiler's correlation id), so that none is counted
    twice; on CPU tensors each outermost operator, at its own start.  A
    node's seconds go to the HLO opcode of the instructions the capture
    emitted for it (``captured.node_instructions``); a node emitted as
    several opcodes (a hand-kernel op, a convolution backward) is a class of
    its own, named after its operator, so that no measured time is split by
    a model.

    Raises ``RuntimeError`` when a node that did work maps to no
    instruction (or only to free ones, such as ``bitcast``), when a node
    whose instructions do work shows no device time under its range, and
    when the profile records no device time at all on CUDA inputs.  It never
    falls back to another clock.
    """
    if n < 1:
        raise ValueError(f"n must be at least 1; got {n}")
    on_cuda = any(isinstance(t, torch.Tensor) and t.is_cuda for t in tree_leaves(args))
    gm = captured.graph
    mod = captured.module
    comp = mod.comp(mod.entry)
    ops = {op.name: op for op in comp.ops}

    with torch.no_grad():
        _NodeRanges(gm).run(*args)
        if on_cuda:
            torch.cuda.synchronize()
        items, events = profile_runs(lambda: _NodeRanges(gm).run(*args), n, on_cuda)
    cpu = torch.autograd.DeviceType.CPU
    ranges = sorted((e.time_range.start, e.time_range.end, e.name[len(NODE_RANGE):])
                    for e in events
                    if e.device_type == cpu and e.name.startswith(NODE_RANGE))
    profile_us = sum(it[1] for it in items)
    counts = {k: v / n for k, v in Counter(it[2] for it in items).items()}
    if on_cuda and profile_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time for the "
                           "captured graph on CUDA inputs")
    node_us, left = _attribute(items, ranges)
    unattributed = sorted(((k, v / n / 1e6) for k, v in left.items()),
                          key=lambda kv: -kv[1])

    per_class: Dict[str, float] = {}
    node_seconds: Dict[str, float] = {}
    instruction_class: Dict[str, str] = {}
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        secs = node_us.get(node.name, 0.0) / n / 1e6
        insts = [ops[i] for i in captured.node_instructions.get(node.name, ())
                 if i in ops]
        opcodes = sorted({op.opcode for op in insts if _does_work(mod, comp, op)})
        if secs > 0 and not opcodes and (on_cuda or not insts):
            raise RuntimeError(
                f"node {node.name} ({node.target}) did work but maps to no "
                f"instruction that does any: {[op.opcode for op in insts] or 'none'}")
        if on_cuda and opcodes and secs <= 0:
            raise RuntimeError(
                f"node {node.name} ({node.target}) is emitted as "
                f"{[op.opcode for op in insts]} but showed no device time "
                f"under its profiler range")
        if secs <= 0 or not insts:
            continue
        node_seconds[node.name] = secs
        if len(opcodes) > 1:
            cls = node.target._schema.name
            instruction_class.update((op.name, cls) for op in insts)
        else:                  # one opcode; on the CPU clock a free view's own
            cls = opcodes[0] if opcodes else insts[0].opcode
        per_class[cls] = per_class.get(cls, 0.0) + secs
    return CardReference(per_class, clock="device" if on_cuda else "cpu",
                         node_seconds=node_seconds,
                         instruction_class=instruction_class,
                         profile_seconds=profile_us / n / 1e6, counts=counts,
                         unattributed=unattributed, runs=n)
