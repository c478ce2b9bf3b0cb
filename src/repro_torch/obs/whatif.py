"""Counterfactual repricing: what would the run cost with ONE pathology fixed?

The doctor's currency is ``recoverable_seconds`` — the makespan delta
between the run as simulated and the same run with a single pathology
idealized (evenly interleaved HBM traffic, a perfectly balanced fabric,
zero launch overhead, free communication, no VMEM spill).  Since PR 7 the
batched scheduler records every pricing input onto a
:class:`~repro_torch.core.fastsched.ModuleTape`, so the counterfactual is cheap:
patch the affected EXEC steps' prices (:func:`~repro_torch.core.fastsched.
patched_tape`) and :func:`~repro_torch.core.fastsched.replay` the tape — no
re-capture, no re-walk, no allocator work.  When no tape applies (legacy
scheduler, or no engine/module at hand) each what-if falls back to a full
``Engine.simulate`` with the equivalent knob override, labeled as such in
``WhatIf.method`` because some knob fallbacks are coarser than the patch
(e.g. ``memory_model=False`` removes spill *and* camping at once).

The patchers mirror ``MemoryModel.time_op`` / ``op_time`` arithmetic
exactly, so e.g. the camping counterfactual equals an actual re-simulation
of the same program with contiguous (evenly striped) layouts — the
acceptance bar ``tests/test_doctor.py`` holds it to.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from repro_torch.core import fastsched
from repro_torch.core.fastsched import EXEC
from repro_torch.core.timing import OpTime, op_time

#: what-if slugs priceable on an engine run (cluster findings are analytic)
ENGINE_WHATIFS = ("hbm-channel-camping", "vmem-spill", "launch-overhead",
                  "exposed-communication", "link-imbalance")


@dataclass
class WhatIf:
    """One counterfactual verdict: the run with a single pathology fixed."""

    slug: str
    baseline_seconds: float
    ideal_seconds: float
    #: "tape-replay" (patched-price replay, exact) or "engine-knob"
    #: (full re-simulation under a knob override, possibly coarser)
    method: str
    detail: str = ""

    @property
    def recoverable_seconds(self) -> float:
        """Seconds the fix would buy (clamped: an idealization that cannot
        help reads 0.0, never negative)."""
        return max(self.baseline_seconds - self.ideal_seconds, 0.0)


# ----------------------------------------------------------------------
# tape price patchers — each mirrors the pricing layer it idealizes
# ----------------------------------------------------------------------
def _unpack(st):
    (_k, out, deps, idx, node_id, ot, scale, chans, links, cbytes, spill,
     comp_name, op) = st
    return (out, deps, idx, node_id, ot, scale, chans, links, cbytes,
            spill, comp_name, op)


def _camping_fn(mod, hw) -> Callable:
    """Even-interleave counterfactual: every op's HBM traffic (spill
    included — it already stripes evenly) spread uniformly over all
    channels, then re-timed exactly as ``MemoryModel.time_op`` would."""
    n_ch = hw.hbm_channels
    ch_bw = hw.hbm_channel_bw

    def fn(st):
        (out, deps, idx, node_id, ot, scale, _chans, links, cbytes,
         spill, comp_name, op) = _unpack(st)
        if not cbytes or ot.unit == "ici":
            return st
        total = sum(cbytes)
        if total <= 0 or n_ch <= 0 or ch_bw <= 0:
            return st
        flat = op_time(mod, mod.computations[comp_name], op, hw)
        core = flat.seconds - flat.overhead_s
        t_hbm = (total / n_ch) / ch_bw
        unit, seconds = flat.unit, flat.seconds
        if t_hbm > core:
            unit, seconds = "hbm", t_hbm + flat.overhead_s
        elif flat.unit == "hbm":
            seconds = max(t_hbm, core) + flat.overhead_s
        ot2 = OpTime(seconds, unit, ot.flops, ot.hbm_bytes, ot.ici_bytes,
                     detail=ot.detail, overhead_s=ot.overhead_s)
        vec = [total / n_ch] * n_ch
        chans2 = tuple(range(n_ch)) if unit == "hbm" else None
        return (EXEC, out, deps, idx, node_id, ot2, scale, chans2,
                links, vec, spill, comp_name, op)
    return fn


def _spill_fn(mod, hw) -> Callable:
    """No-spill counterfactual: subtract the (evenly striped) spill bytes
    from each op's channel vector and re-time; camping distribution of the
    payload traffic is kept."""
    n_ch = hw.hbm_channels
    ch_bw = hw.hbm_channel_bw

    def fn(st):
        (out, deps, idx, node_id, ot, scale, chans, links, cbytes,
         spill, comp_name, op) = _unpack(st)
        if not cbytes or spill <= 0 or ot.unit == "ici" or ch_bw <= 0:
            return st
        sp_each = spill / max(n_ch, 1)
        vec = [max(v - sp_each, 0.0) for v in cbytes]
        flat = op_time(mod, mod.computations[comp_name], op, hw)
        core = flat.seconds - flat.overhead_s
        t_hbm = max(vec) / ch_bw if vec else 0.0
        unit, seconds = flat.unit, flat.seconds
        if t_hbm > core:
            unit, seconds = "hbm", t_hbm + flat.overhead_s
        elif flat.unit == "hbm":
            seconds = max(t_hbm, core) + flat.overhead_s
        ot2 = OpTime(seconds, unit, ot.flops, flat.hbm_bytes, ot.ici_bytes,
                     detail=ot.detail, overhead_s=ot.overhead_s)
        chans2 = tuple(c for c, v in enumerate(vec) if v > 0) \
            if unit == "hbm" else None
        return (EXEC, out, deps, idx, node_id, ot2, scale, chans2,
                links, vec, 0, comp_name, op)
    return fn


def _overhead_fn() -> Callable:
    """Zero-launch-overhead counterfactual: strip the issue cost out of
    every step (equals a re-simulation with ``op_launch_overhead_s=0`` —
    the overhead is a pure additive term in every pricing path)."""
    def fn(st):
        ot = st[5]
        if ot.overhead_s <= 0:
            return st
        # direct construction: dataclasses.replace costs ~10x as much and
        # this runs once per EXEC step per counterfactual
        ot2 = OpTime(max(ot.seconds - ot.overhead_s, 0.0), ot.unit,
                     ot.flops, ot.hbm_bytes, ot.ici_bytes,
                     detail=ot.detail, overhead_s=0.0,
                     link_seconds=ot.link_seconds,
                     link_bytes=ot.link_bytes)
        return st[:5] + (ot2,) + st[6:]
    return fn


def _comm_free_fn() -> Callable:
    """Perfect-overlap counterfactual: collectives cost only their issue
    overhead, so the makespan delta is exactly the communication time the
    schedule failed to hide."""
    def fn(st):
        (out, deps, idx, node_id, ot, scale, chans, _links, cbytes,
         spill, comp_name, op) = _unpack(st)
        if ot.unit != "ici":
            return st
        ot2 = OpTime(ot.overhead_s, ot.unit, ot.flops, ot.hbm_bytes,
                     ot.ici_bytes, detail=ot.detail,
                     overhead_s=ot.overhead_s)
        return (EXEC, out, deps, idx, node_id, ot2, scale, chans,
                None, cbytes, spill, comp_name, op)
    return fn


def _link_balance_fn(all_links: List[str]) -> Callable:
    """Balanced-fabric counterfactual: each collective's total link busy
    time spread evenly over every link the run touched, transfer time =
    the (now uniform) per-link share.  Conservative: links the program
    never used stay out of the denominator."""
    links2 = sorted(all_links)
    n = max(len(links2), 1)

    def fn(st):
        (out, deps, idx, node_id, ot, scale, chans, _links, cbytes,
         spill, comp_name, op) = _unpack(st)
        if ot.unit != "ici" or not ot.link_seconds:
            return st
        busy = sum(ot.link_seconds.values())
        share = busy / n
        transfer = max(ot.seconds - ot.overhead_s, 0.0)
        seconds = min(ot.seconds, share + ot.overhead_s) \
            if transfer > 0 else ot.seconds
        ls2 = {l: share for l in links2}
        ot2 = OpTime(seconds, ot.unit, ot.flops, ot.hbm_bytes,
                     ot.ici_bytes, detail=ot.detail,
                     overhead_s=ot.overhead_s, link_seconds=ls2)
        return (EXEC, out, deps, idx, node_id, ot2, scale, chans,
                list(links2), cbytes, spill, comp_name, op)
    return fn


# ----------------------------------------------------------------------
# knob-override fallbacks (no tape: legacy scheduler / missing engine)
# ----------------------------------------------------------------------
def _knob_engine(slug: str, engine, hw):
    """A fresh Engine with the one knob idealizing ``slug`` overridden."""
    from repro_torch.core.engine import Engine
    kw = dict(
        hw=hw,
        overlap_collectives=engine.overlap if engine else True,
        num_compute_streams=engine.num_compute_streams if engine else 1,
        memory_model=engine.memory_model if engine else True,
        topology_model=engine.topology_model if engine else True,
        scheduler="batched")
    if slug in ("hbm-channel-camping", "vmem-spill"):
        kw["memory_model"] = False
    elif slug == "launch-overhead":
        kw["hw"] = dataclasses.replace(hw, op_launch_overhead_s=0.0)
    elif slug == "exposed-communication":
        kw["hw"] = dataclasses.replace(hw, ici_link_bw=1e30,
                                       ici_latency_s=0.0)
    elif slug == "link-imbalance":
        kw["topology_model"] = False
    else:
        raise KeyError(f"unknown engine what-if {slug!r} "
                       f"(expected one of {ENGINE_WHATIFS})")
    return Engine(**kw)


def whatif_engine(slug: str, report, engine=None, module=None
                  ) -> Optional[WhatIf]:
    """Price one pathology's counterfactual for an engine run.

    Prefers the tape tier (patch + replay); falls back to a knob-override
    ``Engine.simulate`` when no tape applies.  Returns ``None`` when
    neither is possible (no module to re-simulate).
    """
    if slug not in ENGINE_WHATIFS:
        raise KeyError(f"unknown engine what-if {slug!r} "
                       f"(expected one of {ENGINE_WHATIFS})")
    baseline = report.total_seconds
    tape = None
    if engine is not None and module is not None:
        tape = engine.tape_for(module)
    if tape is not None:
        hw = engine.hw
        if slug == "hbm-channel-camping":
            fn = _camping_fn(module, hw)
        elif slug == "vmem-spill":
            fn = _spill_fn(module, hw)
        elif slug == "launch-overhead":
            fn = _overhead_fn()
        elif slug == "exposed-communication":
            fn = _comm_free_fn()
        else:
            fn = _link_balance_fn(sorted(report.link_busy_seconds))
        from repro_torch.obs.metrics import REGISTRY
        from repro_torch.obs.trace import TRACER
        with TRACER.span("whatif.replay", pathology=slug):
            ideal = fastsched.replay(fastsched.patched_tape(tape, fn),
                                     engine, None, totals_only=True)
        REGISTRY.counter("whatif_tape_replays_total").inc()
        return WhatIf(slug, baseline, ideal.total_seconds, "tape-replay")
    if module is None:
        return None
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.obs.trace import TRACER
    knob = _knob_engine(slug, engine, engine.hw if engine else report.hw)
    with TRACER.span("whatif.knob_simulate", pathology=slug):
        ideal = knob.simulate(module)
    REGISTRY.counter("whatif_knob_fallbacks_total").inc()
    return WhatIf(slug, baseline, ideal.total_seconds, "engine-knob",
                  detail="full re-simulation under a knob override; "
                         "coarser than the tape patch")


def whatif_all(report, engine=None, module=None) -> Dict[str, WhatIf]:
    """Every engine counterfactual that can be priced for this run."""
    out: Dict[str, WhatIf] = {}
    for slug in ENGINE_WHATIFS:
        wi = whatif_engine(slug, report, engine=engine, module=module)
        if wi is not None:
            out[slug] = wi
    return out
