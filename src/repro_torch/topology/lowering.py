"""Collective-algorithm lowering: (kind, payload, members) -> link schedule.

Every collective the engine times is lowered here into a sequence of
*phases*: in one phase a set of directed links each carry some bytes
concurrently, and the phase takes ``max(bytes/link_bw) + hops * latency``
(transfers pipeline over multi-hop routes, paying per-hop latency).  The
resulting :class:`TransferSchedule` carries the total ``seconds`` plus
per-link busy seconds and bytes — the engine claims exactly those link
clocks, so collectives on disjoint links overlap while shared-link
collectives serialize.

Algorithms:

* ``ring``        — unidirectional ring over the member order.  All-reduce
  is reduce-scatter + all-gather: ``2*(g-1)`` phases of ``S/g`` chunks, so
  the total is the textbook ``2*(g-1)/g * S / link_bw + 2*(g-1) * latency``
  (and one-pass collectives — all-gather, reduce-scatter, all-to-all
  rotation, broadcast — take ``(g-1)/g * S / link_bw + (g-1) * latency``).
  On the default unsized-ring fabric this reproduces the flat analytic
  model in :func:`repro_torch.core.collectives.collective_time` exactly.
* ``bidir-ring``  — both ring directions carry half the payload
  concurrently: half the transfer time, same latency phase count.
* ``halving``     — recursive halving/doubling (power-of-two groups):
  the same ``2*(g-1)/g * S`` total bytes in ``2*log2(g)`` phases — the
  latency-optimal tree for small payloads.
* ``torus``       — multi-axis ring all-reduce (reduce-scatter along each
  axis, all-gather back in reverse): bandwidth cost
  ``2*(N-1)/N * S / link_bw`` (the same optimal total as one big ring) but
  only ``2 * sum(axis_size - 1)`` latency hops instead of ``2*(N-1)`` —
  how an actual TPU torus beats a flat ring.
* ``direct``      — point-to-point (collective-permute): the payload
  traverses the route once.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.hw import HardwareSpec
from repro_torch.topology.graph import Topology, link_name

ALGORITHMS = ("ring", "bidir-ring", "halving", "torus", "direct")


@dataclass
class TransferSchedule:
    """A lowered collective: per-link transfer plan + its makespan."""

    kind: str                     # HLO collective kind
    algorithm: str                # which lowering produced it
    group: int                    # participating device count
    payload_bytes: float
    seconds: float = 0.0          # schedule makespan (no launch overhead)
    hops: int = 0                 # latency-paying pipeline steps
    link_seconds: Dict[str, float] = field(default_factory=dict)
    link_bytes: Dict[str, float] = field(default_factory=dict)

    @property
    def links(self) -> List[str]:
        return sorted(self.link_bytes)

    @property
    def traffic_bytes(self) -> float:
        """Per-device ICI traffic (the flat model's ``link_bytes``).

        Ring/torus schedules model EVERY member's sends, so the per-device
        share is the link total over the group; a ``direct`` schedule
        (collective-permute) models only the simulated device's own route,
        which IS its per-device traffic.
        """
        if self.group <= 0:
            return 0.0
        if self.algorithm == "direct":
            return float(self.payload_bytes)
        return sum(self.link_bytes.values()) / self.group

    @property
    def link_imbalance(self) -> float:
        """Busiest link bytes / mean (1.0 = perfectly balanced)."""
        if not self.link_bytes:
            return 1.0
        mean = sum(self.link_bytes.values()) / len(self.link_bytes)
        if mean <= 0:
            return 1.0
        return max(self.link_bytes.values()) / mean


@dataclass(frozen=True)
class _PlanPhase:
    """One payload-independent phase of a lowered collective.

    ``hops`` lists every directed link the phase touches, in first-touch
    order, with the *integer multiplicities* of the chunk it carries (a
    tuple: the old builder sometimes merged two accumulation runs — e.g.
    bidir-ring forward+reverse — and float addition is not associative, so
    the runs must replay separately).  ``chunk_ops`` derives the chunk from
    the payload ``S`` as a literal op chain (``('d', x)`` divides, ``('m',
    x)`` multiplies) — replaying the exact float ops the unbatched lowering
    performed keeps instantiation bit-identical for every payload.
    """

    hops: Tuple[Tuple[Tuple[int, int], Tuple[int, ...]], ...]
    pipeline_hops: int
    repeat: int
    chunk_ops: Tuple[Tuple[str, float], ...]


@dataclass(frozen=True)
class _Plan:
    """A payload/bandwidth-independent lowering: pure fabric geometry."""

    kind: str
    algorithm: str                # the RESOLVED algorithm (after fallbacks)
    group: int
    phases: Tuple[_PlanPhase, ...]


class _PlanBuilder:
    """Accumulates payload-independent phases into a :class:`_Plan`."""

    def __init__(self, kind: str, algorithm: str, group: int):
        self.kind = kind
        self.algorithm = algorithm
        self.group = group
        self.phases: List[_PlanPhase] = []

    def phase(self, mult: Dict[Tuple[int, int], Tuple[int, ...]],
              chunk_ops: Tuple[Tuple[str, float], ...],
              pipeline_hops: int = 1, repeat: int = 1) -> None:
        self.phases.append(_PlanPhase(tuple(mult.items()), pipeline_hops,
                                      repeat, chunk_ops))

    def plan(self) -> _Plan:
        return _Plan(self.kind, self.algorithm, self.group,
                     tuple(self.phases))


def _instantiate(plan: _Plan, payload_bytes: float, bw: float,
                 lat: float) -> TransferSchedule:
    """Price a geometry plan for one payload/bandwidth/latency.

    Replays exactly the float operations the original one-shot lowering
    performed — chunk derivation as the recorded op chain, per-hop bytes as
    repeated chunk additions — so a cached plan instantiates bit-identical
    to an uncached lowering.
    """
    sched = TransferSchedule(plan.kind, plan.algorithm, plan.group,
                             payload_bytes)
    bw = max(bw, 1e-30)
    S = float(payload_bytes)
    for ph in plan.phases:
        if not ph.hops or ph.repeat <= 0:
            continue
        chunk = S
        for op, x in ph.chunk_ops:
            chunk = chunk / x if op == "d" else chunk * x
        vals: List[float] = []
        mx = 0.0
        first = True
        for _hop, counts in ph.hops:
            v = 0.0
            for k in counts:
                r = 0.0
                for _ in range(k):
                    r += chunk
                v += r              # 0.0 + r == r exactly (bytes are >= 0)
            vals.append(v)
            if first or v > mx:
                mx, first = v, False
        step = mx / bw + ph.pipeline_hops * lat
        sched.seconds += step * ph.repeat
        sched.hops += ph.pipeline_hops * ph.repeat
        for ((a, b), _counts), v in zip(ph.hops, vals):
            key = link_name(a, b)
            sched.link_bytes[key] = (sched.link_bytes.get(key, 0.0)
                                     + v * ph.repeat)
            sched.link_seconds[key] = (sched.link_seconds.get(key, 0.0)
                                       + (v / bw + lat) * ph.repeat)
    return sched


# ---------------------------------------------------------------------------
# member geometry helpers
# ---------------------------------------------------------------------------

def _ring_hop_routes(topo: Topology, order: Sequence[int],
                     broken: Optional[frozenset] = None
                     ) -> List[List[Tuple[int, int]]]:
    """Directed link route for each consecutive (wrapped) pair of ``order``."""
    g = len(order)
    return [topo.route(order[i], order[(i + 1) % g], avoid=broken)
            for i in range(g)]


def _ring_mult(routes: Sequence[List[Tuple[int, int]]]
               ) -> Tuple[Dict[Tuple[int, int], int], int]:
    """Per-hop chunk multiplicities (first-touch order) + pipeline depth."""
    mult: Dict[Tuple[int, int], int] = {}
    for route in routes:
        for hop in route:
            mult[hop] = mult.get(hop, 0) + 1
    return mult, max((len(r) for r in routes), default=1)


def _counts(mult: Dict[Tuple[int, int], int]
            ) -> Dict[Tuple[int, int], Tuple[int, ...]]:
    return {hop: (k,) for hop, k in mult.items()}


def _block_axes(topo: Topology, positions: Sequence[int]
                ) -> Optional[List[List[List[int]]]]:
    """If ``positions`` form an axis-aligned block of a torus, return per-axis
    rings: ``rings[ax]`` is a list of position-chains, each one ring along
    axis ``ax`` (only axes where the block spans > 1 value).  ``None`` when
    the members are not a block (fall back to one big ring)."""
    if topo.kind != "torus":
        return None
    coords = [topo.coords(p) for p in positions]
    values = [sorted({c[ax] for c in coords}) for ax in range(len(topo.dims))]
    size = 1
    for v in values:
        size *= len(v)
    if size != len(positions) or size != len(set(positions)):
        return None
    have = set(coords)
    for combo in itertools.product(*values):
        if combo not in have:
            return None
    pos_at = {c: p for c, p in zip(coords, positions)}
    rings: List[List[List[int]]] = []
    for ax in range(len(topo.dims)):
        if len(values[ax]) <= 1:
            rings.append([])
            continue
        other = [values[a] for a in range(len(topo.dims)) if a != ax]
        chains = []
        for fixed in itertools.product(*other):
            chain = []
            for v in values[ax]:
                c = list(fixed)
                c.insert(ax, v)
                chain.append(pos_at[tuple(c)])
            chains.append(chain)
        rings.append(chains)
    return rings


def _snake_order(topo: Topology, positions: Sequence[int]) -> List[int]:
    """Order a torus block boustrophedon (snake) so consecutive members are
    adjacent; non-block member sets fall back to sorted position order."""
    if _block_axes(topo, positions) is None:
        return sorted(positions)
    coords = sorted(topo.coords(p) for p in positions)
    ordered, flip = [], False
    by_prefix: Dict[Tuple[int, ...], List[Tuple[int, ...]]] = {}
    for c in coords:
        by_prefix.setdefault(c[:-1], []).append(c)
    for prefix in sorted(by_prefix):
        row = sorted(by_prefix[prefix], reverse=flip)
        ordered.extend(row)
        flip = not flip
    return [topo.pos_of(c) for c in ordered]


# ---------------------------------------------------------------------------
# the lowering entry point
# ---------------------------------------------------------------------------

def lower_collective(kind: str, payload_bytes: float,
                     members: Sequence[int], topo: Topology,
                     hw: HardwareSpec,
                     algorithm: Optional[str] = None,
                     pairs: Optional[Sequence[Tuple[int, int]]] = None,
                     broken: Optional[frozenset] = None
                     ) -> TransferSchedule:
    """Lower one collective over ``members`` (global device ids) on ``topo``.

    ``algorithm=None`` picks the natural default: ``direct`` for permutes,
    ``torus`` for all-reduce when the members form a multi-axis block of a
    torus fabric, ``ring`` otherwise.  ``pairs`` (permutes) lists every
    source->target pair — all of them transfer concurrently, so the
    schedule claims every pair's route, not just the first's.

    ``broken`` is a set of undirected id pairs (failed physical links,
    :func:`repro_torch.topology.graph.undirected_pair`): every hop then routes
    over the surviving fabric only (BFS detours), so traffic that used to
    flow down a dead link re-routes onto its neighbors and *serializes*
    with the traffic already there — phase times stretch by exactly the
    induced link camping.  Raises ``ValueError`` if the removals partition
    the members.

    Lowering splits in two: the payload-independent *geometry plan* (hop
    multiplicities, pipeline depths, chunk-derivation op chains) is built
    once per (kind, members, topo, algorithm, pairs, broken) and memoized,
    then instantiated per payload — repeated collectives over the same
    group reuse one plan regardless of payload size.
    """
    g = len(members)
    bw = hw.dcn_bw if topo.kind == "fc" \
        else hw.ici_links_per_axis * hw.ici_link_bw
    lat = hw.ici_latency_s
    if algorithm is not None and algorithm not in ALGORITHMS:
        raise KeyError(f"unknown collective algorithm {algorithm!r}; "
                       f"known: {ALGORITHMS}")
    if g <= 1:
        return TransferSchedule(kind, algorithm or "ring", g, payload_bytes)
    pairs_t = tuple((int(a), int(b)) for a, b in pairs) if pairs else None
    plan = _build_plan(kind, tuple(members), topo, algorithm, pairs_t,
                       None if broken is None else frozenset(broken))
    return _instantiate(plan, payload_bytes, bw, lat)


@lru_cache(maxsize=4096)
def _build_plan(kind: str, members: Tuple[int, ...], topo: Topology,
                algorithm: Optional[str],
                pairs: Optional[Tuple[Tuple[int, int], ...]],
                broken: Optional[frozenset]) -> _Plan:
    """Build the payload-independent geometry plan for one collective.

    Exceptions (``ValueError`` on a partitioned fabric) propagate and are
    NOT cached by ``lru_cache``, so a later retry with healed links works.

    The span/counter fire on cache MISSES only (this function sits behind
    the ``lru_cache``), so the flight recorder sees exactly the lowering
    work actually performed, not the memoized lookups.
    """
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.obs.trace import TRACER
    REGISTRY.counter("topology_plan_builds_total", kind=kind).inc()
    with TRACER.span("topology.lower", kind=kind, group=len(members),
                     algorithm=algorithm or "auto",
                     degraded=bool(broken)):
        return _build_plan_impl(kind, members, topo, algorithm, pairs,
                                broken)


def _build_plan_impl(kind: str, members: Tuple[int, ...], topo: Topology,
                     algorithm: Optional[str],
                     pairs: Optional[Tuple[Tuple[int, int], ...]],
                     broken: Optional[frozenset]) -> _Plan:
    g = len(members)
    pos_by_id = {dev: pos for pos, dev in enumerate(topo.ids)}
    positions = [pos_by_id[m] for m in members]
    rings = _block_axes(topo, positions)
    multi_axis = rings is not None and sum(1 for r in rings if r) >= 2

    if algorithm is None:
        if kind == "collective-permute":
            algorithm = "direct"
        elif kind == "all-reduce" and multi_axis:
            algorithm = "torus"
        else:
            algorithm = "ring"
    if algorithm == "torus" and not multi_axis:
        algorithm = "ring"
    if algorithm == "halving" and (g & (g - 1)) != 0:
        algorithm = "ring"          # recursive halving needs a power of two

    pb = _PlanBuilder(kind, algorithm, g)

    if algorithm == "direct":
        # one concurrent phase carrying EVERY source->target pair; per-pair
        # payload is the per-device send, so disjoint pairs keep the flat
        # time (S/bw + lat) while pairs routed over shared links dilate
        plist = [(pos_by_id[a], pos_by_id[b]) for a, b in pairs
                 if a in pos_by_id and b in pos_by_id and a != b] \
            if pairs else [(positions[0], positions[1 % g])]
        mult: Dict[Tuple[int, int], int] = {}
        ph = 1
        for pa, pbp in plist:
            route = topo.route(pa, pbp, avoid=broken)
            ph = max(ph, len(route))
            for hop in route:
                mult[hop] = mult.get(hop, 0) + 1
        pb.phase(_counts(mult), (), pipeline_hops=ph)    # chunk = S itself
        return pb.plan()

    if algorithm == "torus":
        axes = [ax for ax, chains in enumerate(rings) if chains]
        ops: List[Tuple[str, float]] = []
        for ax in axes:                       # reduce-scatter sweep
            m = len(rings[ax][0])
            mult, ph = _axis_ring_mult(topo, rings[ax], broken=broken)
            pb.phase(_counts(mult), tuple(ops) + (("d", float(m)),),
                     pipeline_hops=ph, repeat=m - 1)
            ops.append(("d", float(m)))       # shard /= m
        for ax in reversed(axes):             # all-gather sweep back
            m = len(rings[ax][0])
            mult, ph = _axis_ring_mult(topo, rings[ax], reverse=True,
                                       broken=broken)
            pb.phase(_counts(mult), tuple(ops), pipeline_hops=ph,
                     repeat=m - 1)
            ops.append(("m", float(m)))       # shard *= m
        return pb.plan()

    order = _snake_order(topo, positions)
    routes = _ring_hop_routes(topo, order, broken)

    # phase count by KIND (same on every ring-family algorithm): all-reduce
    # is a reduce-scatter sweep PLUS an all-gather sweep; everything else is
    # one traversal (AG / RS / A2A rotation / broadcast)
    two_sweeps = kind == "all-reduce"

    if algorithm == "bidir-ring":
        fwd, fh = _ring_mult(routes)
        rev_routes = _ring_hop_routes(topo, list(reversed(order)), broken)
        rev, rh = _ring_mult(rev_routes)
        both = _counts(fwd)
        for hop, k in rev.items():
            both[hop] = both.get(hop, ()) + (k,)
        pb.phase(both, (("d", float(2 * g)),), pipeline_hops=max(fh, rh),
                 repeat=(2 if two_sweeps else 1) * (g - 1))
        return pb.plan()

    if algorithm == "halving":
        # recursive halving (the "rs" sweep) / doubling (the "ag" sweep):
        # all-reduce runs both, one-pass collectives run only theirs
        stages = g.bit_length() - 1
        sweeps = ("rs", "ag") if two_sweeps \
            else (("rs",) if kind == "reduce-scatter" else ("ag",))
        for direction in sweeps:
            srange = range(stages) if direction == "rs" \
                else range(stages - 1, -1, -1)
            for s in srange:
                mult = {}
                ph = 1
                for i in range(g):
                    route = topo.route(order[i], order[i ^ (1 << s)],
                                       avoid=broken)
                    ph = max(ph, len(route))
                    for hop in route:
                        mult[hop] = mult.get(hop, 0) + 1
                pb.phase(_counts(mult), (("d", float(2 ** (s + 1))),),
                         pipeline_hops=ph)
        return pb.plan()

    # plain unidirectional ring
    mult, ph = _ring_mult(routes)
    pb.phase(_counts(mult), (("d", float(g)),), pipeline_hops=ph,
             repeat=(2 if two_sweeps else 1) * (g - 1))
    return pb.plan()


def _axis_ring_mult(topo: Topology, chains: Sequence[Sequence[int]],
                    reverse: bool = False,
                    broken: Optional[frozenset] = None
                    ) -> Tuple[Dict[Tuple[int, int], int], int]:
    """One axis sweep of the torus algorithm: every chain (a ring along this
    axis) moves one chunk around simultaneously; returns hop multiplicities
    and the pipeline depth of one step."""
    mult: Dict[Tuple[int, int], int] = {}
    ph = 1
    for chain in chains:
        order = list(reversed(chain)) if reverse else list(chain)
        for route in _ring_hop_routes(topo, order, broken):
            ph = max(ph, len(route))
            for hop in route:
                mult[hop] = mult.get(hop, 0) + 1
    return mult, ph


def clear_plan_cache() -> None:
    """Drop memoized geometry plans (useful for benchmarks/tests)."""
    _build_plan.cache_clear()
