"""Interconnect topology graphs (the fabric the collectives run over).

The paper's DRAM-partition analysis showed that one aggregate bandwidth
number hides per-partition saturation; the same is true of an ICI fabric
modeled as one flat clock.  A :class:`Topology` makes the fabric's structure
explicit: devices are nodes, and every directed neighbor pair is a *link*
with its own identity (``"ici:<src>-<dst>"``) — the key the engine uses for
that link's free-time clock, exactly the way ``"hbm:<channel>"`` keys the
per-channel memory clocks.

Supported shapes (all buildable from a spec string, see :meth:`from_spec`):

* ``ring``  / ``ring:8``    — 1D bidirectional ring (one torus axis);
* ``torus:4x4`` / ``torus:2x2x2`` — 2D/3D torus, each axis a wrapped ring;
* ``fc`` / ``fc:4``         — fully connected (the host/DCN fabric, where
  every pair of nodes has a direct path).

A topology's *nodes* are positions ``0..n-1``; ``ids`` maps positions to
global device ids so a per-collective-group ring built over members
``(0, 4, 8, 12)`` names its links after the real devices (``ici:0-4`` ...)
and therefore shares — or provably does not share — links with other groups.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from functools import lru_cache
from typing import (AbstractSet, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

#: cap on how many candidate sub-slices :meth:`Topology.sub_slices` ranks —
#: placement is a per-event decision, so enumeration must stay cheap.
_MAX_SLICES = 512


def link_name(src: int, dst: int) -> str:
    """Canonical engine resource key for the directed link ``src -> dst``."""
    return f"ici:{src}-{dst}"


def undirected_pair(a: int, b: int) -> Tuple[int, int]:
    """Canonical undirected link identity between two device ids — the unit
    of PHYSICAL link failure (an outage kills both directions at once)."""
    return (a, b) if a <= b else (b, a)


@dataclass(frozen=True)
class Topology:
    """An interconnect graph over ``n`` devices.

    ``kind`` is ``"ring"``, ``"torus"`` or ``"fc"``; ``dims`` are the axis
    sizes (a ring is a 1-axis torus; fc keeps ``(n,)`` for its node count).
    ``ids[pos]`` is the global device id at position ``pos``.
    """

    kind: str
    dims: Tuple[int, ...]
    ids: Tuple[int, ...]

    def __post_init__(self):
        if self.kind not in ("ring", "torus", "fc"):
            raise ValueError(f"unknown topology kind {self.kind!r}")
        n = 1
        for d in self.dims:
            if d < 1:
                raise ValueError(f"axis sizes must be >= 1, got {self.dims}")
            n *= d
        if n != len(self.ids):
            raise ValueError(
                f"dims {self.dims} hold {n} nodes but got {len(self.ids)} ids")

    # -- constructors -------------------------------------------------------
    @classmethod
    def ring(cls, n: int, ids: Optional[Sequence[int]] = None) -> "Topology":
        return cls("ring", (n,), tuple(ids) if ids is not None
                   else tuple(range(n)))

    @classmethod
    def torus(cls, dims: Sequence[int]) -> "Topology":
        dims = tuple(dims)
        n = 1
        for d in dims:
            n *= d
        return cls("torus", dims, tuple(range(n)))

    @classmethod
    def fully_connected(cls, n: int,
                        ids: Optional[Sequence[int]] = None) -> "Topology":
        return cls("fc", (n,), tuple(ids) if ids is not None
                   else tuple(range(n)))

    @classmethod
    def validate_spec(cls, spec: str) -> Tuple[str, str]:
        """Check a fabric spec's grammar without instantiating it.

        Returns ``(kind, size_string)`` (size empty for unsized specs);
        raises ``KeyError`` for unknown kinds and for an unsized torus —
        every consumer (FabricModel, CLIs, ``from_spec``) shares this, so a
        typo'd ``--topology`` can never silently degrade to a ring.
        """
        kind, _, size_s = str(spec).strip().partition(":")
        if kind not in ("ring", "torus", "fc"):
            raise KeyError(f"unknown topology spec {spec!r} "
                           "(expected ring[:N] | torus:AxB[xC] | fc[:N])")
        if kind == "torus" and not size_s:
            raise KeyError(f"torus spec needs sizes, e.g. 'torus:4x4' "
                           f"(got {spec!r})")
        if size_s:
            parts = size_s.split("x") if kind == "torus" else [size_s]
            if not all(p.isdigit() and int(p) >= 1 for p in parts):
                raise KeyError(f"bad topology size in {spec!r} "
                               "(expected positive integers, e.g. "
                               "'ring:8' or 'torus:4x4')")
        return kind, size_s

    @classmethod
    def from_spec(cls, spec: str, n: Optional[int] = None) -> "Topology":
        """Parse ``"ring"``, ``"ring:8"``, ``"torus:4x4"``, ``"fc:4"``.

        An unsized ``"ring"``/``"fc"`` needs ``n`` (the device count it is
        being instantiated for); a sized spec ignores ``n`` unless they
        disagree, which raises.
        """
        kind, size_s = cls.validate_spec(spec)
        if not size_s:
            if n is None:
                raise KeyError(f"unsized spec {spec!r} needs a device count")
            return cls.ring(n) if kind == "ring" else cls.fully_connected(n)
        dims = tuple(int(d) for d in size_s.split("x"))
        total = 1
        for d in dims:
            total *= d
        if n is not None and n != total:
            raise ValueError(f"topology {spec!r} has {total} devices but the "
                             f"fleet/group has {n}")
        if kind == "torus":
            return cls.torus(dims)
        return cls.ring(total) if kind == "ring" else cls.fully_connected(total)

    # -- structure ----------------------------------------------------------
    @property
    def num_devices(self) -> int:
        return len(self.ids)

    @property
    def name(self) -> str:
        if self.kind == "torus":
            return "torus:" + "x".join(str(d) for d in self.dims)
        return f"{self.kind}:{self.num_devices}"

    def coords(self, pos: int) -> Tuple[int, ...]:
        """Row-major coordinates of a position in ``dims`` space."""
        out = []
        for d in reversed(self.dims):
            out.append(pos % d)
            pos //= d
        return tuple(reversed(out))

    def pos_of(self, coords: Sequence[int]) -> int:
        pos = 0
        for c, d in zip(coords, self.dims):
            pos = pos * d + (c % d)
        return pos

    def links(self) -> List[Tuple[int, int]]:
        """Every directed link as a (src_id, dst_id) pair."""
        out: List[Tuple[int, int]] = []
        seen = set()
        for pos in range(self.num_devices):
            for nb in self._neighbor_positions(pos):
                pair = (self.ids[pos], self.ids[nb])
                if pair not in seen:
                    seen.add(pair)
                    out.append(pair)
        return out

    def _neighbor_positions(self, pos: int) -> Tuple[int, ...]:
        return _neighbors_cached(self, pos)

    # -- metrics ------------------------------------------------------------
    def distance(self, a: int, b: int) -> int:
        """Shortest-path hop count between two *positions*."""
        if a == b:
            return 0
        if self.kind == "fc":
            return 1
        if self.kind == "ring":
            n = self.num_devices
            d = abs(a - b)
            return min(d, n - d)
        ca, cb = self.coords(a), self.coords(b)
        dist = 0
        for ax, d in enumerate(self.dims):
            delta = abs(ca[ax] - cb[ax])
            dist += min(delta, d - delta)
        return dist

    def route(self, a: int, b: int,
              avoid: Optional[AbstractSet[Tuple[int, int]]] = None
              ) -> List[Tuple[int, int]]:
        """Dimension-ordered shortest path ``a -> b`` as directed
        (src_id, dst_id) link hops (wrap-aware on rings/tori).

        ``avoid`` is a set of *undirected* id pairs (broken physical
        links, see :func:`undirected_pair`): when given, the path is the
        BFS-shortest route over the surviving links only — the fabric with
        those links removed.  Raises ``ValueError`` when the removal
        partitions ``a`` from ``b``.
        """
        return list(_route_cached(self, a, b,
                                  frozenset(avoid) if avoid else None))

    def _route_uncached(self, a: int, b: int,
                        avoid: Optional[AbstractSet[Tuple[int, int]]]
                        ) -> List[Tuple[int, int]]:
        if avoid:
            return self._route_avoiding(a, b, avoid)
        if a == b:
            return []
        if self.kind == "fc":
            return [(self.ids[a], self.ids[b])]
        hops: List[Tuple[int, int]] = []
        if self.kind == "ring":
            n = self.num_devices
            fwd = (b - a) % n
            step = 1 if fwd <= n - fwd else -1
            cur = a
            while cur != b:
                nxt = (cur + step) % n
                hops.append((self.ids[cur], self.ids[nxt]))
                cur = nxt
            return hops
        cur = list(self.coords(a))
        target = self.coords(b)
        for ax, d in enumerate(self.dims):
            delta = (target[ax] - cur[ax]) % d
            step = 1 if delta <= d - delta else -1
            while cur[ax] != target[ax]:
                src = self.pos_of(cur)
                cur[ax] = (cur[ax] + step) % d
                hops.append((self.ids[src], self.ids[self.pos_of(cur)]))
        return hops

    def _route_avoiding(self, a: int, b: int,
                        avoid: AbstractSet[Tuple[int, int]]
                        ) -> List[Tuple[int, int]]:
        """BFS-shortest ``a -> b`` over healthy links (deterministic: the
        neighbor enumeration order breaks ties)."""
        if a == b:
            return []
        prev: Dict[int, Optional[int]] = {a: None}
        frontier = [a]
        while frontier and b not in prev:
            nxt: List[int] = []
            for pos in frontier:
                for nb in self._neighbor_positions(pos):
                    if nb in prev or undirected_pair(
                            self.ids[pos], self.ids[nb]) in avoid:
                        continue
                    prev[nb] = pos
                    nxt.append(nb)
            frontier = nxt
        if b not in prev:
            raise ValueError(
                f"no healthy route {a} -> {b} on {self.name}: removing "
                f"links {sorted(avoid)} partitions the fabric")
        hops: List[Tuple[int, int]] = []
        cur = b
        while prev[cur] is not None:
            p = prev[cur]
            hops.append((self.ids[p], self.ids[cur]))
            cur = p
        return list(reversed(hops))

    def internal_links(self, positions: Iterable[int]
                       ) -> frozenset:
        """Undirected id pairs of every fabric link with BOTH endpoints in
        ``positions`` — the links a gang placed on that sub-slice runs its
        collectives over, and therefore the links whose failure forces the
        gang to re-route."""
        return _internal_links_cached(self, tuple(sorted(set(positions))))

    def diameter(self, positions: Optional[Iterable[int]] = None) -> int:
        """Max pairwise distance over ``positions`` (default: all nodes)."""
        nodes = list(positions) if positions is not None \
            else list(range(self.num_devices))
        best = 0
        for i, a in enumerate(nodes):
            for b in nodes[i + 1:]:
                best = max(best, self.distance(a, b))
        return best

    def _pairwise_sum(self, nodes: Sequence[int]) -> int:
        total = 0
        for i, a in enumerate(nodes):
            for b in nodes[i + 1:]:
                total += self.distance(a, b)
        return total

    # -- placement ----------------------------------------------------------
    def sub_slices(self, k: int) -> List[Tuple[int, ...]]:
        """Candidate ``k``-node sub-slices, best (smallest diameter) first.

        The cluster ``locality`` policy walks this list and takes the first
        slice whose devices are all free — so the ordering IS the placement
        preference.  Rings yield consecutive windows; tori yield axis-aligned
        ``a x b [x c]`` blocks for every factorization of ``k``; fc yields
        index windows (every subset is equivalent there).  Ties on diameter
        break by total pairwise distance, then by anchor position, so the
        choice is deterministic.
        """
        return list(_sub_slices_cached(self, k))


@lru_cache(maxsize=65536)
def _neighbors_cached(topo: Topology, pos: int) -> Tuple[int, ...]:
    """Memoized :meth:`Topology._neighbor_positions` — Topology is frozen,
    so the neighbor list is pure in (topology, position)."""
    n = topo.num_devices
    if topo.kind == "fc":
        return tuple(p for p in range(n) if p != pos)
    if topo.kind == "ring":
        if n <= 1:
            return ()
        if n == 2:
            return (1 - pos,)
        return ((pos + 1) % n, (pos - 1) % n)
    out = []
    c = topo.coords(pos)
    for ax, d in enumerate(topo.dims):
        if d <= 1:
            continue
        for step in ((1, -1) if d > 2 else (1,)):
            nc = list(c)
            nc[ax] = (c[ax] + step) % d
            out.append(topo.pos_of(nc))
    return tuple(out)


@lru_cache(maxsize=65536)
def _route_cached(topo: Topology, a: int, b: int,
                  avoid: Optional[frozenset]) -> Tuple[Tuple[int, int], ...]:
    """Memoized :meth:`Topology.route`.  ``ValueError`` (partitioned fabric)
    propagates uncached, so probing again after links heal re-routes."""
    return tuple(topo._route_uncached(a, b, avoid))


@lru_cache(maxsize=65536)
def _internal_links_cached(topo: Topology,
                           positions: Tuple[int, ...]) -> frozenset:
    """Memoized :meth:`Topology.internal_links` (frozenset is shared-safe)."""
    ps = set(positions)
    out = set()
    for p in ps:
        for nb in _neighbors_cached(topo, p):
            if nb in ps:
                out.add(undirected_pair(topo.ids[p], topo.ids[nb]))
    return frozenset(out)


@lru_cache(maxsize=128)
def _sub_slices_cached(topo: Topology, k: int) -> Tuple[Tuple[int, ...], ...]:
    """Memoized body of :meth:`Topology.sub_slices` — Topology is frozen, so
    the ranked candidate list is pure in (topology, k) and the cluster loop's
    per-event ``select()`` calls must not re-enumerate it.

    Bounding: EVERY factorization contributes its anchors (up to
    :data:`_MAX_SLICES` anchor positions each — fleets beyond that many
    devices only enumerate blocks anchored in the first ``_MAX_SLICES``
    positions), then the union is ranked and truncated.  So a compact
    factorization (2x2) can never be crowded out of the list by a
    stripe-shaped one (1x4) that happened to be generated first.
    """
    n = topo.num_devices
    if k <= 0 or k > n:
        return ()
    cands: set = set()
    if topo.kind == "torus":
        for dims_k in _factorizations(k, len(topo.dims)):
            if any(dk > d for dk, d in zip(dims_k, topo.dims)):
                continue
            for anchor in range(min(n, _MAX_SLICES)):
                a = topo.coords(anchor)
                block = [topo.pos_of([(a[ax] + off[ax]) % topo.dims[ax]
                                      for ax in range(len(topo.dims))])
                         for off in itertools.product(
                             *[range(dk) for dk in dims_k])]
                cands.add(tuple(sorted(block)))
    else:
        for anchor in range(min(n, _MAX_SLICES)):
            cands.add(tuple(sorted((anchor + i) % n for i in range(k))))
    ranked = sorted(cands, key=lambda c: (topo.diameter(c),
                                          topo._pairwise_sum(c), c))
    return tuple(ranked[:_MAX_SLICES])


@lru_cache(maxsize=256)
def _factorizations(k: int, num_axes: int) -> Tuple[Tuple[int, ...], ...]:
    """All ordered factorizations of ``k`` into ``num_axes`` factors."""
    if num_axes == 1:
        return ((k,),)
    out = []
    for f in range(1, k + 1):
        if k % f == 0:
            for rest in _factorizations(k // f, num_axes - 1):
                out.append((f,) + rest)
    return tuple(out)
