"""Live-range buffer allocator over the ``hlo_ir`` def-use graph.

The engine schedules ops in program order per invocation (the scheduler's
per-invocation node ids); this module turns that walk into an HBM address
map with a *linear scan*: every value-producing op defines a buffer of its
output bytes when scheduled, the buffer stays live until its last consumer
in the defining computation runs (root values until the invocation closes),
and addresses are assigned first-fit over the gaps the dead buffers leave.

What comes out:

* a **placement** (``offset``, ``size``) per buffer — the thing the channel
  model anchors camping subsets to;
* **peak_live_bytes** — the simulated step's HBM footprint high-water mark;
* **high_water_offset** — the fragmented high-water address (>= peak);
* an **oversubscription report**: a buffer that cannot fit below capacity is
  still placed (above the capacity line) and recorded — the allocator
  reports, it never crashes, so a too-big model still simulates.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Buffer:
    """One allocated HBM value (a scheduled op's output)."""

    node_id: str        # per-invocation node id ("inv:comp/op")
    name: str           # defining op name
    comp: str           # defining computation name
    size: int           # bytes
    offset: int         # assigned HBM byte offset
    def_index: int      # allocation order serial (global, monotonic)
    free_index: int = -1  # order serial when released (-1 = still live)

    @property
    def end(self) -> int:
        return self.offset + self.size


@dataclass
class AllocationMap:
    """The allocator's final report for one simulated run."""

    hbm_capacity: int
    buffers: List[Buffer] = field(default_factory=list)
    peak_live_bytes: int = 0         # max simultaneous live bytes
    high_water_offset: int = 0       # max (offset + size) ever assigned
    oversubscribed: List[str] = field(default_factory=list)  # node ids

    @property
    def peak_fraction(self) -> float:
        if self.hbm_capacity <= 0:
            return 0.0
        return self.peak_live_bytes / self.hbm_capacity

    @property
    def fits(self) -> bool:
        return not self.oversubscribed

    def table(self, top: int = 8) -> str:
        """ASCII summary: footprint line + the largest buffers."""
        lines = [
            f"HBM footprint: peak {self.peak_live_bytes / 2**20:.2f} MiB "
            f"of {self.hbm_capacity / 2**30:.1f} GiB "
            f"({self.peak_fraction * 100:.1f}%), "
            f"{len(self.buffers)} buffers, high water "
            f"{self.high_water_offset / 2**20:.2f} MiB"
        ]
        if self.oversubscribed:
            lines.append(f"  OVERSUBSCRIBED: {len(self.oversubscribed)} "
                         f"buffer(s) placed above capacity, e.g. "
                         f"{self.oversubscribed[0]}")
        for b in sorted(self.buffers, key=lambda b: -b.size)[:top]:
            lines.append(f"  {b.name:<32s} {b.size / 2**20:9.2f} MiB "
                         f"@ {b.offset / 2**20:9.2f} MiB  [{b.comp}]")
        return "\n".join(lines)


class LinearScanAllocator:
    """First-fit linear-scan allocator driven in schedule order.

    The engine calls :meth:`define` when an op's output comes into existence
    and :meth:`release` when its live range ends; :meth:`finish` seals the
    run into an :class:`AllocationMap`.
    """

    def __init__(self, hbm_capacity: int):
        self.capacity = int(hbm_capacity)
        self._active: List[Buffer] = []       # sorted by offset
        self._all: List[Buffer] = []
        self._by_id: Dict[str, Buffer] = {}
        self._live_bytes = 0
        self._serial = 0
        self._map = AllocationMap(hbm_capacity=self.capacity)

    # ------------------------------------------------------------------
    def define(self, node_id: str, name: str, comp: str, size: int) -> Buffer:
        """Allocate ``size`` bytes first-fit; above capacity if nothing fits
        (recorded in ``oversubscribed``, never an exception)."""
        size = max(int(size), 0)
        offset = self._first_fit(size)
        buf = Buffer(node_id, name, comp, size, offset, self._serial)
        self._serial += 1
        # insert keeping the active list offset-sorted (O(log n) search)
        bisect.insort(self._active, buf, key=lambda b: b.offset)
        self._all.append(buf)
        self._by_id[node_id] = buf
        self._live_bytes += size
        self._map.peak_live_bytes = max(self._map.peak_live_bytes,
                                        self._live_bytes)
        self._map.high_water_offset = max(self._map.high_water_offset,
                                          buf.end)
        if size > 0 and buf.end > self.capacity:
            self._map.oversubscribed.append(node_id)
        return buf

    def release(self, node_id: str) -> None:
        buf = self._by_id.get(node_id)
        if buf is None or buf.free_index >= 0:
            return
        buf.free_index = self._serial
        self._serial += 1
        # locate by offset (sorted), then identity-scan the equal-offset run
        i = bisect.bisect_left(self._active, buf.offset,
                               key=lambda b: b.offset)
        while i < len(self._active) and self._active[i].offset == buf.offset:
            if self._active[i] is buf:
                del self._active[i]
                break
            i += 1
        self._live_bytes -= buf.size

    def get(self, node_id: str) -> Optional[Buffer]:
        return self._by_id.get(node_id)

    @property
    def live_bytes(self) -> int:
        return self._live_bytes

    def finish(self) -> AllocationMap:
        self._map.buffers = list(self._all)
        return self._map

    # ------------------------------------------------------------------
    def _first_fit(self, size: int) -> int:
        """Lowest offset with a ``size``-byte gap among the live buffers.

        A zero-size buffer packs at the end of the last live buffer; a
        buffer larger than every gap goes after the last live one even if
        that lands above capacity (the oversubscription case)."""
        prev_end = 0
        for buf in self._active:
            if buf.offset - prev_end >= size:
                return prev_end
            prev_end = max(prev_end, buf.end)
        return prev_end
