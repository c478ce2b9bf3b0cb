"""Address-interleaved per-channel HBM model (the paper's DRAM partitions).

The paper's strongest microarchitectural finding (§V, Figs. 22-25) is
*partition/bank camping*: some kernels concentrate their DRAM traffic on a
few memory partitions, so the aggregate bandwidth counter looks healthy
while individual channels saturate and gate the kernel.  This module is the
single source of truth for how simulated HBM traffic maps onto channels:

* **contiguous ops** (dots, fusions, copies, elementwise) stripe evenly
  across every channel — XLA/TPU tiled layouts interleave addresses at
  ``hw.hbm_interleave_bytes`` granularity, so a buffer-sized access covers
  all channels uniformly;
* **camping ops** (gather/scatter/dynamic-slice/sort — data-dependent
  addressing) land on a consecutive subset of ``CAMPING_FRACTION`` of the
  channels.  *Where* the subset starts is derived from the touched buffer's
  base address when the allocator placed one (two gathers into the same
  table camp the same channels; gathers into different tables may not), and
  from a deterministic name hash for legacy reports that carry no placement.

Everything downstream — the engine's per-channel clocks, the legacy
:mod:`repro_torch.core.vision` heatmap and the :mod:`repro_torch.analysis.channels`
detector — consumes these vectors instead of re-deriving its own model.
"""
from __future__ import annotations

from typing import List, Optional

#: ops whose access patterns concentrate on few HBM channels (camping);
#: matched as substrings against both opcode and op name, so fused camping
#: kernels ("fused_gather_...") classify too.
CAMPING_OPS = ("gather", "scatter", "dynamic-slice", "dynamic-update-slice",
               "sort")

#: fraction of the channels a camping op's traffic lands on (~1/4: the
#: data-dependent stride defeats the interleave the way strided accesses
#: defeat GDDR address swizzling in the paper).
CAMPING_FRACTION = 0.25


def is_camping_op(opcode: str, name: str) -> bool:
    """Does this op's access pattern concentrate on few HBM channels?"""
    return any(c in opcode or c in name for c in CAMPING_OPS)


def camped_channel_count(n_channels: int) -> int:
    """How many channels a camping op's traffic concentrates on."""
    return max(int(n_channels * CAMPING_FRACTION), 1)


def _fnv1a(text: str) -> int:
    """Deterministic 32-bit FNV-1a (Python's hash() is salted per process)."""
    h = 0x811C9DC5
    for ch in text.encode():
        h = ((h ^ ch) * 0x01000193) & 0xFFFFFFFF
    return h


def camped_start_channel(name: str, n_channels: int,
                         base_offset: Optional[int] = None,
                         interleave: int = 512) -> int:
    """First channel of a camping op's subset.

    With a placement (``base_offset`` from the live-range allocator) the
    start is a deterministic hash of the buffer's interleave-aligned base
    address — the physical story: which partitions a table camps on
    depends on where it sits, so two gathers into the SAME table camp the
    same channels while different tables generally do not.  (A plain
    ``(offset // interleave) % n`` would degenerate to channel 0 for every
    power-of-two-sized placement, because first-fit offsets are sums of
    tensor sizes.)  Without a placement (legacy reports), a deterministic
    hash of the op name.
    """
    if n_channels <= 1:
        return 0
    if base_offset is not None:
        return _fnv1a(str(base_offset // max(interleave, 1))) % n_channels
    return _fnv1a(name) % n_channels


def channel_bytes_for(opcode: str, name: str, nbytes: float, n_channels: int,
                      base_offset: Optional[int] = None,
                      interleave: int = 512) -> List[float]:
    """Per-channel byte vector for one op's HBM traffic.

    Contiguous ops stripe exactly evenly (the interleaved-layout baseline);
    camping ops concentrate on a consecutive ``camped_channel_count`` subset
    anchored by :func:`camped_start_channel`.
    """
    if n_channels <= 0:
        return []
    vec = [0.0] * n_channels
    if nbytes <= 0:
        return vec
    if is_camping_op(opcode, name):
        n = camped_channel_count(n_channels)
        start = camped_start_channel(name, n_channels, base_offset, interleave)
        share = nbytes / n
        for i in range(n):
            vec[(start + i) % n_channels] += share
    else:
        share = nbytes / n_channels
        for c in range(n_channels):
            vec[c] = share
    return vec


def add_striped(vec: List[float], nbytes: float) -> List[float]:
    """Add contiguous (evenly striped) traffic — e.g. VMEM spill streams —
    onto an existing per-channel vector, in place."""
    n = len(vec)
    if n and nbytes > 0:
        share = nbytes / n
        for c in range(n):
            vec[c] += share
    return vec


def channel_time(vec: List[float], channel_bw: float) -> float:
    """HBM duration under the per-channel model: the busiest channel gates
    the transfer — ``max_over_channels(bytes_on_channel / per_channel_bw)``.

    For an evenly striped op this equals the flat-clock ``bytes / hbm_bw``;
    for a camped op it dilates by ~``1 / CAMPING_FRACTION``.
    """
    if not vec or channel_bw <= 0:
        return 0.0
    return max(vec) / channel_bw


def legacy_channel_bytes(opcode: str, name: str, nbytes: float,
                         n_channels: int) -> List[float]:
    """Channel vector for a timeline entry that carries no placement
    (hand-built reports, pre-memory-subsystem captures)."""
    return channel_bytes_for(opcode, name, nbytes, n_channels)


def hbm_transfer_seconds(report) -> float:
    """Pure HBM transfer time on a report's timeline (duration minus the
    issue cost), the quantity the camping acceptance criterion is defined
    over: per-channel vs flat-clock dilation is measured on THIS, so the
    fixed per-op launch overhead cannot mask the memory effect.  Shared by
    ``tests/test_memory.py`` and ``benchmarks/memory_camping.py``."""
    return sum((e.duration - e.overhead_s) * e.scale
               for e in report.timeline if e.unit == "hbm")
