"""Regions of the port's model code: profiler ranges in eager steps, the
region tables of captured CUDA graphs, and the markers that find a traced
replay's device work.

A region (``with region("moe.route"):``) names a stretch of model code.
What it does depends on what is going on around it:

* while a ``torch.profiler`` session records, it is the profiler range
  ``"repro." + name`` (:func:`repro_torch.obs.trace.profiler_range`): an
  eager step on the card, and any step on the CPU;
* while a compiled step is captured into a CUDA graph on the current
  stream (inside :func:`capture`), it writes a boundary into the capture's
  :class:`RegionTable`: the number of device-work nodes (kernel, memcpy and
  memset nodes) the graph being captured holds on entry and on exit, read
  from the driver (``cuStreamGetCaptureInfo`` gives the graph,
  ``cuGraphGetNodes`` and ``cuGraphNodeGetType`` its nodes).  A node
  belongs to the innermost region open while it was captured.  Captures
  are keyed by their stream, not their thread: a training step's backward
  runs on autograd's device thread, on the capture stream;
* otherwise nothing, after two checks.

The boundaries are read at capture, which is set-up: nothing is added to a
graph, and a replay runs no region code.  The tables are kept in
:data:`TABLES` as names and integers, so they outlive the graphs (a
benchmark reads them after freeing its server).

While a profiler records, :class:`~repro_torch.runtime.jit.Graph` launches
markers around each replay (:func:`mark_begin`, :func:`mark_end`), and
never otherwise: ATen's ``spin_kernel`` (``torch.cuda._sleep(0)``), which no
other code of the port launches, once before the graph and twice after it.
A reader of the device trace finds a replay's events between them and puts
the i-th of them down to the i-th node of the table (the benchmark's
``port_bench/replays.py``).  The marker kernel is launched once when a graph
is captured (:func:`warm`), so that its lazy loading falls in set-up and
not in a traced segment.
"""
from __future__ import annotations

import contextlib
import ctypes
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _profiler

from repro_torch.obs.trace import _NULL_SPAN, profiler_range

#: ``CUgraphNodeType`` of the nodes that are device work: kernel, memcpy, memset
_WORK = (0, 1, 2)
#: ``CU_STREAM_CAPTURE_STATUS_ACTIVE``
_ACTIVE = 1


@dataclass(frozen=True)
class RegionTable:
    """The regions of one captured graph: ``nodes`` device-work nodes in
    capture order, and each region as (name, first node, end node, depth)."""
    step: str
    nodes: int
    regions: Tuple[Tuple[str, int, int, int], ...]


#: every table captured in this process, oldest first
TABLES: List[RegionTable] = []


def table(step: str) -> Optional[RegionTable]:
    """The newest table of the compiled step named ``step``, if any."""
    return next((t for t in reversed(TABLES) if t.step == step), None)


class _Driver:
    """The few driver calls a capture's node count needs, over ``libcuda``."""

    def __init__(self) -> None:
        lib = ctypes.CDLL("libcuda.so.1")
        vp, sz = ctypes.c_void_p, ctypes.c_size_t
        self._get_nodes = lib.cuGraphGetNodes
        self._get_nodes.argtypes = (vp, ctypes.POINTER(vp), ctypes.POINTER(sz))
        self._node_type = lib.cuGraphNodeGetType
        self._node_type.argtypes = (vp, ctypes.POINTER(ctypes.c_int))
        # v3 (CUDA 12.3 on) adds the edges' data before the dependency count
        self._v3 = not hasattr(lib, "cuStreamGetCaptureInfo_v2")
        self._info = (lib.cuStreamGetCaptureInfo_v3 if self._v3
                      else lib.cuStreamGetCaptureInfo_v2)
        for f in (self._get_nodes, self._node_type, self._info):
            f.restype = ctypes.c_int

    def graph(self, stream: int) -> int:
        """The graph being captured on ``stream``."""
        status, cid, graph = ctypes.c_int(), ctypes.c_uint64(), ctypes.c_void_p()
        deps, edges, n = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_size_t()
        args = [ctypes.c_void_p(stream), ctypes.byref(status), ctypes.byref(cid),
                ctypes.byref(graph), ctypes.byref(deps)]
        args += [ctypes.byref(edges)] if self._v3 else []
        rc = self._info(*args, ctypes.byref(n))
        if rc != 0 or status.value != _ACTIVE or not graph.value:
            raise RuntimeError(f"no capture on stream {stream:#x} (CUresult {rc})")
        return graph.value

    def nodes(self, graph: int, n: int) -> Sequence[Optional[int]]:
        """The graph's first ``n`` nodes, in the order the driver keeps them
        (the order they were added)."""
        count = ctypes.c_size_t(n)
        arr = (ctypes.c_void_p * n)()
        self._check(self._get_nodes(graph, arr, ctypes.byref(count)))
        return arr

    def count(self, graph: int) -> int:
        n = ctypes.c_size_t()
        self._check(self._get_nodes(graph, None, ctypes.byref(n)))
        return n.value

    def is_work(self, node: int) -> bool:
        kind = ctypes.c_int()
        self._check(self._node_type(node, ctypes.byref(kind)))
        return kind.value in _WORK

    @staticmethod
    def _check(rc: int) -> None:
        if rc != 0:
            raise RuntimeError(f"CUDA driver call failed (CUresult {rc})")


_DRIVER: Optional[_Driver] = None


def _driver() -> _Driver:
    global _DRIVER
    if _DRIVER is None:
        _DRIVER = _Driver()
    return _DRIVER


class Capture:
    """One capture in progress: the regions written so far, and ``kept``,
    the tensors the graph rewrites at each replay that a counter reads
    after it (``moe_ffn``'s ``filled``)."""

    def __init__(self, step: str, stream: int):
        self.step = step
        self.stream = stream
        self.regions: List[Tuple[str, int, int, int]] = []
        self.depth = 0
        self.kept: List[Any] = []
        self.failed: Optional[str] = None
        self._count = 0
        self._last: Optional[int] = None
        self._work = 0

    def nodes(self) -> int:
        """The device-work nodes captured so far (0 once a read failed).
        Only the nodes added since the last read are typed: the driver
        keeps a graph's nodes in the order they were added, which the read
        checks (the last node it saw must still stand where it stood)."""
        if self.failed is not None:
            return 0
        try:
            d = _driver()
            graph = d.graph(self.stream)
            n = d.count(graph)
            if n != self._count:
                arr = d.nodes(graph, n)
                if self._count and arr[self._count - 1] != self._last:
                    raise RuntimeError("the driver did not keep the graph's nodes in order")
                self._work += sum(d.is_work(x) for x in arr[self._count:n])
                self._count, self._last = n, arr[n - 1]
        except (OSError, AttributeError, RuntimeError) as e:
            self.failed = str(e)
            return 0
        return self._work

    def finish(self) -> Optional[int]:
        """Register the capture's table (the last work of the capture) and
        return its index in :data:`TABLES`; None where the driver could
        not be read."""
        nodes = self.nodes()
        if self.failed is not None:
            return None
        TABLES.append(RegionTable(self.step, nodes, tuple(self.regions)))
        return len(TABLES) - 1


#: the captures in progress, by their stream's handle
_CAPTURES: Dict[int, Capture] = {}


@contextlib.contextmanager
def capture(step: str, stream: Any) -> Iterator[Capture]:
    """The capture of the compiled step ``step`` on ``stream`` (a
    ``torch.cuda.Stream`` that is capturing): regions opened on that stream
    meanwhile write into its table."""
    cap = _CAPTURES[stream.cuda_stream] = Capture(step, stream.cuda_stream)
    try:
        yield cap
    finally:
        _CAPTURES.pop(cap.stream, None)


def capturing() -> Optional[Capture]:
    """The capture in progress on the current stream, if any."""
    if not _CAPTURES:
        return None
    return _CAPTURES.get(torch.cuda.current_stream().cuda_stream)


class _Region:
    __slots__ = ("name", "_cap", "_first", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Region":
        self._cap = cap = capturing()
        if cap is not None:
            self._first = cap.nodes()
            cap.depth += 1
        self._range = profiler_range(self.name) if _profiler._is_profiler_enabled else None
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is not None:
            self._range.__exit__(None, None, None)
        cap = self._cap
        if cap is not None:
            cap.depth -= 1
            cap.regions.append((self.name, self._first, cap.nodes(), cap.depth))
        return False


def region(name: str):
    """Context manager naming a stretch of model code (see the module
    docstring); the shared no-op while nothing is captured and no profiler
    records."""
    if not _CAPTURES and not _profiler._is_profiler_enabled:
        return _NULL_SPAN
    return _Region(name)


#: the compiled step running eagerly now, for counts made inline
_STEP: List[str] = []


def current_step() -> str:
    """The compiled step that runs eagerly now ("eager" outside any)."""
    return _STEP[-1] if _STEP else "eager"


class _Step:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Step":
        _STEP.append(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        _STEP.pop()
        return False


def step(name: str):
    """Context manager labelling the counts made inline (eager steps, the
    CPU) with the compiled step ``name``; the shared no-op while no
    profiler records."""
    if not _profiler._is_profiler_enabled:
        return _NULL_SPAN
    return _Step(name)


# ---------------------------------------------------------------------------
# Markers around a traced replay
# ---------------------------------------------------------------------------

def mark_begin() -> None:
    """The marker launched before a replay, on the current stream."""
    torch.cuda._sleep(0)


def mark_end() -> None:
    """The two markers launched after a replay."""
    torch.cuda._sleep(0)
    torch.cuda._sleep(0)


def warm() -> None:
    """Launch the marker once (at set-up: CUDA loads a kernel lazily, at its
    first launch, which would otherwise fall in the first traced replay)."""
    torch.cuda._sleep(0)
