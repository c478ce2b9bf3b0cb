"""Hierarchical span tracer: a flight recorder for the simulator itself,
and the port's host ranges on the device trace's clock.

Every other trace in this repo is about *simulated* time (engine
timelines, fleet slices); this one is about the **simulator's own
wall-clock** — which stage of ``Engine.simulate`` a cluster run spends its
seconds in, how long one ``lower_collective`` miss takes, when the event
loop hit a FAIL/REPAIR burst.  That is the cross-layer question the
scattered ``--self-profile`` timers could not answer: a span records its
*ancestry*, so "this replay happened inside that gang start inside that
cluster run" survives into the export.

The same spans mark the port's own work on the card (``Server.generate``'s
phases, a compiled step's dispatch, replay, first call and capture, the
data pipeline's wait).  While a ``torch.profiler`` session records, a span
also opens a profiler range named ``"repro." + name``, with its attributes
as the range's keyword arguments (kept where the session records shapes):
the range is one of the profiler's host events, on the clock its kernels
are stamped with, so a reader of the device trace names what the host was
doing around any kernel or idle gap.  The range is a function-scope
``RecordFunction`` (the C side of ``record_function``): a user-scope one
would also put a copy of itself on the device's timeline, spanning the
kernels launched inside it, which a reader of device events would count as
device work.

Design constraints (this code sits on the engine/cluster hot paths and on
the serving loop):

* **disabled by default, near-free when disabled** — :meth:`SpanTracer.
  span` returns a shared no-op context manager after two attribute checks
  (the tracer's switch and the profiler's), and :meth:`SpanTracer.instant`
  returns immediately.  What holds the off cost on the card is the port's
  benchmark (``port_bench/``): its timed runs record with no profiler and
  the tracer off, and each end-to-end metric is held to its parent's;
* **bounded memory** — records land in a ring buffer (default 65536
  spans): a million-job cluster run keeps the *most recent* window, the
  flight-recorder convention, and ``dropped`` counts what aged out;
* **hierarchical without bookkeeping at the call site** — the tracer
  maintains a depth/parent stack; ``with TRACER.span("engine.replay")``
  is the whole API;
* **one identifier a request** — inside ``with TRACER.request():`` every
  span carries the request's ``call`` number (one ``Server.generate``
  call's spans share one).

Usage::

    from repro_torch.obs.trace import TRACER
    TRACER.enable()
    with TRACER.span("cluster.run", policy="sjf"):
        ...
    events = TRACER.to_chrome_events()      # compose into any trace file

The module-level :data:`TRACER` is the instance every instrumented layer
(engine, fastsched, cluster events, topology lowering, faults, the port's
server, compiled steps and data pipeline) uses; tests may build private
:class:`SpanTracer` instances.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

#: chrome-trace pid reserved for simulator-self spans (simulated-time
#: tracks use pid 0), so both compose into one trace file without clashes
SELF_PID = 1


class SpanRecord:
    """One finished span (or zero-duration instant) in the flight recorder."""

    __slots__ = ("name", "t0", "t1", "depth", "parent", "seq", "attrs")

    def __init__(self, name: str, t0: float, t1: float, depth: int,
                 parent: Optional[str], seq: int,
                 attrs: Optional[Dict[str, Any]]):
        self.name = name
        self.t0 = t0              # perf_counter seconds, tracer-relative
        self.t1 = t1
        self.depth = depth
        self.parent = parent      # enclosing span's name, or None
        self.seq = seq            # monotone id (ring-buffer drop detection)
        self.attrs = attrs

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "t0": self.t0, "t1": self.t1,
                "depth": self.depth, "parent": self.parent,
                "seq": self.seq, "attrs": self.attrs or {}}


class _NullSpan:
    """Shared no-op context manager: the disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def profiler_range(name: str, attrs: Optional[Dict[str, Any]] = None):
    """Open the profiler range ``"repro." + name`` (see the module
    docstring) and return it; the caller closes it with ``__exit__``.
    Attributes the profiler cannot keep (anything but a number, a string
    or a bool) go as their ``str``."""
    kw = {k: v if isinstance(v, (bool, int, float, str)) else str(v)
          for k, v in (attrs or {}).items()}
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    rf = (fast("repro." + name, (), kw) if fast is not None
          else _profiler.record_function("repro." + name))
    rf.__enter__()
    return rf


class _Span:
    """Live span: measures on ``__exit__`` and records itself into the ring
    (tracer enabled), into the profiler's session (one recording), or
    both."""

    __slots__ = ("_tracer", "name", "attrs", "t0", "_ring", "_range")

    def __init__(self, tracer: "SpanTracer", name: str,
                 attrs: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0
        self._ring = False
        self._range = None

    def __enter__(self) -> "_Span":
        tr = self._tracer
        if _profiler._is_profiler_enabled:
            self._range = profiler_range(self.name, self.attrs)
        self._ring = tr.enabled
        if self._ring:
            tr._stack.append(self.name)
            self.t0 = time.perf_counter() - tr._epoch
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tracer
        if self._ring:
            t1 = time.perf_counter() - tr._epoch
            stack = tr._stack
            stack.pop()
            tr._record(SpanRecord(
                self.name, self.t0, t1, len(stack),
                stack[-1] if stack else None, next(tr._seq), self.attrs))
        if self._range is not None:
            self._range.__exit__(None, None, None)
        return False


class _Request:
    """The extent of one request: its spans carry its ``call`` number."""

    __slots__ = ("_tracer", "_outer")

    def __init__(self, tracer: "SpanTracer"):
        self._tracer = tracer
        self._outer: Optional[int] = None

    def __enter__(self) -> "_Request":
        tr = self._tracer
        self._outer = tr._call
        tr._call = next(tr._calls)
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._call = self._outer
        return False


class SpanTracer:
    """Ring-buffered hierarchical span recorder (see module docstring)."""

    def __init__(self, capacity: int = 65536):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.enabled = False
        self._epoch = time.perf_counter()
        self._ring: deque = deque(maxlen=capacity)
        self._stack: List[str] = []
        self._seq = itertools.count()
        self._recorded = 0
        self._calls = itertools.count()
        self._call: Optional[int] = None

    # -- recording ------------------------------------------------------
    def span(self, name: str, **attrs: Any):
        """Context manager timing one span; the shared no-op while the
        tracer is disabled and no profiler records.

        Keyword arguments become the span's ``attrs`` payload (carried
        into the chrome-trace ``args`` and the profiler range's keyword
        arguments), with the enclosing request's ``call`` number."""
        if not self.enabled and not _profiler._is_profiler_enabled:
            return _NULL_SPAN
        if self._call is not None:
            attrs["call"] = self._call
        return _Span(self, name, attrs or None)

    def request(self):
        """Context manager for one request (a ``Server.generate`` call):
        the spans opened inside it carry one ``call`` number, a new one at
        each request; the shared no-op while nothing records."""
        if not self.enabled and not _profiler._is_profiler_enabled:
            return _NULL_SPAN
        return _Request(self)

    def instant(self, name: str, **attrs: Any) -> None:
        """Record a zero-duration marker (FAIL/REPAIR events, gang kills)."""
        if not self.enabled:
            return
        t = time.perf_counter() - self._epoch
        stack = self._stack
        self._record(SpanRecord(name, t, t, len(stack),
                                stack[-1] if stack else None,
                                next(self._seq), attrs or None))

    def _record(self, rec: SpanRecord) -> None:
        self._ring.append(rec)
        self._recorded += 1

    # -- lifecycle ------------------------------------------------------
    def enable(self) -> "SpanTracer":
        self.enabled = True
        return self

    def disable(self) -> "SpanTracer":
        self.enabled = False
        return self

    def clear(self) -> None:
        self._ring.clear()
        self._stack.clear()
        self._recorded = 0
        self._epoch = time.perf_counter()

    # -- reading --------------------------------------------------------
    @property
    def records(self) -> List[SpanRecord]:
        """Current ring contents, oldest first (completion order)."""
        return list(self._ring)

    @property
    def dropped(self) -> int:
        """Spans that aged out of the ring (flight-recorder overwrite)."""
        return max(self._recorded - len(self._ring), 0)

    def drain(self) -> List[SpanRecord]:
        """Return and clear the ring (the stack/epoch keep running)."""
        out = list(self._ring)
        self._ring.clear()
        return out

    def iter_named(self, prefix: str) -> Iterator[SpanRecord]:
        return (r for r in self._ring if r.name.startswith(prefix))

    def total_seconds(self, name: str) -> float:
        """Summed duration of every recorded span with this exact name."""
        return sum(r.duration_s for r in self._ring if r.name == name)

    # -- export ---------------------------------------------------------
    def to_chrome_events(self, pid: int = SELF_PID) -> List[dict]:
        """Spans as Trace Event Format events on one lane per depth.

        Uses the shared helpers in :mod:`repro_torch.obs.export`, so the result
        composes with engine / fleet / time-lapse tracks into one file.
        """
        from repro_torch.obs.export import (duration_event, instant_event,
                                      thread_meta)
        if not self._ring:
            return []
        depths = sorted({r.depth for r in self._ring})
        events = [thread_meta(f"spans/depth{d}", tid=d, pid=pid)
                  for d in depths]
        for r in self._ring:
            args = dict(r.attrs or {})
            if r.parent:
                args["parent"] = r.parent
            if r.t1 > r.t0:
                events.append(duration_event(
                    r.name, "span", r.t0, r.t1 - r.t0, tid=r.depth, pid=pid,
                    args=args))
            else:
                events.append(instant_event(r.name, "span", r.t0,
                                            tid=r.depth, pid=pid, args=args))
        return events

    def summary(self) -> Dict[str, Tuple[int, float]]:
        """``{span name: (count, total seconds)}`` over the ring."""
        out: Dict[str, Tuple[int, float]] = {}
        for r in self._ring:
            n, s = out.get(r.name, (0, 0.0))
            out[r.name] = (n + 1, s + r.duration_s)
        return out


#: the process-wide tracer every instrumented layer reports to
TRACER = SpanTracer()
