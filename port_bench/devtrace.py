"""The device trace of a traced run: ``torch.profiler`` over a segment of
work after the measured window, reduced to what the per-layer readers need.

The harness marks what the host is doing with ranges of its own
(``bench.<phase>``, ``torch.profiler.record_function``): a phase's device
work is the work that runs inside its host range, since every phase the
loops mark ends in a wait for the device (a token read back, a loss read).
Device events are the kernels, copies and fills the profiler records on the
card, graph replays' kernels included; the ranges' own copies on the device
(the profiler's GPU annotations) are not device work.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import torch

PREFIX = "bench."
WINDOW = PREFIX + "window"
TOP = 10


@dataclass
class Trace:
    """Intervals in ns on the profiler's clock."""
    window: Tuple[int, int]
    device: List[Tuple[str, int, int]]
    ranges: Dict[str, List[Tuple[int, int]]]
    host: List[Tuple[str, int, int]] = field(default_factory=list)

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_ns(self, lo: int, hi: int) -> int:
        """ns of [lo, hi) in which some device event ran."""
        busy, end = 0, lo
        for _, s, e in self.device:          # sorted by start
            if e <= end or s >= hi:
                continue
            s = max(s, end)
            e = min(e, hi)
            if e > s:
                busy += e - s
                end = e
        return busy

    def busy_s(self) -> float:
        return self.busy_ns(*self.window) / 1e9

    def idle_share(self, phase: str) -> Optional[float]:
        """The share of the phase's host ranges with no device event, or
        None where the trace holds no such range."""
        spans = self.ranges.get(PREFIX + phase, [])
        total = sum(e - s for s, e in spans)
        if not total:
            return None
        return 1.0 - sum(self.busy_ns(s, e) for s, e in spans) / total

    def kernels(self, match: str, phase: Optional[str] = None) -> List[int]:
        """Durations (ns) of the device events whose name holds ``match``
        and that start inside the phase's ranges (anywhere without one)."""
        spans = self.ranges.get(PREFIX + phase, []) if phase else [self.window]
        return [e - s for name, s, e in self.device
                if match in name and any(lo <= s < hi for lo, hi in spans)]

    def breakdown(self) -> dict:
        """The device operations that took most time and the longest idle
        gaps, each gap named by the innermost host event around it."""
        by_name: Dict[str, int] = {}
        for name, s, e in self.device:
            by_name[name] = by_name.get(name, 0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps, end = [], self.window[0]
        for _, s, e in self.device + [("", self.window[1], self.window[1])]:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        return {"device_ops": [[n, t / 1e9] for n, t in ops],
                "idle_gaps": [[self._host_at((s + e) // 2), (e - s) / 1e9] for s, e in gaps]}

    def _host_at(self, t: int) -> str:
        inside = [(e - s, name) for name, s, e in self.host if s <= t < e]
        return min(inside)[1] if inside else "host: outside any recorded event"


class Tracer:
    """Runs a segment under the profiler and keeps its :class:`Trace`."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.trace: Optional[Trace] = None
        self._open: Dict[str, object] = {}

    def _activities(self):
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return acts

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self) -> None:
        """Start and stop the profiler once, so that its own set-up on the
        card happens before any traced work."""
        from torch.profiler import profile
        with profile(activities=self._activities()):
            torch.zeros(1, device=self.device).add_(1)
            self._sync()

    @contextlib.contextmanager
    def segment(self) -> Iterator[None]:
        from torch.profiler import profile, record_function
        self._sync()
        with profile(activities=self._activities()) as prof:
            with record_function(WINDOW):
                yield
                self._sync()
        self.trace = reduce(prof.profiler.kineto_results.events())

    def enter(self, phase: str) -> None:
        """Open the host range of ``phase`` (closed by :meth:`leave`)."""
        from torch.profiler import record_function
        rf = record_function(PREFIX + phase)
        rf.__enter__()
        self._open[phase] = rf

    def leave(self, phase: str) -> None:
        rf = self._open.pop(phase, None)
        if rf is not None:
            rf.__exit__(None, None, None)


def reduce(events) -> Trace:
    device, ranges, host = [], {}, []
    window = None
    for ev in events:
        name, s, e = ev.name(), ev.start_ns(), ev.end_ns()
        on_device = ev.device_type() != torch.autograd.DeviceType.CPU
        if name.startswith(PREFIX):
            if not on_device:
                if name == WINDOW:
                    window = (s, e)
                else:
                    ranges.setdefault(name, []).append((s, e))
            continue
        (device if on_device else host).append((name, s, e))
    if window is None:
        raise RuntimeError("the profiler recorded no traced window")
    device.sort(key=lambda x: x[1])
    for spans in ranges.values():
        spans.sort()
    return Trace(window, device, ranges, host)


