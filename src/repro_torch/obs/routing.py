"""Counts of a mixture-of-experts FFN's routing, by compiled step.

Three counts a layer and step: the (token, choice) pairs routed, those
dropped past their expert's capacity, and the experts with a filled slot
in the step's batch (the experts whose weights the step needed; a decode
step reads all of them).  All three come from ``route``'s ``filled`` (b, e
* cap) mask: a kept choice fills one slot, so the dropped ones are the
routed less the filled slots.

They are counted only while a profiler records, and cost nothing
otherwise:

* at capture, ``moe_ffn`` hands its ``filled`` tensor to the capture
  (:meth:`repro_torch.obs.regions.Capture.kept`); the graph keeps it
  alive and rewrites it at every replay.  While a profiler records, each
  replay is followed by the few kernels of :func:`count` over the graph's
  kept tensors (stacked: a few kernels a replay, not a few a layer);
* in an eager step (and on the CPU) ``moe_ffn`` counts inline.

The counts add up on the device, labelled by the compiled step they came
from ("prefill", "decode", "train", or "eager"), and reach
:data:`repro_torch.obs.metrics.REGISTRY` at :func:`flush` (``Server.generate``
flushes at the sync it ends with) as the counters
``moe_choices_routed_total``, ``moe_choices_dropped_total``,
``moe_experts_filled_total`` and ``moe_experts_read_total`` (the experts
of every counted layer and step), each with a ``step`` label.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.autograd.profiler as _profiler

from repro_torch.obs import regions
from repro_torch.obs.metrics import REGISTRY


class _Pending:
    """One step's counts not yet flushed: the filled slots and the experts
    with one on the device, the rest on the host."""

    def __init__(self, device: torch.device):
        self.on_device = torch.zeros(2, dtype=torch.int64, device=device)
        self.routed = 0
        self.read = 0


_PENDING: Dict[str, _Pending] = {}


def note(filled: torch.Tensor, experts: int, routed: int) -> None:
    """``moe_ffn``'s hook after routing one layer: ``filled`` its (b,
    experts * cap) mask, ``routed`` its b * s * k choices.  Kept at
    capture, counted inline while a profiler records, ignored otherwise
    (and on a mesh, whose shards count no whole batch)."""
    if type(filled) is not torch.Tensor:
        return
    cap = regions.capturing()
    if cap is not None:
        cap.kept.append((filled, experts, routed))
    elif _profiler._is_profiler_enabled:
        count(regions.current_step(), [(filled, experts, routed)])


def _tally(kept: Sequence[tuple]) -> torch.Tensor:
    """The filled slots and the experts with one, summed over ``kept``
    (``(filled, experts, routed)`` of each layer, one shape), on the
    device."""
    filled = [f for f, _, _ in kept]
    n, experts = len(filled), kept[0][1]
    slots = (torch.stack(filled) if n > 1 else filled[0][None]).reshape(
        n, filled[0].shape[0], experts, -1)
    return torch.stack([torch.count_nonzero(slots), torch.count_nonzero(slots.any(3).any(1))])


def count(step: str, kept: Sequence[tuple]) -> None:
    """Add the counts of ``kept`` to the step's pending counts."""
    tally = _tally(kept)
    p = _PENDING.get(step)
    if p is None:
        p = _PENDING[step] = _Pending(tally.device)
    p.on_device += tally
    p.routed += sum(r for _, _, r in kept)
    p.read += len(kept) * kept[0][1]


def warm(kept: Sequence[tuple]) -> None:
    """Launch the counting kernels once on a capture's kept tensors,
    counting nothing (at set-up: CUDA loads a kernel lazily, at its first
    launch, which would otherwise fall in the first traced replay)."""
    _tally(kept)


def flush() -> None:
    """Move the pending counts to the registry (reads the device: call it
    where the caller synchronizes anyway)."""
    for step, p in _PENDING.items():
        filled, touched = p.on_device.tolist()
        REGISTRY.counter("moe_choices_routed_total", step=step).inc(p.routed)
        REGISTRY.counter("moe_choices_dropped_total", step=step).inc(p.routed - filled)
        REGISTRY.counter("moe_experts_filled_total", step=step).inc(touched)
        REGISTRY.counter("moe_experts_read_total", step=step).inc(p.read)
    _PENDING.clear()
