"""Functional-simulation mode: execute the workload for real (bit-exact),
no timing — GPGPU-Sim's fast mode.  The speed ratio vs. the performance
engine is reported, mirroring the paper's observed 7-8x functional/perf gap.

The port runs the step eagerly on its tensors' device and synchronizes the
device before it reads the clock, so ``wall_seconds`` covers the device's
work, not only its dispatch.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.utils._pytree import tree_leaves


@dataclass
class FunctionalResult:
    outputs: Any
    wall_seconds: float
    steps: int = 1


def _synchronize(tree: Any) -> None:
    """Wait for every CUDA device that holds a tensor of ``tree``."""
    for dev in {x.device for x in tree_leaves(tree)
                if isinstance(x, torch.Tensor) and x.is_cuda}:
        torch.cuda.synchronize(dev)


def run_functional(fn: Callable, *args, steps: int = 1,
                   carry_index: int = 0) -> FunctionalResult:
    """Execute ``fn`` ``steps`` times, threading output[carry_index] back into
    args[carry_index] (training-loop shape).  Returns last outputs + wall time.
    """
    args = list(args)
    _synchronize(args)
    t0 = time.perf_counter()
    out = None
    for _ in range(steps):
        out = fn(*args)
        if steps > 1 and isinstance(out, tuple):
            args[carry_index] = out[carry_index]
    _synchronize((out, args))
    return FunctionalResult(out, time.perf_counter() - t0, steps)
