"""Public wrapper: the ``repro_torch::ssd_scan`` op and the route to it.

A ``torch.library.custom_op`` with a fake implementation, so that a
captured prefill shows each layer's scan as one node.  On CUDA tensors it
launches the kernel (``csrc/ssd_scan.cu``); on CPU tensors it runs the
plain version, :func:`ssd_scan_ref`.

Which of the two the model's scan takes is chosen from what its inputs show
(:func:`scan_route`): the kernel where it is compiled for them and no
gradient is needed, else the plain loop (CPU tensors, fp32, ``meta``
tensors, a training forward, which differentiates the loop, and chunks off
the kernel's 8-row units, as HybridLM's chunk shrunk to divide some prompt
lengths).  There is no fallback: a call the route gives the kernel launches
it or raises.  The kernel reads xdt, B and C as the model's conv output
lies, the positions at unit stride; the op copies what does not lie so
(:func:`positions_major`: a prompt of a length off 8) into that layout.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.ssd_scan.kernel import (DTYPE_CODES, HEAD_DIM, MAX_CHUNK,
                                                 STATE_SIZES, padded, readable, ssd_scan)
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref


def scan_route(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
               state0: torch.Tensor, chunk: int) -> str:
    """``"kernel"`` for CUDA tensors in bfloat16 or float16 (fp32 dA and
    state) at a shape the kernel is compiled for (head dim ``HEAD_DIM``,
    state size in ``STATE_SIZES``, chunks of a multiple of 8 rows up to
    ``MAX_CHUNK``, a non-empty sequence) when no gradient is needed;
    ``"loop"`` otherwise."""
    tensors = (xdt, dA, B, C, state0)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    if (not grad and all(t.device.type == "cuda" for t in tensors)
            and xdt.dtype in DTYPE_CODES and B.dtype == C.dtype == xdt.dtype
            and dA.dtype == state0.dtype == torch.float32
            and xdt.shape[-1] == HEAD_DIM and B.shape[-1] in STATE_SIZES
            and 0 < chunk <= MAX_CHUNK and chunk % 8 == 0 and xdt.shape[1] > 0):
        return "kernel"
    return "loop"


def positions_major(x: torch.Tensor) -> torch.Tensor:
    """x (b, s, k, d) as the kernel reads it: x itself where it is
    :func:`readable` (the model's conv output, at a length of a multiple of
    8); else a copy with the positions at unit stride, each feature's row of
    positions padded to a multiple of 8."""
    if readable(x):
        return x
    b, s, k, d = x.shape
    rows = x.new_empty((b, k, d, padded(s)))[..., :s]
    return rows.permute(0, 3, 1, 2).copy_(x)


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def ssd_scan_op(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                state0: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """y (b, s, h, p) and the final state (b, h, p, n) fp32 of the scan of
    xdt (b, s, h, p), dA (b, s, h), B and C (b, s, g, n) from state0 in
    chunks of ``chunk`` rows (the last one shorter)."""
    if use_kernel(xdt, dA, B, C, state0):
        return ssd_scan(positions_major(xdt), dA, positions_major(B), positions_major(C),
                        state0.contiguous(), chunk)
    return ssd_scan_ref(xdt, dA, B, C, state0, chunk)


@ssd_scan_op.register_fake
def _(xdt, dA, B, C, state0, chunk):
    b, s, h, p = xdt.shape
    return (xdt.new_empty((b, s, h, p)),
            xdt.new_empty((b, h, p, B.shape[-1]), dtype=torch.float32))
