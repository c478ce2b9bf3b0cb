"""Launcher of the SSD chunk-scan CUDA kernel (``csrc/ssd_scan.cu``): the
whole chunked scan of one Mamba2 layer's prefill in one launch, bf16 or fp16
in and out, the state in fp32.

It replaces no TPU kernel (the reference scans with ``lax.scan``); its
plain version is :func:`repro_torch.kernels.ssd_scan.ref.ssd_scan_ref`.  The
CUDA source is built at the first call; see the note at its top for the
design.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.dispatch import Entry, counted, launch

#: the head dim and the state sizes compiled into the library: the
#: published Zamba2 and both smoke configs
HEAD_DIM = 64
STATE_SIZES = (16, 64)
#: the longest chunk the kernel keeps on chip
MAX_CHUNK = 256
DTYPE_CODES = {torch.bfloat16: 1, torch.float16: 2}
_ENTRY = Entry("ssd_scan", "repro_ssd_scan",
               [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
               + [ctypes.c_void_p])


def readable(x: torch.Tensor) -> bool:
    """Whether the kernel reads a 16-bit (b, s, heads or groups, d) tensor
    as it lies: the positions at unit stride, as the model's conv output
    lies.  It copies 8 positions (16 bytes) at a time, so the base and every
    other stepped stride must fall on 16-byte boundaries."""
    size = x.element_size()
    return (x.stride(1) == 1 and x.data_ptr() % 16 == 0
            and all(x.shape[d] == 1 or x.stride(d) * size % 16 == 0 for d in (0, 2, 3)))


def padded(s: int) -> int:
    """The length of each feature's row of ``s`` positions in the layout
    :func:`readable` names: ``s`` rounded up to 8 positions, 16 bytes of a
    16-bit type."""
    return -(-s // 8) * 8


def _strides(x: torch.Tensor) -> Tuple[int, int, int]:
    """x's strides but the positions' (unit, as :func:`readable` holds)."""
    return x.stride(0), x.stride(2), x.stride(3)


@counted
def ssd_scan(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
             state0: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """xdt (b, s, h, 64) and B, C (b, s, g, n) of one 16-bit dtype, dA
    (b, s, h) and state0 (b, h, 64, n) in fp32, all on one CUDA device ->
    y (b, s, h, 64) in xdt's dtype and the final state (b, h, 64, n) fp32,
    both contiguous: the scan in chunks of ``chunk`` rows (the last one
    s - (chunks - 1) chunk), on the card.

    n in ``STATE_SIZES``, g dividing h, chunk a multiple of 8 up to
    ``MAX_CHUNK``, s > 0; xdt, B and C each :func:`readable`; state0
    contiguous.  One
    launch; two calls on the same inputs give the same bits.  Raises on
    anything else, and if the launch fails.
    """
    tensors = (xdt, dA, B, C, state0)
    if not all(t.is_cuda and t.device == xdt.device for t in tensors):
        raise ValueError("ssd_scan needs every input on one CUDA device; got "
                         f"{[str(t.device) for t in tensors]}")
    if (xdt.dtype not in DTYPE_CODES or B.dtype != xdt.dtype or C.dtype != xdt.dtype
            or dA.dtype != torch.float32 or state0.dtype != torch.float32):
        raise TypeError("ssd_scan takes xdt, B, C in one of bfloat16 and float16 and dA, "
                        f"state0 in float32; got {xdt.dtype}, {B.dtype}, {C.dtype}, "
                        f"{dA.dtype}, {state0.dtype}")
    b, s, h, p = xdt.shape
    g, n = B.shape[2], B.shape[3]
    if (p != HEAD_DIM or n not in STATE_SIZES or s == 0 or g == 0 or h % g
            or tuple(dA.shape) != (b, s, h) or tuple(B.shape) != (b, s, g, n)
            or C.shape != B.shape or tuple(state0.shape) != (b, h, p, n)):
        raise ValueError(f"ssd_scan takes xdt (b, s, h, {HEAD_DIM}), dA (b, s, h), B and C "
                         f"(b, s, g, n) with g dividing h and n in {STATE_SIZES}, state0 "
                         f"(b, h, {HEAD_DIM}, n); got {tuple(xdt.shape)}, "
                         f"{tuple(dA.shape)}, {tuple(B.shape)}, {tuple(C.shape)}, "
                         f"{tuple(state0.shape)}")
    if not (0 < chunk <= MAX_CHUNK and chunk % 8 == 0):
        raise ValueError(f"ssd_scan takes chunks of a multiple of 8 rows up to {MAX_CHUNK}; "
                         f"got {chunk}")
    if not all(readable(x) for x in (xdt, B, C)):
        raise ValueError("ssd_scan reads xdt, B and C with the positions at unit stride, "
                         "16-byte aligned; got strides "
                         f"{xdt.stride()}, {B.stride()}, {C.stride()}")
    if not state0.is_contiguous():
        raise ValueError("ssd_scan takes a contiguous state0")
    y = torch.empty((b, s, h, p), dtype=xdt.dtype, device=xdt.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=xdt.device)
    launch(_ENTRY, ssd_scan, xdt.device, xdt.data_ptr(), dA.data_ptr(), B.data_ptr(),
           C.data_ptr(), state0.data_ptr(), y.data_ptr(), state.data_ptr(),
           DTYPE_CODES[xdt.dtype], b, s, h, g, n, int(chunk),
           *_strides(xdt), *dA.stride(), *_strides(B), *_strides(C),
           detail=lambda: f"xdt {tuple(xdt.shape)}, B {tuple(B.shape)}, chunk {chunk}")
    return y, state
