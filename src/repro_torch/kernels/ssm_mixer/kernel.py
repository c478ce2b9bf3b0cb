"""Launchers of the two Mamba2 mixer CUDA kernels (``csrc/ssm_mixer.cu``):
the pointwise work of a prefill's mixer on each side of its scan, one launch
each, bf16 or fp16 in and out, fp32 inside.

They replace no TPU kernel (the reference writes the mixer in jnp); their
plain versions are :mod:`repro_torch.kernels.ssm_mixer.ref`.  The CUDA
source is built at the first call; see the note at its top for the design.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.dispatch import Entry, counted, launch
from repro_torch.kernels.ssd_scan.kernel import padded

#: the head dim and conv width compiled into the library
HEAD_DIM = 64
CONV_WIDTH = 4
#: the widest d_inner the norm keeps in registers (four 8-channel vectors a
#: thread of 256), and the most groups it sums apart
MAX_D_INNER = 8192
MAX_GROUPS = 8
DTYPE_CODES = {torch.bfloat16: 1, torch.float16: 2}
_CONV_IN = Entry("ssm_mixer", "repro_ssm_conv_in",
                 [ctypes.c_void_p] + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
_GATED_NORM = Entry("ssm_mixer", "repro_ssm_gated_norm",
                    [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 3
                    + [ctypes.c_int] * 5
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def rows_aligned(t: torch.Tensor) -> bool:
    """Whether a (b, s, k) tensor's rows take 16-byte loads: its base and
    every stepped stride fall on 16 bytes."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(t.shape[d] == 1 or t.stride(d) * size % 16 == 0
                                          for d in (0, 1))


def _check(name: str, *tensors: torch.Tensor) -> None:
    """One CUDA device and one of bfloat16 and float16 for every input."""
    if not all(t.is_cuda and t.device == tensors[0].device for t in tensors):
        raise ValueError(f"{name} needs every input on one CUDA device; got "
                         f"{[str(t.device) for t in tensors]}")
    if tensors[0].dtype not in DTYPE_CODES or any(t.dtype != tensors[0].dtype for t in tensors):
        raise TypeError(f"{name} takes every input in one of bfloat16 and float16; got "
                        f"{[t.dtype for t in tensors]}")


@counted
def ssm_conv_in(zxbcdt: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                dt_bias: torch.Tensor, a_log: torch.Tensor, d_inner: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The mixer's work before its scan, on the card: from the in_proj
    output zxbcdt (b, s, d_inner + c + h; z, the conv's input x, B and C,
    then dt; channels at unit stride), read in place: xbc (b, c,
    padded(s)), xdt = xh dt on x's channels and B and C on the rest, the
    positions at unit stride and zero padded; dA = dt A (b, h, s) fp32; xh
    (b, s, d_inner); the last ``min(s, 3)`` raw conv inputs (b, rows, c).
    All new and contiguous.

    conv_w (4, c), conv_b (c), dt_bias and a_log (h) in zxbcdt's dtype;
    d_inner = 64 h; c a multiple of 8; s > 0.  One launch.
    Raises on anything else, and if the launch fails.
    """
    params = (conv_w, conv_b, dt_bias, a_log)
    _check("ssm_conv_in", zxbcdt, *params)
    b, s, width = zxbcdt.shape
    ch, heads = conv_w.shape[1], dt_bias.shape[0]
    if (d_inner != HEAD_DIM * heads or ch < d_inner or ch % 8 or s == 0
            or tuple(conv_w.shape) != (CONV_WIDTH, ch) or tuple(conv_b.shape) != (ch,)
            or tuple(a_log.shape) != (heads,) or width != d_inner + ch + heads
            or zxbcdt.stride(2) != 1):
        raise ValueError(f"ssm_conv_in takes zxbcdt (b, s, d_inner + c + h) with unit stride "
                         f"on channels, conv_w ({CONV_WIDTH}, c) with c a multiple of 8, "
                         f"conv_b (c), dt_bias and a_log (h), d_inner = {HEAD_DIM} h; got "
                         f"{tuple(zxbcdt.shape)} (strides {zxbcdt.stride()}), "
                         f"{tuple(conv_w.shape)}, {tuple(conv_b.shape)}, "
                         f"{tuple(dt_bias.shape)}, {tuple(a_log.shape)}, d_inner {d_inner}")
    conv_w, conv_b, dt_bias, a_log = (t.contiguous() for t in params)
    rows = min(s, CONV_WIDTH - 1)
    xbc = zxbcdt.new_empty((b, ch, padded(s)))
    dA = zxbcdt.new_empty((b, heads, s), dtype=torch.float32)
    xh = zxbcdt.new_empty((b, s, d_inner))
    tail = zxbcdt.new_empty((b, rows, ch))
    launch(_CONV_IN, ssm_conv_in, zxbcdt.device, zxbcdt.data_ptr(), zxbcdt.stride(0),
           zxbcdt.stride(1), d_inner, d_inner + ch, conv_w.data_ptr(), conv_b.data_ptr(),
           dt_bias.data_ptr(), a_log.data_ptr(), xbc.data_ptr(), dA.data_ptr(), xh.data_ptr(),
           tail.data_ptr(), DTYPE_CODES[zxbcdt.dtype], b, s, padded(s), ch, d_inner, rows,
           int(rows_aligned(zxbcdt)),
           detail=lambda: f"zxbcdt {tuple(zxbcdt.shape)}, c {ch}, d_inner {d_inner}")
    return xbc, dA, xh, tail


@counted
def ssm_gated_norm(y: torch.Tensor, xh: torch.Tensor, zxbcdt: torch.Tensor,
                   d_skip: torch.Tensor, norm: torch.Tensor, groups: int, eps: float
                   ) -> torch.Tensor:
    """The mixer's work after its scan, on the card: (y + D xh) silu(z),
    RMS-normed over each of ``groups`` groups of channels with fp32
    statistics and scaled by (1 + gamma), as (b, s, d_inner), new and
    contiguous.

    y (b, s, h, 64) and xh (b, s, 64 h) contiguous; z the first 64 h
    columns of zxbcdt (b, s, *), read in place (unit stride on channels);
    d_skip (h) and the norm's gamma (64 h); all in one of bf16 and fp16;
    64 h up to ``MAX_D_INNER``, in up to ``MAX_GROUPS`` groups of a
    multiple of 8 channels.  One launch.  Raises on anything else, and if
    the launch fails.
    """
    _check("ssm_gated_norm", y, xh, zxbcdt, d_skip, norm)
    b, s, heads, p = y.shape
    d_inner = heads * p
    if (p != HEAD_DIM or s == 0 or d_inner > MAX_D_INNER or not 0 < groups <= MAX_GROUPS
            or d_inner % (8 * groups) or tuple(xh.shape) != (b, s, d_inner)
            or tuple(zxbcdt.shape[:2]) != (b, s) or zxbcdt.shape[2] < d_inner
            or zxbcdt.stride(2) != 1 or tuple(d_skip.shape) != (heads,)
            or tuple(norm.shape) != (d_inner,)):
        raise ValueError(f"ssm_gated_norm takes y (b, s, h, {HEAD_DIM}), xh (b, s, d), z the "
                         f"first d columns of zxbcdt, d_skip (h), norm (d), d = {HEAD_DIM} h "
                         f"<= {MAX_D_INNER} in up to {MAX_GROUPS} groups of a multiple of 8; "
                         f"got {tuple(y.shape)}, {tuple(xh.shape)}, {tuple(zxbcdt.shape)}, "
                         f"{tuple(d_skip.shape)}, {tuple(norm.shape)}, {groups} groups")
    if not (y.is_contiguous() and xh.is_contiguous() and y.data_ptr() % 16 == 0
            and xh.data_ptr() % 16 == 0):
        raise ValueError("ssm_gated_norm takes y and xh contiguous and 16-byte aligned")
    d_skip, norm = d_skip.contiguous(), norm.contiguous()
    out = y.new_empty((b, s, d_inner))
    launch(_GATED_NORM, ssm_gated_norm, y.device, y.data_ptr(), xh.data_ptr(),
           zxbcdt.data_ptr(), zxbcdt.stride(0), zxbcdt.stride(1), d_skip.data_ptr(),
           norm.data_ptr(), out.data_ptr(), DTYPE_CODES[y.dtype], b, s, d_inner, int(groups),
           float(eps), int(rows_aligned(zxbcdt)),
           detail=lambda: f"y {tuple(y.shape)}, zxbcdt {tuple(zxbcdt.shape)}, "
                          f"{groups} groups")
    return out
