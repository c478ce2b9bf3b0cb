"""Launchers of the flash-attention CUDA kernels: the forward
(``csrc/flash_attention.cu``) and the 16-bit backward
(``csrc/flash_attention_bwd.cu``).

The forward is the port of
``repro.kernels.flash_attention.kernel.flash_attention_fwd``: online-softmax
attention with GQA, causal and sliding-window masks and an optional tanh
softcap, m/l/acc in fp32, output in q's dtype.  bf16 and fp16 run on the
tensor cores (``wgmma``) with q, k and v read by TMA, fp32 on the CUDA cores;
a 16-bit call can also write each query row's log-sum-exp.  The backward has
no counterpart in the reference (which differentiates ``attention_ref``): it
recomputes each tile's probabilities from that log-sum-exp.  The CUDA sources
are built at first call; see the notes at their tops for the designs.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.dispatch import DTYPE_CODES, Entry, counted, launch

#: the head dims compiled into the library; any other raises.  16 (every
#: smoke config), 112 (zamba2-7b) and 224 (zamba2-7b-instruct) run the
#: 16-bit kernel on boxes padded with zeros past d, and 224 and 256
#: (gemma3-12b) on 64-key tiles (see the note at the top of the CUDA source)
HEAD_DIMS = (16, 32, 64, 112, 128, 224, 256)
#: the dtypes the tensor-core kernel takes, through TMA
_WGMMA = (torch.bfloat16, torch.float16)
#: the head dims the backward kernel is compiled for (d 224 and 256 keep the
#: plain version: their dK and dV would take 224 or 256 fp32 registers a
#: thread)
BWD_HEAD_DIMS = (16, 32, 64, 112, 128)
_FWD = Entry("flash_attention", "repro_flash_attention",
             [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 2
             + [ctypes.c_float] * 2 + [ctypes.c_void_p] + [ctypes.c_longlong] * 2
             + [ctypes.c_void_p])
_BWD = Entry("flash_attention_bwd", "repro_flash_attention_bwd",
             [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 26
             + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
#: the backward's scratch rows (D and the log2-domain LSE) are padded to this
_BWD_PAD = 64


def check_rows_see_a_key(s: int, t: int, window: int) -> None:
    """Raise unless every query row has a visible key.

    ``attention_ref`` gives a row without one the mean of v (a softmax over
    equal -1e30 scores); the kernel skips masked keys outright, so it
    refuses such rows, and the op (``ops.py``) runs it on the rows before
    them and writes them itself.  They arise only with t = 0, or with a
    window and s > t + window - 1.  Causal or not, row q sees a key iff
    q - window + 1 <= t - 1, so the last row decides.
    """
    if s and (t == 0 or (window > 0 and s - window > t - 1)):
        raise ValueError(f"flash_attention: query rows from "
                         f"{t + window - 1 if t else 0} on see no key "
                         f"(s={s}, t={t}, window={window})")


def tma_layout_problem(name: str, shape, strides, itemsize: int,
                       data_ptr: int) -> Optional[str]:
    """Why TMA cannot read a (b, heads, s, d) tensor of this layout, or None.

    The bf16 and fp16 kernels read q, k, v (and the backward dout) through
    tensor maps, which need a base address on a 16-byte boundary and, for
    every dim the kernel steps (all but d, which must have unit stride), a
    byte stride that is a positive multiple of 16.  A dim of extent 1 is
    never stepped, so its stride does not matter.  The model's
    (b, s, heads, d) views at every compiled d qualify (a row of d values is
    a multiple of 32 bytes).
    """
    if data_ptr % 16:
        return (f"flash_attention (16-bit): {name}'s base address is not 16-byte "
                f"aligned, as TMA needs")
    for dim, (n, st) in enumerate(zip(shape[:3], strides[:3])):
        if n > 1 and (st <= 0 or (st * itemsize) % 16):
            return (f"flash_attention (16-bit): {name}'s stride {st} on dim {dim} is "
                    f"not a positive multiple of 16 bytes, as TMA needs")
    return None


def check_tma_layout(name: str, shape, strides, itemsize: int,
                     data_ptr: int) -> None:
    """Raise unless TMA can read a (b, heads, s, d) tensor of this layout
    (:func:`tma_layout_problem`)."""
    problem = tma_layout_problem(name, shape, strides, itemsize, data_ptr)
    if problem:
        raise ValueError(problem)


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str) -> None:
    """Raise unless q (b, h, s, d) and k/v (b, kv, t, d) are CUDA tensors of
    one device and one dtype the kernels take, with kv dividing h, d in
    ``HEAD_DIMS`` and non-negative strides whose last one is 1."""
    tensors = (q, k, v)
    if not all(x.is_cuda and x.device == q.device for x in tensors):
        raise ValueError(f"{name} needs q, k, v on one CUDA device; "
                         f"got {q.device}, {k.device}, {v.device}")
    if not all(x.dtype == q.dtype for x in tensors) or q.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} takes float32, bfloat16 or float16 of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if (q.dim() != 4 or k.dim() != 4 or k.shape != v.shape
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]
            or k.shape[1] == 0 or q.shape[1] % k.shape[1]):
        raise ValueError(f"{name} needs q (b,h,s,d) and k/v (b,kv,t,d) "
                         f"with kv dividing h; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"{name} is compiled for head_dim in "
                         f"{HEAD_DIMS}; got {q.shape[3]}")
    if any(x.stride(-1) != 1 or min(x.stride()) < 0 for x in tensors):
        raise ValueError(f"{name} takes non-negative strides with a "
                         "unit stride on the head dim")


def _scale(d: int, scale: Optional[float]) -> float:
    """The scores' scale: ``scale``, or 1/sqrt(d) where it is None."""
    return 1.0 / d ** 0.5 if scale is None else float(scale)


@counted
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0,
                        lse: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: (b, h, s, d); k/v: (b, kv, t, d) -> (b, h, s, d) in q's dtype, on
    the card.

    Takes fp32, bf16 or fp16 CUDA tensors of one dtype and d in
    ``HEAD_DIMS``, with any non-negative strides whose last one is 1 (bf16
    and fp16: as
    :func:`check_tma_layout` also requires): the model's
    (b, s, heads, d) activations are handed in as transposed views, and the
    output is laid out like q, so neither side copies.  Ragged s and t are
    masked in the kernel (no padding); every query row must see a key.
    ``scale`` multiplies the scores (None: 1/sqrt(d)).
    ``lse``, for bf16 and fp16 at d in ``BWD_HEAD_DIMS`` only: an fp32
    (b, h, s) tensor with a unit stride on s, into which the kernel writes
    each row's log-sum-exp of its scaled (and capped) scores, natural log,
    for the backward (instances of their own: without it, the kernel does
    not pay for the store).
    Raises on anything else, and if the launch fails.
    """
    _check_qkv(q, k, v, "flash_attention")
    b, h, s, d = q.shape
    kvh, t = k.shape[1], k.shape[2]
    check_rows_see_a_key(s, t, window)
    lse_args = (None, 0, 0)
    if lse is not None:
        if q.dtype not in _WGMMA or d not in BWD_HEAD_DIMS:
            raise TypeError("flash_attention writes a log-sum-exp for bfloat16 and "
                            f"float16 at d in {BWD_HEAD_DIMS} only; got {q.dtype} at d {d}")
        if (lse.device != q.device or lse.dtype != torch.float32
                or tuple(lse.shape) != (b, h, s) or (s > 1 and lse.stride(2) != 1)):
            raise ValueError(f"flash_attention's lse must be float32 ({b}, {h}, {s}) "
                             f"on {q.device} with a unit stride on s; got {lse.dtype} "
                             f"{tuple(lse.shape)} on {lse.device}")
        lse_args = (lse.data_ptr(), lse.stride(0), lse.stride(1))
    out = torch.empty_like(q)   # q's layout (strides) when q is dense
    if out.numel() == 0:
        return out
    if q.dtype in _WGMMA:
        for name, x in (("q", q), ("k", k), ("v", v)):
            check_tma_layout(name, x.shape, x.stride(), x.element_size(), x.data_ptr())
    launch(_FWD, flash_attention_fwd, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), DTYPE_CODES[q.dtype], b, h, kvh, s, t, d,
           *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
           *out.stride()[:3], int(causal), int(window),
           _scale(d, scale), float(softcap), *lse_args,
           detail=lambda: f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    return out


@counted
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool = True, window: int = 0, softcap: float = 0.0,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of :func:`flash_attention_fwd`'s output
    ``out`` with respect to q, k and v, given the output's gradient ``dout``
    and the forward's log-sum-exp ``lse``, on the card.

    Takes bf16 or fp16 CUDA tensors of one dtype with d in
    ``BWD_HEAD_DIMS``: q, k, v, dout as :func:`check_tma_layout` requires,
    ``out`` (b, h, s, d) with any strides whose last one is 1, ``lse`` fp32
    (b, h, s) with a unit stride on s.  Every query row must see a key.  The
    gradients come out in q's dtype, each laid out like its input where that
    is dense.  Three launches, counted as one (see the note at the top of the
    CUDA source); two calls on the same inputs give the same bits.  Raises
    on anything else, and if a launch fails.
    """
    _check_qkv(q, k, v, "flash_attention_bwd")
    b, h, s, d = q.shape
    kvh, t = k.shape[1], k.shape[2]
    if q.dtype not in _WGMMA:
        raise TypeError(f"flash_attention_bwd takes bfloat16 or float16; got {q.dtype}")
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd is compiled for head_dim in "
                         f"{BWD_HEAD_DIMS}; got {d}")
    for name, x in (("out", out), ("dout", dout)):
        if (x.device != q.device or x.dtype != q.dtype or x.shape != q.shape
                or x.stride(-1) != 1 or min(x.stride()) < 0):
            raise ValueError(f"flash_attention_bwd's {name} must be laid out as q "
                             f"{tuple(q.shape)} {q.dtype} with a unit stride on d; got "
                             f"{tuple(x.shape)} {x.dtype} strides {x.stride()}")
    if (lse.device != q.device or lse.dtype != torch.float32
            or tuple(lse.shape) != (b, h, s) or (s > 1 and lse.stride(2) != 1)):
        raise ValueError(f"flash_attention_bwd's lse must be float32 ({b}, {h}, {s}) "
                         f"with a unit stride on s; got {lse.dtype} {tuple(lse.shape)}")
    check_rows_see_a_key(s, t, window)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    for name, x in (("q", q), ("k", k), ("v", v), ("dout", dout)):
        check_tma_layout(name, x.shape, x.stride(), x.element_size(), x.data_ptr())
    sp = -(-s // _BWD_PAD) * _BWD_PAD
    lse2, dsum = torch.empty(2, b * h * sp, dtype=torch.float32, device=q.device)
    launch(_BWD, flash_attention_bwd, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), dout.data_ptr(), lse.data_ptr(), lse2.data_ptr(),
           dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
           DTYPE_CODES[q.dtype], b, h, kvh, s, t, d, sp,
           *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
           *dout.stride()[:3], *lse.stride()[:2], *dq.stride()[:3],
           *dk.stride()[:3], *dv.stride()[:3], int(causal), int(window),
           _scale(d, scale), float(softcap),
           detail=lambda: f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    return dq, dk, dv
