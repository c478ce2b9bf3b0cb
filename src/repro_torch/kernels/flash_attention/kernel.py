"""Launcher of the flash-attention forward CUDA kernel
(``csrc/flash_attention.cu``).

The port of ``repro.kernels.flash_attention.kernel.flash_attention_fwd``:
online-softmax attention with GQA, causal and sliding-window masks and an
optional tanh softcap, m/l/acc in fp32, output in q's dtype.  bf16 runs on
the tensor cores (``wgmma``) with q, k and v read by TMA, fp32 on the CUDA
cores.  The CUDA source is built at first call; see the note at its top for
the design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import launch

#: the head dims compiled into the library; any other raises
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 2
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])

_FN = None


def check_rows_see_a_key(s: int, t: int, window: int) -> None:
    """Raise unless every query row has a visible key.

    ``attention_ref`` gives a row without one the mean of v (a softmax over
    equal -1e30 scores); the kernel skips masked keys outright.  Such rows
    arise only with t = 0, or with a window and s > t + window - 1, and no
    model builds them, so they are refused on every device.  Causal or
    not, row q sees a key iff q - window + 1 <= t - 1, so the last row
    decides.
    """
    if s and (t == 0 or (window > 0 and s - window > t - 1)):
        raise ValueError(f"flash_attention: query rows from "
                         f"{t + window - 1 if t else 0} on see no key "
                         f"(s={s}, t={t}, window={window})")


def check_tma_layout(name: str, shape, strides, itemsize: int,
                     data_ptr: int) -> None:
    """Raise unless TMA can read a (b, heads, s, d) tensor of this layout.

    The bf16 kernel reads q, k and v through tensor maps, which need a base
    address on a 16-byte boundary and, for every dim the kernel steps (all
    but d, which must have unit stride), a byte stride that is a positive
    multiple of 16.  A dim of extent 1 is never stepped, so its stride does
    not matter.  The model's (b, s, heads, d) views at d = 32, 64 and 128
    all qualify.
    """
    if data_ptr % 16:
        raise ValueError(f"flash_attention (bf16): {name}'s base address is not "
                         f"16-byte aligned, as TMA needs")
    for dim, (n, st) in enumerate(zip(shape[:3], strides[:3])):
        if n > 1 and (st <= 0 or (st * itemsize) % 16):
            raise ValueError(f"flash_attention (bf16): {name}'s stride {st} on dim "
                             f"{dim} is not a positive multiple of 16 bytes, as TMA "
                             f"needs")


def _lib():
    """The C entry point, built, loaded and bound at the first call only."""
    global _FN
    if _FN is None:
        fn = build.load("flash_attention").repro_flash_attention
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q: (b, h, s, d); k/v: (b, kv, t, d) -> (b, h, s, d) in q's dtype, on
    the card.

    Takes fp32 or bf16 CUDA tensors of one dtype and d in ``HEAD_DIMS``,
    with any non-negative strides whose last one is 1 (bf16: as
    :func:`check_tma_layout` also requires): the model's
    (b, s, heads, d) activations are handed in as transposed views, and the
    output is laid out like q, so neither side copies.  Ragged s and t are
    masked in the kernel (no padding); every query row must see a key.
    Raises on anything else, and if the launch fails.
    """
    tensors = (q, k, v)
    if not all(x.is_cuda and x.device == q.device for x in tensors):
        raise ValueError(f"flash_attention needs q, k, v on one CUDA device; "
                         f"got {q.device}, {k.device}, {v.device}")
    if not all(x.dtype == q.dtype for x in tensors) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention takes float32 or bfloat16 of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if (q.dim() != 4 or k.dim() != 4 or k.shape != v.shape
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]
            or k.shape[1] == 0 or q.shape[1] % k.shape[1]):
        raise ValueError(f"flash_attention needs q (b,h,s,d) and k/v (b,kv,t,d) "
                         f"with kv dividing h; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    kvh, t = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention is compiled for head_dim in "
                         f"{HEAD_DIMS}; got {d}")
    if any(x.stride(-1) != 1 or min(x.stride()) < 0 for x in tensors):
        raise ValueError("flash_attention takes non-negative strides with a "
                         "unit stride on the head dim")
    check_rows_see_a_key(s, t, window)
    out = torch.empty_like(q)   # q's layout (strides) when q is dense
    if out.numel() == 0:
        return out
    if q.dtype == torch.bfloat16:
        for name, x in (("q", q), ("k", k), ("v", v)):
            check_tma_layout(name, x.shape, x.stride(), x.element_size(), x.data_ptr())
    rc = launch(_lib(), q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), _DTYPE_CODES[q.dtype], b, h, kvh, s, t, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3], int(causal), int(window),
                1.0 / d ** 0.5, float(softcap))
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed with CUDA error {rc} "
                           f"at q {tuple(q.shape)}, k {tuple(k.shape)}")
    flash_attention_fwd.launches += 1
    return out


#: kernel launches since the last reset (the main path's proof of use)
flash_attention_fwd.launches = 0
