"""Launcher of the block-tiled matmul CUDA kernel (``csrc/tiled_matmul.cu``).

The port of ``repro.kernels.tiled_matmul.kernel.tiled_matmul``: a (M,K) @
(K,N) block GEMM with an fp32 accumulator, output in the input dtype, and
``block_m/n/k`` as arguments (the section V block-shape knob).  The CUDA
source is built at first call; see the note at its top for the design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: the block shapes compiled into the library; any other raises
BLOCK_CONFIGS = ((64, 64, 64), (128, 128, 64), (128, 64, 128), (128, 128, 128))
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def check_block(block_m: int, block_n: int, block_k: int) -> None:
    if (block_m, block_n, block_k) not in BLOCK_CONFIGS:
        raise ValueError(f"block shape {(block_m, block_n, block_k)} is not "
                         f"compiled; choose one of {BLOCK_CONFIGS}")


_FN = None


def _lib():
    """The C entry point, built, loaded and bound at the first call only."""
    global _FN
    if _FN is None:
        fn = build.load("tiled_matmul").repro_tiled_matmul
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def tiled_matmul(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 64,
                 block_n: int = 64, block_k: int = 64) -> torch.Tensor:
    """a: (M, K), b: (K, N) -> (M, N) in a's dtype, on the card.

    Takes fp32 or bf16 CUDA tensors of one dtype, with any non-negative
    strides (transposed views need no copy).  Ragged edges are masked in the
    kernel.  Raises on anything else, and if the launch fails.
    """
    check_block(block_m, block_n, block_k)
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError(f"tiled_matmul needs both inputs on one CUDA device; "
                         f"got {a.device} and {b.device}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODES:
        raise TypeError(f"tiled_matmul takes float32 or bfloat16 of one dtype; "
                        f"got {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tiled_matmul needs (M,K) @ (K,N); got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if min(a.stride() + b.stride()) < 0:
        raise ValueError("tiled_matmul takes only non-negative strides")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    fn = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                _DTYPE_CODES[a.dtype], m, n, k, a.stride(0), a.stride(1),
                b.stride(0), b.stride(1), block_m, block_n, block_k, stream)
    if rc != 0:
        raise RuntimeError(f"tiled_matmul launch failed with CUDA error {rc} "
                           f"at {(m, k, n)} blocks {(block_m, block_n, block_k)}")
    tiled_matmul.launches += 1
    return out


#: kernel launches since the last reset (the main path's proof of use)
tiled_matmul.launches = 0
