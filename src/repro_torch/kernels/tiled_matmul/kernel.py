"""Launcher of the block-tiled matmul CUDA kernel (``csrc/tiled_matmul.cu``).

The port of ``repro.kernels.tiled_matmul.kernel.tiled_matmul``: a (M,K) @
(K,N) block GEMM with an fp32 accumulator, output in the input dtype, and
``block_m/n/k`` as arguments (the section V block-shape knob).  A product
with too few output tiles to fill the card is cut into K-splits
(:func:`split_k_plan`), summed in a fixed order by a second kernel.  The
CUDA source is built at first call; see the note at its top for the design.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels.dispatch import DTYPE_CODES, Entry, counted, launch

#: the block shapes compiled into the library; any other raises
BLOCK_CONFIGS = ((64, 64, 64), (128, 128, 64), (128, 64, 128), (128, 128, 128))
#: the fewest block_k slabs a K-split walks
MIN_SLABS_PER_SPLIT = 4
#: K-splits aim at this many blocks on each SM
BLOCKS_PER_SM = 2
_ENTRY = Entry("tiled_matmul", "repro_tiled_matmul",
               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
               + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def check_block(block_m: int, block_n: int, block_k: int) -> None:
    if (block_m, block_n, block_k) not in BLOCK_CONFIGS:
        raise ValueError(f"block shape {(block_m, block_n, block_k)} is not "
                         f"compiled; choose one of {BLOCK_CONFIGS}")


def split_k_plan(m: int, n: int, k: int, block_m: int, block_n: int,
                 block_k: int, sms: int) -> int:
    """The number of K-splits of an (m,k) @ (k,n) product on a card of
    ``sms`` SMs.

    One split when the output tiles already fill the card.  Otherwise
    enough splits for about ``BLOCKS_PER_SM`` blocks an SM, each at least
    ``MIN_SLABS_PER_SPLIT`` block_k slabs long.  Every split walks the same
    whole number of slabs, so only the last one sees a ragged K, and none
    is empty.
    """
    tiles = -(-m // block_m) * -(-n // block_n)
    slabs = -(-k // block_k)
    if tiles == 0 or tiles >= sms or slabs < 2 * MIN_SLABS_PER_SPLIT:
        return 1
    want = -(-BLOCKS_PER_SM * sms // tiles)
    splits = max(1, min(want, slabs // MIN_SLABS_PER_SPLIT))
    per = -(-slabs // splits)
    return -(-slabs // per)


_SMS: Dict[int, int] = {}


def _sm_count(index: int) -> int:
    sms = _SMS.get(index)
    if sms is None:
        sms = _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return sms


@counted
def tiled_matmul(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 64,
                 block_n: int = 64, block_k: int = 64) -> torch.Tensor:
    """a: (M, K), b: (K, N) -> (M, N) in a's dtype, on the card.

    Takes fp32, bf16 or fp16 CUDA tensors of one dtype, with any non-negative
    strides (transposed views need no copy).  Ragged edges are masked in the
    kernel.  Raises on anything else, and if the launch fails.  Counts one
    launch per product, whatever the number of K-splits.
    """
    check_block(block_m, block_n, block_k)
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError(f"tiled_matmul needs both inputs on one CUDA device; "
                         f"got {a.device} and {b.device}")
    if a.dtype != b.dtype or a.dtype not in DTYPE_CODES:
        raise TypeError(f"tiled_matmul takes float32, bfloat16 or float16 of one dtype; "
                        f"got {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tiled_matmul needs (M,K) @ (K,N); got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    sam, sak = a.stride()
    sbk, sbn = b.stride()
    if min(sam, sak, sbk, sbn) < 0:
        raise ValueError("tiled_matmul takes only non-negative strides")
    m, k = a.shape
    n = b.shape[1]
    dev = a.device
    out = torch.empty((m, n), dtype=a.dtype, device=dev)
    if m == 0 or n == 0:
        return out
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    splits = split_k_plan(m, n, k, block_m, block_n, block_k, _sm_count(index))
    # the splits' fp32 partials; freed on return, the caching allocator
    # reuses the block only for work queued behind this call on the stream
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
          if splits > 1 else None)
    launch(_ENTRY, tiled_matmul, dev, a.data_ptr(), b.data_ptr(), out.data_ptr(),
           None if ws is None else ws.data_ptr(), DTYPE_CODES[a.dtype], m, n, k,
           sam, sak, sbk, sbn, block_m, block_n, block_k, splits,
           detail=lambda: f"{(m, k, n)} blocks {(block_m, block_n, block_k)}, "
                          f"{splits} K-splits")
    return out
