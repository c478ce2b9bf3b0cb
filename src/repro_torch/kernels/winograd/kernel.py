"""Launcher of the Winograd F(2x2,3x3) CUDA kernel (``csrc/winograd.cu``).

The port of ``repro.kernels.winograd.kernel.winograd_tiles``: the
transform-domain work on pre-extracted 4x4 tiles, computed in fp32.  The
CUDA source is built at first call; see the note at its top for the design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p])


_FN = None


def _lib():
    """The C entry point, built, loaded and bound at the first call only."""
    global _FN
    if _FN is None:
        fn = build.load("winograd").repro_winograd_tiles
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def winograd_tiles(tiles: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """tiles (b, th, tw, 4, 4, cin), u (4, 4, cin, cout)
    -> (b, th, tw, 2, 2, cout), on the card.

    Takes contiguous float32 CUDA tensors on one device; raises on anything
    else, and if the launch fails.
    """
    if not (tiles.is_cuda and u.is_cuda) or tiles.device != u.device:
        raise ValueError(f"winograd_tiles needs both inputs on one CUDA "
                         f"device; got {tiles.device} and {u.device}")
    if tiles.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"winograd_tiles takes float32; got {tiles.dtype} "
                        f"and {u.dtype}")
    if (tiles.dim() != 6 or tuple(tiles.shape[3:5]) != (4, 4) or u.dim() != 4
            or tuple(u.shape[:2]) != (4, 4) or u.shape[2] != tiles.shape[5]):
        raise ValueError(f"winograd_tiles needs tiles (b,th,tw,4,4,cin) and "
                         f"u (4,4,cin,cout); got {tuple(tiles.shape)} and "
                         f"{tuple(u.shape)}")
    if not (tiles.is_contiguous() and u.is_contiguous()):
        raise ValueError("winograd_tiles takes contiguous tensors")
    b, th, tw, _, _, cin = tiles.shape
    cout = u.shape[3]
    out = torch.empty((b, th, tw, 2, 2, cout), dtype=tiles.dtype,
                      device=tiles.device)
    n_tiles = b * th * tw
    if n_tiles == 0 or cout == 0:
        return out
    fn = _lib()
    with torch.cuda.device(tiles.device):
        stream = torch.cuda.current_stream(tiles.device).cuda_stream
        rc = fn(tiles.data_ptr(), u.data_ptr(), out.data_ptr(), n_tiles, cin,
                cout, stream)
    if rc != 0:
        raise RuntimeError(f"winograd_tiles launch failed with CUDA error {rc} "
                           f"at tiles {tuple(tiles.shape)}, u {tuple(u.shape)}")
    winograd_tiles.launches += 1
    return out


#: kernel launches since the last reset (the main path's proof of use)
winograd_tiles.launches = 0
