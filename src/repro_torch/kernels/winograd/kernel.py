"""Launchers of the Winograd F(2x2,3x3) CUDA kernel (``csrc/winograd.cu``).

One device body, two entry points:

* :func:`winograd_conv` — the fused convolution: x (b,H,W,cin) NHWC and
  U = G w G^T to y (b,oh,ow,cout) NHWC in one launch, with the SAME halo and
  the ragged last tile zero-filled in the kernel.  ``conv3x3_winograd``
  runs it.
* :func:`winograd_tiles` — the port of ``repro.kernels.winograd.kernel
  .winograd_tiles``, exactly the TPU kernel's function: pre-extracted 4x4
  tiles to 2x2 output tiles.

Both take fp32, bf16 or fp16, compute in fp32 (3xTF32, split-bf16 or
split-fp16 products on the tensor cores) and return the input dtype.  :func:`winograd_plan` is the
conv launch's geometry in plain Python, so that the CPU tests can check its
indexing.  The CUDA source is built at first call; see the note at its top
for the design.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels.dispatch import DTYPE_CODES, Entry, counted, launch

PADDINGS = ("SAME", "VALID")
#: output tiles a block, and the patch shapes (tile rows, tile columns) a
#: block may take them in
TILES_PER_BLOCK = 32
PATCHES = ((2, 16), (4, 8), (8, 4), (16, 2))
#: output channels a block
COUT_PER_BLOCK = 32
#: depth of the kernel's cp.async ring over cin
STAGES = 2
# shared memory, as csrc/winograd.cu lays it out: per stage the staged
# pixels (48 bytes each: 32 of channels, 16 of pad) and a U slab
# (16 positions x one chunk of cin x 40 padded couts, 20,480 bytes in
# either dtype); then V (16 positions x 32 tiles x 48 bytes, twice for
# the 16-bit dtypes' hi and lo halves)
_RAW_ROW = 48
_U_BYTES = 16 * 8 * 40 * 4
_V_BYTES = 16 * 32 * 48
_HALO_MAX = max((2 * th + 2) * (2 * tw + 2) for th, tw in PATCHES)


def smem_bytes(dtype: torch.dtype, image: bool = True) -> int:
    """Shared memory one block of the kernel takes."""
    pixels = _HALO_MAX if image else 16 * TILES_PER_BLOCK
    v = _V_BYTES * (1 if dtype == torch.float32 else 2)
    return STAGES * (pixels * _RAW_ROW + _U_BYTES) + v


@dataclass(frozen=True)
class WinogradPlan:
    """How :func:`winograd_conv` cuts one convolution into blocks.

    A block takes a patch of ``patch`` = (rows, columns) output tiles of one
    image and ``COUT_PER_BLOCK`` output channels.  It stages the ``halo``
    box of input pixels whose top-left pixel is at
    (2 * tile_row0 - pad, 2 * tile_col0 - pad); pixels outside the image
    read as zeros.  Block ``i`` of the grid takes patch ``i // cout_blocks``
    (patches in (image, patch row, patch column) order) and cout block
    ``i % cout_blocks``.
    """
    oh: int
    ow: int
    tiles: Tuple[int, int]        # (th, tw) output tiles of one image
    pad: int
    patch: Tuple[int, int]
    patches: Tuple[int, int, int]  # (images, patch rows, patch columns)
    cout_blocks: int
    halo: Tuple[int, int]
    stages: int
    smem_bytes: int

    @property
    def grid(self) -> int:
        b, pr, pc = self.patches
        return b * pr * pc * self.cout_blocks

    @property
    def tiles_per_block(self) -> int:
        return self.patch[0] * self.patch[1]

    def block(self, i: int) -> Tuple[int, int, int, int, int, int]:
        """Block ``i``'s (image, first tile row, first tile column, first
        cout, halo row origin, halo column origin)."""
        patch, cb = divmod(i, self.cout_blocks)
        _, pr, pc = self.patches
        b, rest = divmod(patch, pr * pc)
        ti0, tj0 = (rest // pc) * self.patch[0], (rest % pc) * self.patch[1]
        return (b, ti0, tj0, cb * COUT_PER_BLOCK,
                2 * ti0 - self.pad, 2 * tj0 - self.pad)


def winograd_plan(b: int, H: int, W: int, cin: int, cout: int,
                  padding: str = "SAME",
                  dtype: torch.dtype = torch.float32) -> WinogradPlan:
    """The geometry of one :func:`winograd_conv` launch.

    The patch shape is the one of ``PATCHES`` that covers the image's tiles
    with the fewest wasted (out-of-image) tiles; then the smaller halo box;
    then the wider patch (longer contiguous NHWC rows).
    """
    if padding not in PADDINGS:
        raise ValueError(f"padding must be one of {PADDINGS}; got {padding!r}")
    pad = 1 if padding == "SAME" else 0
    oh, ow = H + 2 * pad - 2, W + 2 * pad - 2
    if oh < 1 or ow < 1:
        raise ValueError(f"a 3x3 {padding} conv of a {H}x{W} image has no output")
    th, tw = (oh + 1) // 2, (ow + 1) // 2

    def cost(patch):
        r, c = patch
        covered = -(-th // r) * r * -(-tw // c) * c
        return covered, (2 * r + 2) * (2 * c + 2), -c

    r, c = min(PATCHES, key=cost)
    return WinogradPlan(
        oh=oh, ow=ow, tiles=(th, tw), pad=pad, patch=(r, c),
        patches=(b, -(-th // r), -(-tw // c)),
        cout_blocks=-(-cout // COUT_PER_BLOCK),
        halo=(2 * r + 2, 2 * c + 2), stages=STAGES,
        smem_bytes=smem_bytes(dtype, image=True))


_CONV = Entry("winograd", "repro_winograd_conv",
              [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
              + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_TILES = Entry("winograd", "repro_winograd_tiles",
               [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
               + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_SMEM_BYTES = Entry("winograd", "repro_winograd_smem_bytes", [ctypes.c_int, ctypes.c_int])


def kernel_smem_bytes(dtype: torch.dtype, image: bool = True) -> int:
    """The compiled kernel's own count of :func:`smem_bytes` (builds it)."""
    return _SMEM_BYTES(DTYPE_CODES[dtype], int(image))


def _check_inputs(name: str, a: torch.Tensor, u: torch.Tensor) -> None:
    if not (a.is_cuda and u.is_cuda) or a.device != u.device:
        raise ValueError(f"{name} needs both inputs on one CUDA device; got "
                         f"{a.device} and {u.device}")
    if a.dtype != u.dtype or a.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} takes float32, bfloat16 or float16 of one dtype; got "
                        f"{a.dtype} and {u.dtype}")
    if u.dim() != 4 or tuple(u.shape[:2]) != (4, 4) or u.shape[2] != a.shape[-1]:
        raise ValueError(f"{name} needs u (4,4,cin,cout) with the input's cin; got "
                         f"{tuple(a.shape)} and {tuple(u.shape)}")
    if not u.is_contiguous():
        raise ValueError(f"{name} takes a contiguous u")


@counted
def winograd_conv(x: torch.Tensor, u: torch.Tensor,
                  padding: str = "SAME") -> torch.Tensor:
    """x (b, H, W, cin) NHWC, u = G w G^T (4, 4, cin, cout)
    -> (b, oh, ow, cout) NHWC in x's dtype, in one launch on the card.

    Takes fp32, bf16 or fp16 CUDA tensors of one dtype; x may have any
    non-negative strides whose channel stride is 1, u is contiguous.
    Raises ``TypeError`` on another dtype, ``ValueError`` on shapes,
    devices, strides or paddings it does not take, and ``RuntimeError`` if
    the launch fails.
    """
    if x.dim() != 4:
        raise ValueError(f"winograd_conv needs x (b,H,W,cin); got {tuple(x.shape)}")
    _check_inputs("winograd_conv", x, u)
    if min(x.stride()) < 0 or (x.shape[3] > 1 and x.stride(3) != 1):
        raise ValueError(f"winograd_conv takes non-negative strides with a unit "
                         f"channel stride; got {x.stride()}")
    b, H, W, cin = x.shape
    cout = u.shape[3]
    plan = winograd_plan(b, H, W, cin, cout, padding, x.dtype)
    y = torch.empty((b, plan.oh, plan.ow, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    sb, sh, sw, _ = x.stride()
    launch(_CONV, winograd_conv, x.device, DTYPE_CODES[x.dtype], x.data_ptr(),
           u.data_ptr(), y.data_ptr(), b, H, W, cin, cout, sb, sh, sw, plan.pad,
           plan.patch[1],
           detail=lambda: f"x {tuple(x.shape)}, u {tuple(u.shape)}, {padding}")
    return y


@counted
def winograd_tiles(tiles: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """tiles (b, th, tw, 4, 4, cin), u (4, 4, cin, cout)
    -> (b, th, tw, 2, 2, cout) in the tiles' dtype, on the card.

    Takes contiguous fp32, bf16 or fp16 CUDA tensors of one dtype.  Raises
    ``TypeError`` on another dtype, ``ValueError`` on shapes, devices or
    strides it does not take, and ``RuntimeError`` if the launch fails.
    """
    if tiles.dim() != 6 or tuple(tiles.shape[3:5]) != (4, 4):
        raise ValueError(f"winograd_tiles needs tiles (b,th,tw,4,4,cin); got "
                         f"{tuple(tiles.shape)}")
    _check_inputs("winograd_tiles", tiles, u)
    if not tiles.is_contiguous():
        raise ValueError("winograd_tiles takes contiguous tiles")
    b, th, tw, _, _, cin = tiles.shape
    cout = u.shape[3]
    out = torch.empty((b, th, tw, 2, 2, cout), dtype=tiles.dtype, device=tiles.device)
    if out.numel() == 0:
        return out
    launch(_TILES, winograd_tiles, tiles.device, DTYPE_CODES[tiles.dtype],
           tiles.data_ptr(), u.data_ptr(), out.data_ptr(), b * th * tw, cin, cout,
           detail=lambda: f"tiles {tuple(tiles.shape)}, u {tuple(u.shape)}")
    return out
