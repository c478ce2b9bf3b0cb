"""Public wrapper: tile extraction, the ``repro_torch::winograd_tiles`` op,
and reassembly.

As in the reference's ``ops.py``, tile extraction, the filter transform
U = G w G^T and the output reassembly stay in PyTorch on the tensors' device;
only the transform-domain work is the kernel.  On CUDA tensors the op
launches it; on CPU tensors it runs :func:`winograd_tiles_ref`.

The op's gradient is a plain PyTorch formula (the reference kernel has no
VJP either): the LeNet smoke model differentiates through its 3x3 Winograd
convs in the CPU tests.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.winograd.kernel import winograd_tiles
from repro_torch.kernels.winograd.ref import AT, BT, G, winograd_tiles_ref


@torch.library.custom_op("repro_torch::winograd_tiles", mutates_args=())
def winograd_tiles_op(tiles: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    if use_kernel(tiles, u):
        return winograd_tiles(tiles, u)
    return winograd_tiles_ref(tiles, u)


@winograd_tiles_op.register_fake
def _(tiles, u):
    b, th, tw = tiles.shape[:3]
    return tiles.new_empty((b, th, tw, 2, 2, u.shape[-1]))


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, grad):
    tiles, u = ctx.saved_tensors
    bt = torch.as_tensor(BT, device=tiles.device)
    at = torch.as_tensor(AT, device=tiles.device)
    v = torch.einsum("ij,btujkc,lk->btuilc", bt, tiles.float(), bt)
    dm = torch.einsum("ij,btuilf,lk->btujkf", at, grad.float(), at)
    dtiles = du = None
    if ctx.needs_input_grad[0]:
        dv = torch.einsum("btuilf,ilcf->btuilc", dm, u.float())
        dtiles = torch.einsum("ij,btuilc,lk->btujkc", bt, dv, bt).to(tiles.dtype)
    if ctx.needs_input_grad[1]:
        du = torch.einsum("btuilc,btuilf->ilcf", v, dm).to(u.dtype)
    return dtiles, du


winograd_tiles_op.register_autograd(_backward, setup_context=_setup_context)


def conv3x3_winograd(x: torch.Tensor, w: torch.Tensor,
                     padding: str = "SAME") -> torch.Tensor:
    """x: (b, H, W, cin) NHWC; w: (3, 3, cin, cout) HWIO. F(2x2,3x3)."""
    if tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"winograd kernel requires 3x3 filters, got "
                         f"{tuple(w.shape)}")
    b, H, W, cin = x.shape
    cout = w.shape[-1]
    if padding == "SAME":
        x = F.pad(x, (0, 0, 1, 1, 1, 1))
        H, W = H + 2, W + 2
    oh, ow = H - 2, W - 2
    th, tw = (oh + 1) // 2, (ow + 1) // 2
    x = F.pad(x, (0, 0, 0, 2 * tw + 2 - W, 0, 2 * th + 2 - H))
    # overlapping 4x4 windows at stride 2: a view, then one copy
    tiles = x.unfold(1, 4, 2).unfold(2, 4, 2)             # (b, th, tw, cin, 4, 4)
    tiles = tiles.permute(0, 1, 2, 4, 5, 3).contiguous()  # (b, th, tw, 4, 4, cin)
    g = torch.as_tensor(G, device=x.device, dtype=x.dtype)
    u = torch.einsum("ij,jkcf,lk->ilcf", g, w.to(x.dtype), g).contiguous()
    y = winograd_tiles_op(tiles, u)
    out = y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * th, 2 * tw, cout)
    return out[:, :oh, :ow]
