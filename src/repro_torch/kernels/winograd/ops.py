"""Public wrapper: the filter transform and the ``repro_torch::conv3x3_winograd``
op; and the ``repro_torch::winograd_tiles`` op of the tiles entry.

``conv3x3_winograd`` checks the padding, computes U = G w G^T in x's dtype
(as the reference's ``ops.py`` does) and calls one op.  On CUDA tensors the
op launches the fused kernel (:func:`winograd_conv`: x in NHWC to y in
NHWC, tile extraction and reassembly inside); on CPU tensors it runs
:func:`conv3x3_winograd_ref`, the reference wrapper's unfused program.

Neither kernel owes a backward (the reference kernel has no VJP).  The conv
op's gradient recomputes through :func:`conv3x3_winograd_ref`, as the flash
op's does through its plain version; the tiles op's is a plain PyTorch
formula.  The LeNet smoke model differentiates through its 3x3 Winograd
convs in the CPU tests.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.winograd.kernel import (PADDINGS, winograd_conv,
                                                 winograd_plan, winograd_tiles)
from repro_torch.kernels.winograd.ref import (conv3x3_winograd_ref, transform,
                                              winograd_tiles_ref)


@torch.library.custom_op("repro_torch::conv3x3_winograd", mutates_args=())
def conv3x3_winograd_op(x: torch.Tensor, u: torch.Tensor,
                        padding: str) -> torch.Tensor:
    if use_kernel(x, u):
        return winograd_conv(x, u, padding)
    return conv3x3_winograd_ref(x, u, padding)


@conv3x3_winograd_op.register_fake
def _(x, u, padding):
    b, H, W, _ = x.shape
    plan = winograd_plan(b, H, W, x.shape[3], u.shape[3], padding)
    return x.new_empty((b, plan.oh, plan.ow, u.shape[3]))


def _conv_setup_context(ctx, inputs, output):
    x, u, padding = inputs
    ctx.save_for_backward(x, u)
    ctx.padding = padding


def _conv_backward(ctx, grad):
    with torch.enable_grad():
        x, u = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        out = conv3x3_winograd_ref(x, u, ctx.padding)
    dx, du = torch.autograd.grad(out, (x, u), grad)
    return dx, du, None


conv3x3_winograd_op.register_autograd(_conv_backward,
                                      setup_context=_conv_setup_context)


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
    bt = transform("BT", tiles.device)
    at = transform("AT", tiles.device)
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


def filter_transform(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """U = G w G^T (4, 4, cin, cout), contiguous, computed in ``dtype``.

    Two products, G w first, as the reference's three-operand einsum
    contracts them (the same bf16 roundings); a three-operand
    ``torch.einsum`` would search for a contraction order on every call,
    about a quarter of a millisecond of host time."""
    g = transform("G", w.device, dtype)
    gw = torch.einsum("ij,jkcf->ikcf", g, w.to(dtype))
    return torch.einsum("lk,ikcf->ilcf", g, gw).contiguous()


def conv3x3_winograd(x: torch.Tensor, w: torch.Tensor,
                     padding: str = "SAME") -> torch.Tensor:
    """x: (b, H, W, cin) NHWC; w: (3, 3, cin, cout) HWIO. F(2x2,3x3)."""
    if tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"winograd kernel requires 3x3 filters, got "
                         f"{tuple(w.shape)}")
    if padding not in PADDINGS:
        raise ValueError(f"padding must be one of {PADDINGS}; got {padding!r}")
    return conv3x3_winograd_op(x, filter_transform(w, x.dtype), padding)
