"""Public wrapper: the ``repro_torch::flash_attention`` op and its dispatch.

The counterpart of ``repro.kernels.flash_attention.ops``.  The op is a
``torch.library.custom_op`` with a fake implementation (so a captured step
shows every launch as one node) and an autograd rule whose backward
recomputes through :func:`attention_ref`, as the reference's ``custom_vjp``
does: there is no backward kernel in either package.  On CUDA tensors the op
launches the kernel; on CPU tensors it runs :func:`attention_ref`.  Unlike
the reference wrapper it neither pads nor falls back: the kernel masks
ragged sequence ends itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.flash_attention.kernel import (check_rows_see_a_key,
                                                        flash_attention_fwd)
from repro_torch.kernels.flash_attention.ref import attention_ref


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: int, softcap: float) -> torch.Tensor:
    if use_kernel(q, k, v):
        return flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    check_rows_see_a_key(q.shape[2], k.shape[2], window)
    # laid out like q, as the kernel and the fake lay it out, so that a
    # captured graph's views of it replay on the CPU too
    return torch.empty_like(q).copy_(
        attention_ref(q, k, v, causal=causal, window=window, softcap=softcap))


@flash_attention_op.register_fake
def _(q, k, v, causal, window, softcap):
    return torch.empty_like(q)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window, softcap = inputs
    ctx.save_for_backward(q, k, v)
    ctx.mask = dict(causal=causal, window=window, softcap=softcap)


def _backward(ctx, grad):
    with torch.enable_grad():
        q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
        out = attention_ref(q, k, v, **ctx.mask)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad)
    return dq, dk, dv, None, None, None


flash_attention_op.register_autograd(_backward, setup_context=_setup_context)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (b, h, s, d); k/v: (b, kv, t, d) head-major -> (b, h, s, d).
    Differentiable; the hand kernel on CUDA, the plain version on the CPU."""
    return flash_attention_op(q, k, v, bool(causal), int(window), float(softcap))
