"""Public wrapper: the ``repro_torch::flash_attention`` ops and their dispatch.

The counterpart of ``repro.kernels.flash_attention.ops``.  The forward is a
``torch.library.custom_op`` with a fake implementation (so a captured step
shows every launch as one node); on CUDA tensors it launches the kernel, on
CPU tensors it runs :func:`attention_ref`.  Unlike the reference wrapper it
neither pads nor falls back: the kernel masks ragged sequence ends itself.
Query rows that see no key (a window shorter than s - t + 1) get
``attention_ref``'s value on both devices: on the card the op writes them
after the kernel, which refuses them.

The backward is chosen by what the inputs show (:func:`backward_route`).
The plain version recomputes through :func:`attention_ref` and
differentiates it, as the reference's ``custom_vjp`` does (one sequence and
head group at a time): CPU tensors, fp32 CUDA tensors and d 224 and 256.
Every other CUDA tensor runs the hand backward kernel
(``csrc/flash_attention_bwd.cu``), which the reference does not have: where
autograd will need it, :func:`flash_attention` calls the kernel route's
op ``repro_torch::flash_attention_lse`` instead, which also returns each
row's log-sum-exp, and its backward ``repro_torch::flash_attention_bwd``
launches the kernel on it.  The route is chosen there alone.  Every op
takes the scores' ``scale``, None for 1/sqrt(d).  The forward is the region
``attn.flash_fwd`` and either backward ``attn.bwd``
(:func:`repro_torch.obs.region`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.flash_attention.kernel import (BWD_HEAD_DIMS, flash_attention_bwd,
                                                        flash_attention_fwd,
                                                        tma_layout_problem)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.obs import region


def first_keyless_row(s: int, t: int, window: int) -> int:
    """The first query row that sees no key (``s`` if every row sees one).

    Row q sees key j iff j <= t - 1 (and j <= q, causal) and, with a
    window, q - j < window: causal or not, rows from t + window - 1 on see
    none, and with t = 0 every row."""
    if t == 0:
        return 0
    return min(s, t + window - 1) if window > 0 else s


def with_keyless_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: int, softcap: float,
                      lse: Optional[torch.Tensor] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's output, with the rows that see no key (which the kernel
    refuses) given ``attention_ref``'s value: the mean of v over the t keys,
    zeros at t = 0.  The rows are known from the shapes alone, so the kernel
    runs on the rows before them and the rest is a slice write: the same
    launches at every call, as a captured graph needs.  With ``lse`` (fp32
    (b, h, s)) the kernel writes the rows' log-sum-exp into it, and the
    keyless rows get -inf."""
    s, t = q.shape[2], k.shape[2]
    first = first_keyless_row(s, t, window)
    mask = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if lse is not None:
        mask["lse"] = lse[:, :, :first]
        if first < s:
            lse[:, :, first:] = float("-inf")
    if first == s:
        return flash_attention_fwd(q, k, v, **mask)
    out = torch.empty_like(q)
    if first:
        out[:, :, :first] = flash_attention_fwd(q[:, :, :first], k, v, **mask)
    if t:
        b, kvh, _, d = v.shape
        mean = v.float().mean(dim=2, keepdim=True)[:, :, None]     # (b, kv, 1, 1, d)
        out[:, :, first:] = mean.expand(b, kvh, q.shape[1] // kvh, 1, d).reshape(
            b, q.shape[1], 1, d).to(out.dtype)
    else:
        out[:, :, first:] = 0
    return out


def backward_route(device: torch.device, dtype: torch.dtype, head_dim: int) -> str:
    """Which backward the flash op takes for inputs of this device, dtype
    and head dim: ``"recompute"`` (the plain version: CPU tensors, fp32 CUDA
    tensors, whose forward runs on the CUDA cores, and head dims outside
    ``BWD_HEAD_DIMS``, which the kernel is not compiled for) or ``"kernel"``
    (every other CUDA tensor: the launcher runs or raises)."""
    if device.type != "cuda" or dtype == torch.float32 or head_dim not in BWD_HEAD_DIMS:
        return "recompute"
    return "kernel"


def backward_with_keyless_rows(q, k, v, out, lse, dout, *, causal: bool, window: int,
                               softcap: float,
                               scale: Optional[float] = None) -> Tuple[torch.Tensor, ...]:
    """The kernel's gradients, with those of the rows that see no key (which
    the kernel refuses) added here.  ``attention_ref`` gives such a row a
    uniform softmax over all t keys through a constant score, so each of its
    heads adds dout / t to the dv of every key of its kv head, and it adds
    nothing to dq (its own rows: zero) or dk.  As the forward, the kernel
    runs on the rows before them, from the shapes alone."""
    s, t = q.shape[2], k.shape[2]
    first = first_keyless_row(s, t, window)
    mask = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if first == s:
        return flash_attention_bwd(q, k, v, out, lse, dout, **mask)
    dq = torch.zeros_like(q)
    if first:
        rows = slice(None), slice(None), slice(None, first)
        dq[rows], dk, dv = flash_attention_bwd(q[rows], k, v, out[rows], lse[rows],
                                               dout[rows], **mask)
    else:
        dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    if t:
        b, kvh, _, d = v.shape
        keyless = dout[:, :, first:].float().sum(dim=2).reshape(b, kvh, -1, d).sum(dim=2)
        dv = (dv.float() + keyless[:, :, None] / t).to(dv.dtype)
    return dq, dk, dv


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: int, softcap: float,
                       scale: Optional[float] = None) -> torch.Tensor:
    mask = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if use_kernel(q, k, v):
        return with_keyless_rows(q, k, v, **mask)
    # laid out like q, as the kernel and the fake lay it out, so that a
    # captured graph's views of it replay on the CPU too
    return torch.empty_like(q).copy_(attention_ref(q, k, v, **mask))


@flash_attention_op.register_fake
def _(q, k, v, causal, window, softcap, scale=None):
    return torch.empty_like(q)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window, softcap, scale = inputs
    ctx.save_for_backward(q, k, v)
    ctx.mask = dict(causal=causal, window=window, softcap=softcap, scale=scale)


#: bytes of fp32 scores one piece of the backward may hold (512 MB)
BACKWARD_SCORE_BYTES = 1 << 29


def backward_pieces(b: int, kvh: int, group: int, s: int, t: int):
    """(batch index, first kv head, kv heads) of each piece the backward
    recomputes on its own: one sequence, and as many kv heads (with their
    query heads) as keep its (s, t) fp32 scores within
    ``BACKWARD_SCORE_BYTES``, at least one."""
    step = max(1, min(kvh, BACKWARD_SCORE_BYTES // max(4 * group * s * t, 1)))
    return [(i, h0, min(step, kvh - h0)) for i in range(b) for h0 in range(0, kvh, step)]


def recompute_backward(q, k, v, grad, *, causal: bool, window: int, softcap: float,
                       scale: Optional[float] = None):
    """The plain backward: recompute through attention_ref and differentiate
    it, piece by piece (:func:`backward_pieces`): each (sequence, head group)
    is independent, so the pieces give the whole tensor's gradients, while
    only one piece's scores (and their softmax and gradients) exist at a
    time, whatever the batch.  At qwen1.5-4b's s = 4096 a sequence's 20
    heads would hold 1.3 GB a copy."""
    b, h, s, _ = q.shape
    kvh, t = k.shape[1], k.shape[2]
    group = h // kvh
    mask = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for i, h0, n in backward_pieces(b, kvh, group, s, t):
        kv = (slice(i, i + 1), slice(h0, h0 + n))
        qh = (slice(i, i + 1), slice(h0 * group, (h0 + n) * group))
        with torch.enable_grad():
            qi, ki, vi = (x.detach().requires_grad_() for x in (q[qh], k[kv], v[kv]))
            out = attention_ref(qi, ki, vi, **mask)
        dqi, dki, dvi = torch.autograd.grad(out, (qi, ki, vi), grad[qh])
        dq[qh], dk[kv], dv[kv] = dqi, dki, dvi
    return dq, dk, dv


def _backward(ctx, grad):
    q, k, v = ctx.saved_tensors
    with region("attn.bwd"):
        dq, dk, dv = recompute_backward(q, k, v, grad, **ctx.mask)
    return dq, dk, dv, None, None, None, None


flash_attention_op.register_autograd(_backward, setup_context=_setup_context)


@torch.library.custom_op("repro_torch::flash_attention_lse", mutates_args=())
def flash_attention_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           causal: bool, window: int, softcap: float,
                           scale: Optional[float] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel route's forward: the output and each query row's fp32
    log-sum-exp (b, h, s), for the backward kernel (the launcher raises on
    inputs it does not take)."""
    b, h, s, _ = q.shape
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    out = with_keyless_rows(q, k, v, causal=causal, window=window, softcap=softcap, lse=lse,
                            scale=scale)
    return out, lse


@flash_attention_lse_op.register_fake
def _(q, k, v, causal, window, softcap, scale=None):
    b, h, s, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, s), dtype=torch.float32)


def _tma_ready(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a contiguous copy where TMA cannot read its layout (an
    incoming gradient may be broadcast or oddly strided)."""
    if tma_layout_problem("dout", x.shape, x.stride(), x.element_size(), x.data_ptr()):
        return x.contiguous()
    return x


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                           causal: bool, window: int, softcap: float,
                           scale: Optional[float] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's output and log-sum-exp through the
    backward kernel (which raises on what it does not take)."""
    return backward_with_keyless_rows(q, k, v, out, lse, _tma_ready(dout), causal=causal,
                                      window=window, softcap=softcap, scale=scale)


@flash_attention_bwd_op.register_fake
def _(q, k, v, out, lse, dout, causal, window, softcap, scale=None):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _setup_context_lse(ctx, inputs, output):
    q, k, v, causal, window, softcap, scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.mark_non_differentiable(lse)
    ctx.mask = dict(causal=causal, window=window, softcap=softcap, scale=scale)


def _backward_lse(ctx, grad, _grad_lse):
    q, k, v, out, lse = ctx.saved_tensors
    with region("attn.bwd"):
        dq, dk, dv = flash_attention_bwd_op(q, k, v, out, lse, grad, **ctx.mask)
    return dq, dk, dv, None, None, None, None


flash_attention_lse_op.register_autograd(_backward_lse, setup_context=_setup_context_lse)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: Optional[float] = None) -> torch.Tensor:
    """q: (b, h, s, d); k/v: (b, kv, t, d) head-major -> (b, h, s, d), the
    scores scaled by ``scale`` (None: 1/sqrt(d)).
    Differentiable; the hand kernel on CUDA, the plain version on the CPU.
    Where autograd will differentiate it and :func:`backward_route` names
    the kernel, the forward also keeps each row's log-sum-exp for it."""
    args = (q, k, v, bool(causal), int(window), float(softcap),
            None if scale is None else float(scale))
    with region("attn.flash_fwd"):
        if (torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
                and backward_route(q.device, q.dtype, q.shape[-1]) == "kernel"):
            return flash_attention_lse_op(*args)[0]
        return flash_attention_op(*args)
