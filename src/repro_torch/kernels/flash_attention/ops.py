"""Public wrapper: the ``repro_torch::flash_attention`` op and its dispatch.

The counterpart of ``repro.kernels.flash_attention.ops``.  The op is a
``torch.library.custom_op`` with a fake implementation (so a captured step
shows every launch as one node) and an autograd rule whose backward
recomputes through :func:`attention_ref`, as the reference's ``custom_vjp``
does (one sequence and head group at a time): there is no backward kernel
in either package.  On CUDA tensors the op
launches the kernel; on CPU tensors it runs :func:`attention_ref`.  Unlike
the reference wrapper it neither pads nor falls back: the kernel masks
ragged sequence ends itself.  Query rows that see no key (a window shorter
than s - t + 1) get ``attention_ref``'s value on both devices: on the card
the op writes them after the kernel, which refuses them.  The op's forward
is the region ``attn.flash_fwd`` and its backward ``attn.bwd``
(:func:`repro_torch.obs.region`).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
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
                      kernel: Callable[..., torch.Tensor] = flash_attention_fwd
                      ) -> torch.Tensor:
    """The kernel's output, with the rows that see no key (which the kernel
    refuses) given ``attention_ref``'s value: the mean of v over the t keys,
    zeros at t = 0.  The rows are known from the shapes alone, so the kernel
    runs on the rows before them and the rest is a slice write: the same
    launches at every call, as a captured graph needs.  (``kernel``: a
    stand-in with the launcher's signature, for a test on the CPU.)"""
    s, t = q.shape[2], k.shape[2]
    first = first_keyless_row(s, t, window)
    if first == s:
        return kernel(q, k, v, causal=causal, window=window, softcap=softcap)
    out = torch.empty_like(q)
    if first:
        out[:, :, :first] = kernel(q[:, :, :first], k, v, causal=causal, window=window,
                                   softcap=softcap)
    if t:
        b, kvh, _, d = v.shape
        mean = v.float().mean(dim=2, keepdim=True)[:, :, None]     # (b, kv, 1, 1, d)
        out[:, :, first:] = mean.expand(b, kvh, q.shape[1] // kvh, 1, d).reshape(
            b, q.shape[1], 1, d).to(out.dtype)
    else:
        out[:, :, first:] = 0
    return out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: int, softcap: float) -> torch.Tensor:
    if use_kernel(q, k, v):
        return with_keyless_rows(q, k, v, causal=causal, window=window, softcap=softcap)
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


#: bytes of fp32 scores one piece of the backward may hold (512 MB)
BACKWARD_SCORE_BYTES = 1 << 29


def backward_pieces(b: int, kvh: int, group: int, s: int, t: int):
    """(batch index, first kv head, kv heads) of each piece the backward
    recomputes on its own: one sequence, and as many kv heads (with their
    query heads) as keep its (s, t) fp32 scores within
    ``BACKWARD_SCORE_BYTES``, at least one."""
    step = max(1, min(kvh, BACKWARD_SCORE_BYTES // max(4 * group * s * t, 1)))
    return [(i, h0, min(step, kvh - h0)) for i in range(b) for h0 in range(0, kvh, step)]


def _backward(ctx, grad):
    """Recompute through attention_ref and differentiate it, piece by piece
    (:func:`backward_pieces`): each (sequence, head group) is independent,
    so the pieces give the whole tensor's gradients, while only one piece's
    scores (and their softmax and gradients) exist at a time, whatever the
    batch.  At qwen1.5-4b's s = 4096 a sequence's 20 heads would hold 1.3
    GB a copy."""
    q, k, v = ctx.saved_tensors
    b, h, s, _ = q.shape
    kvh, t = k.shape[1], k.shape[2]
    group = h // kvh
    with region("attn.bwd"):
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        for i, h0, n in backward_pieces(b, kvh, group, s, t):
            kv = (slice(i, i + 1), slice(h0, h0 + n))
            qh = (slice(i, i + 1), slice(h0 * group, (h0 + n) * group))
            with torch.enable_grad():
                qi, ki, vi = (x.detach().requires_grad_() for x in (q[qh], k[kv], v[kv]))
                out = attention_ref(qi, ki, vi, **ctx.mask)
            dqi, dki, dvi = torch.autograd.grad(out, (qi, ki, vi), grad[qh])
            dq[qh], dk[kv], dv[kv] = dqi, dki, dvi
    return dq, dk, dv, None, None, None


flash_attention_op.register_autograd(_backward, setup_context=_setup_context)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (b, h, s, d); k/v: (b, kv, t, d) head-major -> (b, h, s, d).
    Differentiable; the hand kernel on CUDA, the plain version on the CPU."""
    with region("attn.flash_fwd"):
        return flash_attention_op(q, k, v, bool(causal), int(window), float(softcap))
