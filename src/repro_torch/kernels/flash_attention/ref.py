"""Plain PyTorch version of the flash-attention kernel (no tiling, fp32
softmax): the port of ``repro.kernels.flash_attention.ref.attention_ref``."""
from __future__ import annotations

from typing import Optional

import torch


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int,
            softcap: float, scale: Optional[float] = None):
    """fp32 (b, h, s, t) scaled (and capped) scores, and the (s, t) mask of
    the pairs the masks let through.  ``scale`` multiplies the products
    (None: they are divided by sqrt(d))."""
    b, h, s, d = q.shape
    kvh, t = k.shape[1], k.shape[2]
    kq = k.repeat_interleave(h // kvh, dim=1)
    scores = torch.einsum("bhsd,bhtd->bhst", q.float(), kq.float())
    scores = scores / (d ** 0.5) if scale is None else scores * scale
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(t, device=q.device)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window > 0:
        ok &= (q_pos - k_pos) < window
    return scores, ok


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0, scale: Optional[float] = None) -> torch.Tensor:
    """q: (b, h, s, d); k/v: (b, kv, t, d). GQA by head grouping; the
    scores scaled by ``scale`` (None: 1/sqrt(d))."""
    scores, ok = _scores(q, k, causal, window, softcap, scale)
    vq = v.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    scores = torch.where(ok, scores, torch.full((), -1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs, vq.float()).to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                      window: int = 0, softcap: float = 0.0,
                      scale: Optional[float] = None) -> torch.Tensor:
    """fp32 (b, h, s): each query row's log-sum-exp of its scaled (and
    capped) scores over the keys it sees, -inf for a row that sees none:
    what the 16-bit flash kernel writes for the backward."""
    scores, ok = _scores(q, k, causal, window, softcap, scale)
    return torch.logsumexp(scores.masked_fill(~ok, float("-inf")), dim=-1)
