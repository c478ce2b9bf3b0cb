"""Plain PyTorch version of the flash-attention kernel (no tiling, fp32
softmax): the port of ``repro.kernels.flash_attention.ref.attention_ref``."""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """q: (b, h, s, d); k/v: (b, kv, t, d). GQA by head grouping."""
    b, h, s, d = q.shape
    kvh, t = k.shape[1], k.shape[2]
    group = h // kvh
    kq = k.repeat_interleave(group, dim=1)
    vq = v.repeat_interleave(group, dim=1)
    scores = torch.einsum("bhsd,bhtd->bhst", q.float(), kq.float()) / (d ** 0.5)
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(t, device=q.device)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window > 0:
        ok &= (q_pos - k_pos) < window
    scores = torch.where(ok, scores, torch.full((), -1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs, vq.float()).to(q.dtype)
