"""Plain PyTorch version of the SSD chunk-scan kernel: the chunk loop of the
port's Mamba2 scan (``repro.models.ssm.ssd_chunked``'s ``lax.scan`` over
chunks), one chunk's outputs and state update a step, the state carried in
fp32 and the work within a chunk done as products (``torch.einsum``)."""
from __future__ import annotations

from typing import Tuple

import torch


def segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., l) -> (..., l, l) lower-tri segment sums Σ_{k=j+1..i} a_k."""
    l = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((l, l), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, seg, torch.full((), float("-inf"), device=a.device))


def chunk_step(xc: torch.Tensor, ac: torch.Tensor, bc: torch.Tensor, cc: torch.Tensor,
               state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the scan, B and C in g groups (b, l, g, n): its output
    (b, l, h, p) and the state after it.  The heads are taken as (g, r),
    r = h / g, so that C_i.B_j is formed once a group."""
    b, l, h, p = xc.shape
    g, n = bc.shape[2], bc.shape[3]
    r = h // g
    xg = xc.reshape(b, l, g, r, p)
    a_cum = torch.cumsum(ac, dim=1)                        # (b, l, h)
    # intra-chunk: M[b,h,i,j] = C_i.B_j * exp(a_cum_i - a_cum_j) for j<=i
    L = torch.exp(segsum(ac.transpose(1, 2))).reshape(b, g, r, l, l)
    scores = torch.einsum("bign,bjgn->bgij", cc, bc)       # (b, g, l, l)
    M = (scores[:, :, None] * L).to(xc.dtype)              # (b, g, r, l, l)
    y_diag = torch.einsum("bgrij,bjgrp->bigrp", M, xg)
    # contribution of the incoming state, then the state update
    sdecay = torch.exp(a_cum).reshape(b, l, g, r)
    sg = state.reshape(b, g, r, p, n)
    y_off = torch.einsum("bign,bgrpn,bigr->bigrp", cc.float(), sg, sdecay).to(xc.dtype)
    total = a_cum[:, -1:, :]                               # (b, 1, h)
    rdecay = torch.exp(total - a_cum).reshape(b, l, g, r)
    state = state * torch.exp(total)[:, 0, :, None, None] + torch.einsum(
        "bjgn,bjgr,bjgrp->bgrpn", bc.float(), rdecay, xg.float()).reshape(b, h, p, n)
    return (y_diag + y_off).reshape(b, l, h, p), state


def ssd_scan_ref(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                 state0: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """xdt (b, s, h, p), dA (b, s, h), B and C (b, s, g, n), state0
    (b, h, p, n) -> y (b, s, h, p) in xdt's dtype and the final state, fp32:
    the scan over chunks of ``chunk`` rows, the last one s - (chunks - 1)
    chunk (:func:`chunk_step` each)."""
    state = state0.float()
    ys = []
    for c0 in range(0, xdt.shape[1], chunk):
        y, state = chunk_step(*(t[:, c0:c0 + chunk] for t in (xdt, dA, B, C)), state)
        ys.append(y)
    return torch.cat(ys, dim=1), state
