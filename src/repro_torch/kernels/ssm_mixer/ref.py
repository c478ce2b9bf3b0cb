"""Plain PyTorch versions of the two Mamba2 mixer kernels: the chains of
the port's prefill mixer (``repro.models.ssm.ssm_mixer``'s jnp) that each
replaces, in the working dtype, their outputs laid out as the kernels lay
them out.

They take the same steps as the model's plain code (``models/layers.py``'s
``causal_conv`` and ``gated_norm``, which the tests hold them to bit for
bit), written here so that the kernels import nothing from the models.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.kernel import padded


def conv_in_ref(zxbcdt: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                dt_bias: torch.Tensor, a_log: torch.Tensor, d_inner: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """From the in_proj output (b, s, d_inner + c + h) (z, the conv's input
    x, B, C, then dt): xbc (b, c, padded(s)), x's channels holding xdt =
    xh * dt and the rest B and C, each feature's row of positions zero
    padded; dA = dt * A (b, h, s) fp32; xh (b, s, d_inner), the conv's
    output on x; and the last ``width - 1`` raw conv inputs (b, rows, c)."""
    b, s, _ = zxbcdt.shape
    width, ch = conv_w.shape
    heads = dt_bias.shape[0]
    raw = zxbcdt[..., d_inner:d_inner + ch]
    conv = F.conv1d(F.pad(raw, (0, 0, width - 1, 0)).transpose(1, 2),
                    conv_w.t().reshape(ch, 1, width).to(raw.dtype), groups=ch)
    act = F.silu(conv.transpose(1, 2) + conv_b.to(raw.dtype))
    dt = F.softplus(zxbcdt[..., d_inner + ch:].float() + dt_bias.float())     # (b, s, h)
    A = -torch.exp(a_log.float())
    xh = act[..., :d_inner]
    xdt = (xh.unflatten(-1, (heads, -1)).float() * dt[..., None]).to(xh.dtype)
    xbc = zxbcdt.new_zeros((b, ch, padded(s)))
    xbc[:, :d_inner, :s] = xdt.flatten(-2).transpose(1, 2)
    xbc[:, d_inner:, :s] = act[..., d_inner:].transpose(1, 2)
    return (xbc, (dt * A).transpose(1, 2).contiguous(), xh.contiguous(),
            raw[:, -(width - 1):].contiguous())


def gated_norm_ref(y: torch.Tensor, xh: torch.Tensor, zxbcdt: torch.Tensor,
                   d_skip: torch.Tensor, norm: torch.Tensor, groups: int, eps: float
                   ) -> torch.Tensor:
    """y (b, s, h, p) from the scan, its skip D xh (xh (b, s, h p)), gated
    by silu(z), z the in_proj output's first h p columns, and normed by
    group: (b, s, h p)."""
    heads, d_inner = y.shape[2], y.shape[2] * y.shape[3]
    y = y + xh.unflatten(-1, (heads, -1)) * d_skip.to(y.dtype)[None, None, :, None]
    gated = (y.flatten(-2) * F.silu(zxbcdt[..., :d_inner])).unflatten(-1, (groups, -1))
    xf = gated.float()
    normed = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)).to(y.dtype)
    return (normed * (1.0 + norm.reshape(groups, -1).float()).to(y.dtype)).flatten(-2)
