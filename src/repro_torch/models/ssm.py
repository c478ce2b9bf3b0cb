"""Mamba2 (SSD) mixer: chunked-parallel training path + recurrent decode.

The port of ``repro.models.ssm``, with its parameter names and layouts.
The state-space-dual algorithm runs as a Python loop over sequence chunks
(the reference's ``lax.scan``), the state carried across chunks in fp32;
the work within a chunk is products (``torch.einsum``).  Decode is the
O(1)-state recurrence.

Shapes: d_inner = expand*d_model, heads = d_inner/64 (headdim p=64), ngroups=1,
state n = cfg.ssm_state.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.layers import ParamSpec, rms_norm

HEADDIM = 64
CHUNK = 128


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = max(d_inner // HEADDIM, 1)
    headdim = d_inner // heads
    return d_inner, heads, headdim, cfg.ssm_state


def ssm_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    d_inner, heads, headdim, n = _dims(cfg)
    conv_ch = d_inner + 2 * n
    return {
        "in_proj": ParamSpec((d, 2 * d_inner + 2 * n + heads), ("fsdp", "ffn")),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_ch), (None, "ffn"), init="fan_in"),
        "conv_b": ParamSpec((conv_ch,), ("ffn",), init="zeros"),
        "dt_bias": ParamSpec((heads,), ("ssm_heads",), init="zeros"),
        "a_log": ParamSpec((heads,), ("ssm_heads",), init="zeros"),
        "d_skip": ParamSpec((heads,), ("ssm_heads",), init="ones"),
        "norm": ParamSpec((d_inner,), ("ffn",), init="zeros"),
        "out_proj": ParamSpec((d_inner, d), ("ffn", "fsdp")),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_inner, heads, headdim, n = _dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner, n, n, heads], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. x: (b, s, c); w: (width, c)."""
    width, c = w.shape
    pad = F.pad(x, (0, 0, width - 1, 0)).transpose(1, 2)          # (b, c, s+w-1)
    out = F.conv1d(pad, w.t().reshape(c, 1, width).to(x.dtype), groups=c)
    return F.silu(out.transpose(1, 2) + b.to(x.dtype))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., l) -> (..., l, l) lower-tri segment sums Σ_{k=j+1..i} a_k."""
    l = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((l, l), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, seg, torch.full((), float("-inf"), device=a.device))


def ssd_chunked(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                state0: torch.Tensor, chunk: int = CHUNK
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    xdt:   (b, s, h, p)  — inputs pre-multiplied by dt
    dA:    (b, s, h)     — per-step log decay (dt * A, A<0)
    B, C:  (b, s, n)     — shared across heads (ngroups=1)
    state0:(b, h, p, n)
    Returns y: (b, s, h, p), final state (fp32).
    """
    b, s, h, p = xdt.shape
    nc = max(s // chunk, 1)
    chunk = s // nc
    if nc * chunk != s:
        raise ValueError(f"ssd_chunked: s={s} is not {nc} chunks of {chunk}")
    state = state0.float()
    ys = []
    for c0 in range(0, s, chunk):
        xc, ac, bc, cc = (t[:, c0:c0 + chunk] for t in (xdt, dA, B, C))
        a_cum = torch.cumsum(ac, dim=1)                        # (b, l, h)
        # intra-chunk: M[b,h,i,j] = C_i.B_j * exp(a_cum_i - a_cum_j) for j<=i
        L = torch.exp(_segsum(ac.transpose(1, 2)))             # (b, h, l, l)
        scores = torch.einsum("bin,bjn->bij", cc, bc)          # (b, l, l)
        M = (scores[:, None] * L).to(xc.dtype)                 # (b, h, l, l)
        y_diag = torch.einsum("bhij,bjhp->bihp", M, xc)
        # contribution of the incoming state
        sdecay = torch.exp(a_cum)                              # (b, l, h)
        y_off = torch.einsum("bin,bhpn,bih->bihp", cc.float(), state,
                             sdecay).to(xc.dtype)
        # state update
        total = a_cum[:, -1:, :]                               # (b, 1, h)
        rdecay = torch.exp(total - a_cum)                      # (b, l, h)
        state = state * torch.exp(total)[:, 0, :, None, None] + torch.einsum(
            "bjn,bjh,bjhp->bhpn", bc.float(), rdecay.float(), xc.float())
        ys.append(y_diag + y_off)
    return torch.cat(ys, dim=1), state


def _mixer_inputs(params: Dict, cfg: ModelConfig, x: torch.Tensor):
    """The projections, the causal conv and dt: (z, xh (b, s, h, p), xdt,
    dA, B, C, the conv's raw input (b, s, c))."""
    d_inner, heads, headdim, n = _dims(cfg)
    b, s, _ = x.shape
    zxbcdt = torch.einsum("bsd,de->bse", x, params["in_proj"])
    z, xs, B, C, dt = _split_proj(cfg, zxbcdt)
    xbc_raw = torch.cat([xs, B, C], dim=-1)
    xbc = _causal_conv(xbc_raw, params["conv_w"], params["conv_b"])
    xs, B, C = torch.split(xbc, [d_inner, n, n], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"].float())       # (b, s, h)
    A = -torch.exp(params["a_log"].float())                       # (h,)
    xh = xs.reshape(b, s, heads, headdim)
    xdt = (xh.float() * dt[..., None]).to(x.dtype)
    return z, xh, xdt, dt * A, B, C, xbc_raw


def _mixer_out(params: Dict, cfg: ModelConfig, x: torch.Tensor, y: torch.Tensor,
               xh: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[:2]
    y = y + xh * params["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(b, s, -1)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return torch.einsum("bse,ed->bsd", y, params["out_proj"])


def ssm_mixer(params: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Training/prefill path. x: (b, s, d) -> (b, s, d)."""
    return ssm_prefill(params, cfg, x)[0]


def ssm_prefill(params: Dict, cfg: ModelConfig, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`ssm_mixer` and the decode cache it leaves: {state (b, h, p, n)
    fp32, conv: the last ``ssm_conv - 1`` raw conv inputs}."""
    d_inner, heads, headdim, n = _dims(cfg)
    z, xh, xdt, dA, B, C, xbc_raw = _mixer_inputs(params, cfg, x)
    state0 = torch.zeros((x.shape[0], heads, headdim, n), dtype=torch.float32,
                         device=x.device)
    y, state = ssd_chunked(xdt, dA, B, C, state0)
    out = _mixer_out(params, cfg, x, y, xh, z)
    return out, {"state": state, "conv": xbc_raw[:, -(cfg.ssm_conv - 1):, :]}


# ---------------------------------------------------------------------------
# Decode (recurrent, O(1) per token)
# ---------------------------------------------------------------------------

def ssm_cache_shape(cfg: ModelConfig, batch: int) -> Dict[str, Tuple[int, ...]]:
    d_inner, heads, headdim, n = _dims(cfg)
    conv_ch = d_inner + 2 * n
    return {
        "state": (batch, heads, headdim, n),
        "conv": (batch, cfg.ssm_conv - 1, conv_ch),
    }


def ssm_decode_step(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                    cache: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (b, 1, d); cache: {state: (b,h,p,n) fp32, conv: (b,w-1,c)}."""
    d_inner, heads, headdim, n = _dims(cfg)
    b = x.shape[0]
    zxbcdt = torch.einsum("bsd,de->bse", x, params["in_proj"])
    z, xs, B, C, dt = _split_proj(cfg, zxbcdt)
    xbc_new = torch.cat([xs, B, C], dim=-1)                          # (b, 1, c)
    window = torch.cat([cache["conv"], xbc_new], dim=1)              # (b, w, c)
    conv_out = torch.sum(window * params["conv_w"].to(window.dtype)[None], dim=1)
    xbc = F.silu(conv_out + params["conv_b"].to(conv_out.dtype))
    xs1, B1, C1 = torch.split(xbc, [d_inner, n, n], dim=-1)          # (b, c)
    dt1 = F.softplus(dt[:, 0].float() + params["dt_bias"].float())  # (b, h)
    A = -torch.exp(params["a_log"].float())
    xh = xs1.reshape(b, heads, headdim).float()
    dA = torch.exp(dt1 * A)                                          # (b, h)
    state = cache["state"] * dA[..., None, None] + torch.einsum(
        "bn,bhp->bhpn", B1.float(), xh * dt1[..., None])
    y = torch.einsum("bn,bhpn->bhp", C1.float(), state)
    y = y + xh * params["d_skip"].float()[None, :, None]
    y = y.reshape(b, 1, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y, params["out_proj"])
    return out, {"state": state, "conv": window[:, 1:]}
