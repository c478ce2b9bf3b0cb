"""RWKV6 (Finch) mixer: data-dependent decay linear attention.

The port of ``repro.models.rwkv``, with its parameter names and layouts.
Time-mixing implements the WKV6 recurrence
    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (w_t in (0,1), data-dependent)
    y_t = r_t^T S_{t-1} + (r_t . (u * k_t)) v_t
with a chunked-parallel training path (a Python loop over chunks, the
reference's ``lax.scan``; products within a chunk) and a recurrent
O(1)-state decode path.  Data-dependent token-shift (ddlerp) and the decay
LoRA follow arXiv:2404.05892; LayerNorms are RMSNorms, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.layers import ParamSpec, rms_norm

CHUNK = 64   # the pairwise (i, j, dim) decay tensor is O(chunk^2 * d)
LORA_R = 32
DECAY_LORA_R = 64
MIX_NAMES = ("r", "k", "v", "w", "g")


def _dims(cfg: ModelConfig) -> Tuple[int, int]:
    heads = max(cfg.d_model // cfg.rwkv_head_dim, 1)
    return heads, cfg.d_model // heads


def rwkv_time_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    return {
        "mu_base": ParamSpec((len(MIX_NAMES), d), (None, None), init="zeros"),
        "mu_x": ParamSpec((d,), (None,), init="zeros"),
        "lora_a": ParamSpec((d, len(MIX_NAMES) * LORA_R), ("fsdp", None), scale=0.1),
        "lora_b": ParamSpec((len(MIX_NAMES), LORA_R, d), (None, None, None), init="zeros"),
        "w0": ParamSpec((d,), (None,), init="zeros"),
        "w_lora_a": ParamSpec((d, DECAY_LORA_R), ("fsdp", None), scale=0.1),
        "w_lora_b": ParamSpec((DECAY_LORA_R, d), (None, None), init="zeros"),
        "u": ParamSpec((d,), (None,), init="zeros"),
        "wr": ParamSpec((d, d), ("fsdp", "qkv")),
        "wk": ParamSpec((d, d), ("fsdp", "qkv")),
        "wv": ParamSpec((d, d), ("fsdp", "qkv")),
        "wg": ParamSpec((d, d), ("fsdp", "qkv")),
        "wo": ParamSpec((d, d), ("qkv", "fsdp")),
        "ln_x": ParamSpec((d,), (None,), init="zeros"),
    }


def rwkv_channel_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": ParamSpec((d,), (None,), init="zeros"),
        "mu_r": ParamSpec((d,), (None,), init="zeros"),
        "wk": ParamSpec((d, f), ("fsdp", "ffn")),
        "wv": ParamSpec((f, d), ("ffn", "fsdp")),
        "wr": ParamSpec((d, d), ("fsdp", None)),
    }


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x_{t-1} sequence; prev: (b, 1, d) carry from the previous segment."""
    return torch.cat([prev, x[:, :-1]], dim=1)


def _ddlerp(params: Dict, x: torch.Tensor, xs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Data-dependent token-shift producing the 5 mixed inputs."""
    dx = xs - x
    base = x + dx * params["mu_x"].to(x.dtype)
    lora = torch.einsum("bsd,dr->bsr", torch.tanh(base), params["lora_a"])
    lora = lora.reshape(x.shape[:2] + (len(MIX_NAMES), LORA_R))
    adj = torch.einsum("bsmr,mrd->bsmd", lora, params["lora_b"])
    mix = params["mu_base"].to(x.dtype)[None, None] + adj
    return {name: x + dx * mix[:, :, i] for i, name in enumerate(MIX_NAMES)}


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
                u: torch.Tensor, state0: torch.Tensor, chunk: int = CHUNK
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6.

    r,k,v: (b, s, h, hd); logw: (b, s, h, hd) (log decay, <0); u: (h, hd)
    state0: (b, h, hd, hd)  [k-dim x v-dim]
    Returns y (b, s, h, hd) in r's dtype, final state (fp32).
    """
    b, s, h, hd = r.shape
    nc = max(s // chunk, 1)
    c = s // nc
    if nc * c != s:
        raise ValueError(f"wkv_chunked: s={s} is not {nc} chunks of {c}")
    ii = torch.arange(c, device=r.device)
    strict = ii[None, :] < ii[:, None]                      # (i, j): j < i
    eye = torch.eye(c, device=r.device)
    uf = u.float()
    state = state0.float()
    ys = []
    for c0 in range(0, s, c):
        rc, kc, vc, wc = (t[:, c0:c0 + c].float() for t in (r, k, v, logw))
        P = torch.cumsum(wc, dim=1)                         # (b, c, h, hd) log cumprod
        Pprev = P - wc                                      # logP_{i-1}
        # pairwise decay: exp(Pprev_i - P_j) on the k-dim, j < i
        diff = Pprev[:, :, None] - P[:, None, :]            # (b, i, j, h, hd)
        decay = torch.exp(torch.where(strict[None, :, :, None, None], diff,
                                      torch.full((), float("-inf"), device=r.device)))
        A = torch.einsum("bihd,bijhd,bjhd->bhij", rc, decay, kc)
        # the bonus term r.(u*k): u contracted last, as the reference's
        # einsum path contracts it
        A = A + torch.einsum("bihd,hd->bhi", rc * kc, uf)[..., None] * eye
        y = torch.einsum("bhij,bjhd->bihd", A, vc)
        # incoming state contribution
        y = y + torch.einsum("bihd,bhde->bihe", rc * torch.exp(Pprev), state)
        # state update: S_out = diag(exp(P_c)) S + sum_j exp(P_c - P_j) k_j v_j^T
        total = P[:, -1:]                                   # (b, 1, h, hd)
        sdecay = torch.exp(total - P)                       # (b, c, h, hd)
        state = state * torch.exp(total[:, 0])[..., None] + torch.einsum(
            "bjhd,bjhe->bhde", kc * sdecay, vc)
        ys.append(y)
    return torch.cat(ys, dim=1).to(r.dtype), state


def _decay_log(params: Dict, xw: torch.Tensor) -> torch.Tensor:
    """log w_t = -exp(w0 + lora(xw)) -> (b, s, d), strictly negative."""
    lora = torch.einsum("bsd,dr->bsr", torch.tanh(xw), params["w_lora_a"])
    ww = params["w0"].float() + torch.einsum(
        "bsr,rd->bsd", lora, params["w_lora_b"]).float()
    return -torch.exp(ww)


def rwkv_time_mix(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                  prev: torch.Tensor, state0: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train/prefill path. Returns (y, last_x, final_state)."""
    heads, hd = _dims(cfg)
    b, s, d = x.shape
    mixed = _ddlerp(params, x, _shift(x, prev))
    r = torch.einsum("bsd,de->bse", mixed["r"], params["wr"]).reshape(b, s, heads, hd)
    k = torch.einsum("bsd,de->bse", mixed["k"], params["wk"]).reshape(b, s, heads, hd)
    v = torch.einsum("bsd,de->bse", mixed["v"], params["wv"]).reshape(b, s, heads, hd)
    g = F.silu(torch.einsum("bsd,de->bse", mixed["g"], params["wg"]))
    logw = _decay_log(params, mixed["w"]).reshape(b, s, heads, hd)
    u = params["u"].float().reshape(heads, hd)
    y, state = wkv_chunked(r, k, v, logw, u, state0)
    y = rms_norm(y.reshape(b, s, d), params["ln_x"], cfg.norm_eps) * g
    out = torch.einsum("bsd,de->bse", y, params["wo"])
    return out, x[:, -1:], state


def rwkv_time_decode(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                     prev: torch.Tensor, state: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token recurrent step. x: (b,1,d); state: (b,h,hd,hd) fp32."""
    heads, hd = _dims(cfg)
    b, _, d = x.shape
    mixed = _ddlerp(params, x, prev)
    r = torch.einsum("bsd,de->bse", mixed["r"], params["wr"]).reshape(b, heads, hd)
    k = torch.einsum("bsd,de->bse", mixed["k"], params["wk"]).reshape(b, heads, hd)
    v = torch.einsum("bsd,de->bse", mixed["v"], params["wv"]).reshape(b, heads, hd)
    g = F.silu(torch.einsum("bsd,de->bse", mixed["g"], params["wg"]))
    logw = _decay_log(params, mixed["w"]).reshape(b, heads, hd)
    u = params["u"].float().reshape(heads, hd)
    rf, kf, vf = r.float(), k.float(), v.float()
    y = torch.einsum("bhd,bhde->bhe", rf, state) + torch.einsum(
        "bhd,hd,bhd,bhe->bhe", rf, u, kf, vf)
    state = state * torch.exp(logw)[..., None] + torch.einsum("bhd,bhe->bhde", kf, vf)
    y = y.reshape(b, 1, d).to(x.dtype)
    y = rms_norm(y, params["ln_x"], cfg.norm_eps) * g
    return torch.einsum("bsd,de->bse", y, params["wo"]), x, state


def rwkv_channel_mix(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                     prev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xs = _shift(x, prev)
    xk = x + (xs - x) * params["mu_k"].to(x.dtype)
    xr = x + (xs - x) * params["mu_r"].to(x.dtype)
    k = torch.square(F.relu(torch.einsum("bsd,df->bsf", xk, params["wk"])))
    kv = torch.einsum("bsf,fd->bsd", k, params["wv"])
    r = torch.sigmoid(torch.einsum("bsd,de->bse", xr, params["wr"]))
    return r * kv, x[:, -1:]


def rwkv_channel_decode(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                        prev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    y, _ = rwkv_channel_mix(params, cfg, x, prev)
    return y, x


def rwkv_cache_shapes(cfg: ModelConfig, batch: int) -> Dict[str, Tuple[int, ...]]:
    heads, hd = _dims(cfg)
    return {
        "state": (batch, heads, hd, hd),
        "tm_prev": (batch, 1, cfg.d_model),
        "cm_prev": (batch, 1, cfg.d_model),
    }
