"""Attention: GQA + RoPE + causal / sliding-window / cross, train & decode paths.

The port of ``repro.models.attention``, with the same parameter names and
the same (b, s, heads, head_dim) activation layout.  Where the reference
runs its plain ``sdpa`` (or ``chunked_sdpa`` at s >= 4096) over a whole
sequence — self-attention from position 0, causal or not, in
:func:`attention` and :func:`attention_prefill`, and cross-attention
(``kv_source``: s queries against t other rows, no mask, no RoPE) — the
port calls the ``repro_torch::flash_attention`` op instead, at every
length: the hand kernel on CUDA, its plain version on the CPU.  So the
reference's ``chunked_sdpa`` has no counterpart here.
Decode attention (one query against the cache) stays plain PyTorch math, as
in the reference, which runs no Pallas kernel there.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import ParamSpec, apply_rope, dense

NEG_INF = -2.3819763e38   # the reference's mask value (min bf16-representable fp32)


def attn_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    specs = {
        "wq": ParamSpec((d, h * hd), ("fsdp", "qkv")),
        "wk": ParamSpec((d, kv * hd), ("fsdp", "qkv")),
        "wv": ParamSpec((d, kv * hd), ("fsdp", "qkv")),
        "wo": ParamSpec((h * hd, d), ("qkv", "fsdp")),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((h * hd,), ("qkv",), init="zeros")
        specs["bk"] = ParamSpec((kv * hd,), ("qkv",), init="zeros")
        specs["bv"] = ParamSpec((kv * hd,), ("qkv",), init="zeros")
    return specs


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
               window: int, k_valid_len: Optional[int] = None) -> torch.Tensor:
    """(q, k) additive mask bias in fp32; ``window <= 0`` disables the window."""
    dist = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones(dist.shape, dtype=torch.bool, device=dist.device)
    if causal:
        ok &= dist >= 0
    if window > 0:
        ok &= dist < window
    if k_valid_len is not None:
        ok &= k_pos[None, :] < k_valid_len
    return torch.where(ok, torch.zeros((), device=dist.device),
                       torch.full((), NEG_INF, device=dist.device))


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         bias: Optional[torch.Tensor], softcap: float = 0.0) -> torch.Tensor:
    """q: (b, s, h, d); k/v: (b, t, kv, d). GQA via head grouping. fp32 softmax."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    group = h // kvh
    qg = q.reshape(b, s, kvh, group, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    scores = scores / math.sqrt(d)
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    if bias is not None:
        scores = scores + bias     # (s, t) broadcast over (b, k, g)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, d)


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int, softcap: float) -> torch.Tensor:
    """(b, s, heads, d) in and out, through the flash op on head-major views
    (the kernel takes strides: no transpose copies on the card)."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=causal, window=window, softcap=softcap)
    return out.transpose(1, 2)


def attention(params: Dict, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, causal: bool = True,
              window: int = 0, kv_source: Optional[torch.Tensor] = None,
              use_rope: bool = True) -> torch.Tensor:
    """Full-sequence attention (train / prefill).  ``kv_source`` (b, t, d)
    given: cross-attention, every query against every row of it, without
    RoPE (``causal`` and ``window`` are ignored, as in the reference).

    The self-attention mask goes by sequence index, so ``positions`` must be
    0..s-1, as every caller in the reference passes them.
    """
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    src = x if kv_source is None else kv_source
    t = src.shape[1]
    q = dense(x, params["wq"], params.get("bq")).reshape(b, s, h, hd)
    k = dense(src, params["wk"], params.get("bk")).reshape(b, t, kv, hd)
    v = dense(src, params["wv"], params.get("bv")).reshape(b, t, kv, hd)
    if kv_source is None:
        if use_rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        out = _flash(q, k, v, causal=causal, window=window,
                              softcap=cfg.logit_softcap)
    else:
        out = _flash(q, k, v, causal=False, window=0,
                              softcap=cfg.logit_softcap)
    return dense(out.reshape(b, s, h * hd), params["wo"])


def attention_prefill(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, *, window: int = 0
                      ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Like :func:`attention` but also returns (k, v) for the KV cache."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = dense(x, params["wq"], params.get("bq")).reshape(b, s, h, hd)
    k = dense(x, params["wk"], params.get("bk")).reshape(b, s, kv, hd)
    v = dense(x, params["wv"], params.get("bv")).reshape(b, s, kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = _flash(q, k, v, causal=True, window=window,
                          softcap=cfg.logit_softcap)
    out = dense(out.reshape(b, s, h * hd), params["wo"])
    return out, (k, v)


def attention_decode(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                     *, window: int = 0
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode against a (b, S, kv, hd) cache.

    ``pos`` is the index of the new token (the same for the whole batch).
    Its k and v are written into the cache in place (the reference's
    ``dynamic_update_slice``, which XLA also applies in place); the same
    tensors are returned.
    """
    b = x.shape[0]
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    S = cache_k.shape[1]
    q = dense(x, params["wq"], params.get("bq")).reshape(b, 1, h, hd)
    k_new = dense(x, params["wk"], params.get("bk")).reshape(b, 1, kvh, hd)
    v_new = dense(x, params["wv"], params.get("bv")).reshape(b, 1, kvh, hd)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k_new = apply_rope(k_new, posv, cfg.rope_theta)
    cache_k[:, pos:pos + 1] = k_new.to(cache_k.dtype)
    cache_v[:, pos:pos + 1] = v_new.to(cache_v.dtype)
    k_pos = torch.arange(S, dtype=torch.int32, device=x.device)
    bias = _mask_bias(posv, k_pos, causal=True, window=window,
                      k_valid_len=pos + 1)
    out = sdpa(q, cache_k, cache_v, bias, cfg.logit_softcap)
    out = dense(out.reshape(b, 1, h * hd), params["wo"])
    return out, (cache_k, cache_v)
