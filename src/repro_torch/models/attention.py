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
in the reference, which runs no Pallas kernel there: the region
``attn.core`` (:func:`repro_torch.obs.region`), beside the flash op's
``attn.flash_fwd``.  Every path takes the scores' ``scale`` (None: 1/sqrt(d),
the reference's).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.distributed.sharding import ambient_mesh, gather_dims, lc
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import ParamSpec, apply_rope, dense
from repro_torch.obs import region

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
               window: int, k_valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(q, k) additive mask bias in fp32; ``window <= 0`` disables the
    window; keys from ``k_valid_len`` (a 0-d tensor) on are masked."""
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
         bias: Optional[torch.Tensor], softcap: float = 0.0,
         scale: Optional[float] = None) -> torch.Tensor:
    """q: (b, s, h, d); k/v: (b, t, kv, d). GQA via head grouping. fp32 softmax.

    On DTensors whose kv heads are split over the mesh (a decode cache laid
    out by ``kv_heads``), each rank attends with its own heads and rows under
    ``local_map``: the grouped products fold (b, kv) into one dim, and
    DTensor cannot fold two split dims."""
    if _is_dtensor(k) and any(p.is_shard(2) for p in k.placements):
        return _sdpa_on_shards(q, k, v, bias, softcap, scale)
    return _sdpa(q, k, v, bias, softcap, scale)


def _sdpa_on_shards(q, k, v, bias, softcap, scale):
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    pl = [p if p.is_shard(0) or p.is_shard(2) else Replicate() for p in k.placements]
    return local_map(lambda ql, kl, vl, bl: _sdpa(ql, kl, vl, bl, softcap, scale),
                     out_placements=pl, in_placements=(pl, pl, pl, None),
                     device_mesh=k.device_mesh, redistribute_inputs=True)(q, k, v, bias)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          bias: Optional[torch.Tensor], softcap: float = 0.0,
          scale: Optional[float] = None) -> torch.Tensor:
    b, s, h, d = q.shape
    kvh = k.shape[2]
    group = h // kvh
    qg = gather_dims(q, (2,), unit=kvh).reshape(b, s, kvh, group, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    scores = scores / math.sqrt(d) if scale is None else scores * scale
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    if bias is not None:
        scores = scores + bias     # (s, t) broadcast over (b, k, g)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return gather_dims(out, (-1,), unit=1).reshape(b, s, h, d)


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: int, softcap: float,
           scale: Optional[float] = None) -> torch.Tensor:
    """(b, s, heads, d) in and out, through the flash op on head-major views
    (the kernel takes strides: no transpose copies on the card).

    On DTensors (a step on a mesh) the op runs under ``local_map``: each
    rank calls it on its own shard, batch over the batch axes and heads over
    the model axis, as the reference's partitioner splits the attention.
    Where the kv heads do not divide over the model axis, k and v are
    repeated to one head a query head first, so that every rank's query
    heads find their kv heads in its own shard."""
    mesh = ambient_mesh()
    if mesh is None or not _is_dtensor(q):
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal, window=window, softcap=softcap, scale=scale)
        return out.transpose(1, 2)
    return _flash_local(q, k, v, mesh, causal=causal, window=window, softcap=softcap,
                        scale=scale)


def _heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(b, s, n * hd) -> (b, s, n, hd)."""
    return gather_dims(t, (-1,), unit=n).reshape(t.shape[0], t.shape[1], n, hd)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(b, s, n, hd) -> (b, s, n * hd), with hd gathered first where it is
    sharded (a shard of the inner dim of a merge is strided, and DTensor
    cannot price its redistribution on fake tensors)."""
    b, s, n, hd = t.shape
    return gather_dims(t, (-1,), unit=1).reshape(b, s, n * hd)


def _is_dtensor(x: torch.Tensor) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _flash_local(q, k, v, mesh, *, causal: bool, window: int, softcap: float,
                 scale: Optional[float] = None):
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import axes_to_pspec, even_placements, rules_for
    h, kvh = q.shape[2], k.shape[2]
    # (b, s, h, d): batch on its axes, heads on the model axis, where they divide
    pq = even_placements(q.shape, axes_to_pspec(("batch", None, "heads"), rules_for()),
                         mesh)
    heads_over = 1
    for i, p in enumerate(pq):
        if isinstance(p, Shard) and p.dim == 2:
            heads_over *= mesh.size(i)
    if kvh % heads_over:
        # k and v whole over the heads' mesh dims, split as q is elsewhere
        kv = [Replicate() if isinstance(p, Shard) and p.dim == 2 else p for p in pq]
        k = k.redistribute(mesh, kv).repeat_interleave(h // kvh, dim=2)
        v = v.redistribute(mesh, kv).repeat_interleave(h // kvh, dim=2)

    def local(ql, kl, vl):
        out = flash_attention(ql.transpose(1, 2), kl.transpose(1, 2), vl.transpose(1, 2),
                              causal=causal, window=window, softcap=softcap, scale=scale)
        return out.transpose(1, 2)

    pq = list(pq)      # a list is one output's placements, a tuple several outputs'
    return local_map(local, out_placements=pq, in_placements=(pq, pq, pq),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


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
    q = lc(dense(x, params["wq"], params.get("bq")), ("batch", "seq", "qkv"))
    k = lc(dense(src, params["wk"], params.get("bk")), ("batch", "seq", "qkv"))
    v = lc(dense(src, params["wv"], params.get("bv")), ("batch", "seq", "qkv"))
    q, k, v = _heads(q, h, hd), _heads(k, kv, hd), _heads(v, kv, hd)
    if kv_source is None:
        if use_rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        out = _flash(q, k, v, causal=causal, window=window, softcap=cfg.logit_softcap)
    else:
        out = _flash(q, k, v, causal=False, window=0, softcap=cfg.logit_softcap)
    out = lc(_merge_heads(out), ("batch", "seq", "qkv"))
    return dense(out, params["wo"])


def attention_prefill(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, *, window: int = 0,
                      scale: Optional[float] = None
                      ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Like :func:`attention` but also returns (k, v) for the KV cache."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = _heads(dense(x, params["wq"], params.get("bq")), h, hd)
    k = _heads(dense(x, params["wk"], params.get("bk")), kv, hd)
    v = _heads(dense(x, params["wv"], params.get("bv")), kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = _flash(q, k, v, causal=True, window=window, softcap=cfg.logit_softcap, scale=scale)
    out = dense(_merge_heads(out), params["wo"])
    k = lc(k, ("batch", "kv_seq", "kv_heads", "head_dim"))
    v = lc(v, ("batch", "kv_seq", "kv_heads", "head_dim"))
    return out, (k, v)


def attention_decode(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos: torch.Tensor,
                     *, window: int = 0, scale: Optional[float] = None
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode against a (b, S, kv, hd) cache.

    ``pos`` is the index of the new token (the same for the whole batch), a
    0-d int32 tensor on the device, as the reference's scalar array: the
    step reads it only on the device, so a captured graph replays it at
    every position.  The new k and v are written into the cache in place
    (the reference's ``dynamic_update_slice``, which XLA also applies in
    place); the same tensors are returned.
    """
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    S = cache_k.shape[1]
    q = _heads(dense(x, params["wq"], params.get("bq")), h, hd)
    k_new = _heads(dense(x, params["wk"], params.get("bk")), kvh, hd)
    v_new = _heads(dense(x, params["wv"], params.get("bv")), kvh, hd)
    posv = pos.view(1)
    q = apply_rope(q, posv, cfg.rope_theta)
    k_new = apply_rope(k_new, posv, cfg.rope_theta)
    row = posv.long()
    _write_row(cache_k, k_new, row)
    _write_row(cache_v, v_new, row)
    with region("attn.core"):
        k_pos = torch.arange(S, dtype=torch.int32, device=x.device)
        bias = _mask_bias(posv, k_pos, causal=True, window=window,
                          k_valid_len=pos + 1)
        out = sdpa(q, cache_k, cache_v, bias, cfg.logit_softcap, scale)
    out = dense(_merge_heads(out), params["wo"])
    return out, (cache_k, cache_v)


def _write_row(cache: torch.Tensor, new: torch.Tensor, row: torch.Tensor) -> None:
    """``cache[:, row] = new`` in place: (b, S, kv, hd) and (b, 1, kv, hd),
    ``row`` a one-element int64 tensor on the device.

    A DTensor cache (a step on a mesh: DTensor has no rule for
    ``index_copy_``) is written on each rank's shard under ``local_map``;
    one whose S is split over ranks (a batch too small to split) by a
    select over its rows, elementwise on each rank's shard."""
    new = new.to(cache.dtype)
    if not _is_dtensor(cache):
        cache.index_copy_(1, row, new)
        return
    from torch.distributed.tensor.experimental import local_map
    pl = list(cache.placements)
    if any(p.is_shard(1) for p in pl):
        here = torch.arange(cache.shape[1], device=row.device) == row
        cache.copy_(torch.where(here.view(1, -1, 1, 1), new, cache))
        return
    local_map(lambda c, v, i: c.index_copy_(1, i, v), out_placements=pl,
              in_placements=(pl, pl, None), device_mesh=cache.device_mesh,
              redistribute_inputs=True)(cache, new, row)
