"""The yardstick of the published Zamba2: the operations a prefill needs,
from the configuration's keys alone, counted by :mod:`yardstick`'s rules
(products only: 2 m k n a product; norms, the conv, gates, RoPE and softmax
not counted; attention 4 d an unmasked (query, key) pair; the head at the
last position only).

Frozen with the benchmark.  Per token:

* each Mamba2 layer: ``in_proj`` (d to z, x, B, C, dt) and ``out_proj``
  (d_inner to d), and the scan's products at the published chunk length:
  within a chunk of l, C_i . B_j over the l (l + 1) / 2 causal pairs of
  each group and their sum over x over the same pairs of each head; across
  chunks, each position's read of the state (C_t, heads x headdim x state)
  and its write into it (B_t x_t, the same);
* at each application point, the shared block: q, k, v (2d to heads x head
  dim), o, ``gate_up`` (d to 2 x intermediate) with the point's adapter (d
  to rank to 2 x intermediate), ``down`` and the point's linear (d to d);
  and its causal attention (:func:`yardstick.attn_flops`).
"""
from __future__ import annotations

from typing import Mapping

import yardstick as Y


def mamba_proj_flops_per_token(cfg: Mapping) -> float:
    d = cfg["hidden_size"]
    d_inner = cfg["mamba_expand"] * d
    gn = cfg["mamba_ngroups"] * cfg["mamba_d_state"]
    return 2.0 * d * (2 * d_inner + 2 * gn + cfg["n_mamba_heads"]) + 2.0 * d_inner * d


def scan_flops(cfg: Mapping, s: int) -> float:
    """One sequence of s tokens through one layer's chunked scan."""
    h, p, n, g = (cfg["n_mamba_heads"], cfg["mamba_headdim"], cfg["mamba_d_state"],
                  cfg["mamba_ngroups"])
    chunk = cfg["chunk_size"]
    pairs = sum(l * (l + 1) // 2 for l in
                [chunk] * (s // chunk) + ([s % chunk] if s % chunk else []))
    return pairs * (2.0 * n * g + 2.0 * p * h) + s * 2 * (2.0 * h * p * n)


def shared_flops_per_token(cfg: Mapping) -> float:
    d, f, r = cfg["hidden_size"], cfg["intermediate_size"], cfg["adapter_rank"]
    a = cfg["attention_hidden_size"]
    hd = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    kv = cfg["num_key_value_heads"] * cfg["attention_head_dim"]
    return (2.0 * a * (hd + 2 * kv) + 2.0 * hd * d + 2.0 * d * 2 * f
            + 2.0 * r * (d + 2 * f) + 2.0 * f * d + 2.0 * d * d)


def prefill_flops(cfg: Mapping, b: int, s: int) -> float:
    """A causal prefill of b prompts of s tokens, the head at the last
    position only."""
    layers, points = cfg["num_hidden_layers"], len(cfg["hybrid_layer_ids"])
    mamba = layers * (b * s * mamba_proj_flops_per_token(cfg) + b * scan_flops(cfg, s))
    shared = points * (b * s * shared_flops_per_token(cfg) + Y.attn_flops(
        b, cfg["num_attention_heads"], s, s, cfg["attention_head_dim"], True))
    return mamba + shared + b * 2.0 * cfg["hidden_size"] * cfg["vocab_size"]
