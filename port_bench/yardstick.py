"""The benchmark's yardstick: the H100's peaks and the operations and bytes
that a model step or a kernel call needs, computed from shapes alone.

Frozen with the benchmark, so that no change to the program can move it.
The counting rules:

* a product of an (m, k) and a (k, n) matrix is 2 m k n operations; norms,
  rotary embeddings, softmax and other elementwise work are not counted;
* attention counts 4 d operations (q.k and p.v) for every (query, key)
  pair that its masks let through, not the pairs a kernel computes;
* a mixture of experts counts each token's ``experts_per_token`` experts
  and its router, not the capacity buffer's empty slots;
* a prefill counts the head at its last position only (the one it returns);
* a training step counts the forward's products three times (the forward
  and the two products of each backward) and no recompute;
* a kernel's bytes are each input read once and each output written once.
"""
from __future__ import annotations

from typing import Mapping

#: data-sheet peaks of one H100 SXM, dense, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def attn_pairs(s: int, t: int, causal: bool, window: int = 0) -> int:
    """(query, key) pairs of one head that the masks let through: query q
    (0-based, aligned with key 0) sees keys up to q when causal, and keys
    within ``window`` of it when a window is set."""
    pairs = 0
    for qp in range(s):
        hi = min(qp + 1, t) if causal else t
        lo = max(0, qp - window + 1) if window > 0 else 0
        pairs += max(hi - lo, 0)
    return pairs


def attn_flops(b: int, h: int, s: int, t: int, d: int, causal: bool,
               window: int = 0) -> float:
    """4 d operations (q.k and p.v) for every pair the masks let through."""
    return 4.0 * b * h * attn_pairs(s, t, causal, window) * d


def flash_fwd_bytes(b: int, h: int, kv: int, s: int, t: int, d: int,
                    itemsize: int = 2) -> float:
    """q and o of (b, h, s, d), k and v of (b, kv, t, d): each read or
    written once."""
    return float(itemsize * (2 * b * h * s * d + 2 * b * kv * t * d))


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the memory's rate."""
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


def flash_fwd_bound_s(b: int, h: int, kv: int, s: int, t: int, d: int,
                      causal: bool = True, window: int = 0, itemsize: int = 2,
                      peak: float = PEAK_BF16_FLOPS) -> float:
    """One flash-attention forward call's bound."""
    return bound_s(attn_flops(b, h, s, t, d, causal, window),
                   flash_fwd_bytes(b, h, kv, s, t, d, itemsize), peak)


def _dims(cfg: Mapping) -> tuple:
    d = cfg["hidden_size"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // h
    return d, h, kv, hd


def _ffn_flops_per_token(cfg: Mapping) -> float:
    d = cfg["hidden_size"]
    if cfg.get("num_experts"):
        e, k, f = cfg["num_experts"], cfg["num_experts_per_tok"], cfg["moe_intermediate_size"]
        return 2.0 * d * e + k * 3 * 2.0 * d * f
    return 3 * 2.0 * d * cfg["intermediate_size"]


def layer_dense_flops_per_token(cfg: Mapping) -> float:
    """One layer's products of one token, attention's scores aside: the
    q, k, v and o projections and the FFN (or the router and the token's
    experts)."""
    d, h, kv, hd = _dims(cfg)
    proj = 2.0 * d * (h + 2 * kv) * hd + 2.0 * h * hd * d
    return proj + _ffn_flops_per_token(cfg)


def head_flops_per_token(cfg: Mapping) -> float:
    return 2.0 * cfg["hidden_size"] * cfg["vocab_size"]


def prefill_flops(cfg: Mapping, b: int, s: int) -> float:
    """A causal prefill of b prompts of s tokens, the head at the last
    position only."""
    d, h, kv, hd = _dims(cfg)
    layers = cfg["num_hidden_layers"]
    per_layer = b * s * layer_dense_flops_per_token(cfg) + attn_flops(b, h, s, s, hd, True)
    return layers * per_layer + b * head_flops_per_token(cfg)


def decode_step_flops(cfg: Mapping, b: int, pos: int) -> float:
    """One decode step of b sequences whose new token sits at ``pos``
    (0-based): it attends to the pos + 1 keys up to and including itself."""
    d, h, kv, hd = _dims(cfg)
    layers = cfg["num_hidden_layers"]
    per_layer = b * layer_dense_flops_per_token(cfg) + 4.0 * b * h * (pos + 1) * hd
    return layers * per_layer + b * head_flops_per_token(cfg)


def generate_decode_flops(cfg: Mapping, b: int, prompt: int, new_tokens: int) -> float:
    """The decode steps of one call that serves ``new_tokens`` tokens
    after a prompt of ``prompt``: the first token comes from the prefill,
    each later one from a step whose input sits at prompt, prompt + 1, ..."""
    return sum(decode_step_flops(cfg, b, prompt + i) for i in range(new_tokens - 1))


def train_step_flops(cfg: Mapping, b: int, s: int) -> float:
    """A training step on b sequences of s tokens: three times the forward's
    products (the head at every position), with no recompute."""
    d, h, kv, hd = _dims(cfg)
    layers = cfg["num_hidden_layers"]
    n = b * s
    fwd = (layers * (n * layer_dense_flops_per_token(cfg) + attn_flops(b, h, s, s, hd, True))
           + n * head_flops_per_token(cfg))
    return 3.0 * fwd
