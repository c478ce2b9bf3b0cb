"""Mixture-of-Experts FFN: token-choice top-k routing, block-local dispatch.

The port of ``repro.models.moe``, with its parameter names and layouts.
Routing runs per sequence (block) with a per-block capacity
``cap = int(seq * k / E * capacity_factor)`` (capped at the block's tokens,
then floored at 4); a choice past its expert's capacity is dropped.  The
dispatch is sort-based and batched over the block dim: a stable sort of the
(token, choice) pairs by expert gives each its position within its expert,
gathers fill an (b, E, cap, d) buffer, the expert products are batched
einsums over it, and a gather per (token, choice) combines the outputs.
The reference's sharding hints (``lc``, ``gather_once``) have no
counterpart on one device.

The auxiliary load-balance loss follows Switch Transformer (eq. 4-6).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.layers import ParamSpec

CAPACITY_FACTOR = 1.25


def moe_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": ParamSpec((d, e), ("fsdp", None), scale=0.1),
        "w_gate": ParamSpec((e, d, f), ("experts", "fsdp", "moe_ffn")),
        "w_up": ParamSpec((e, d, f), ("experts", "fsdp", "moe_ffn")),
        "w_down": ParamSpec((e, f, d), ("experts", "moe_ffn", "fsdp")),
    }


def _capacity(tokens: int, cfg: ModelConfig, factor: float) -> int:
    if factor <= 0:          # exact/no-drop capacity: an expert can receive at
        return tokens        # most one slot per token in the block
    cap = int(tokens * cfg.experts_per_token * factor / cfg.num_experts)
    return max(min(cap, tokens), 4)


def route(params: Dict, cfg: ModelConfig, x: torch.Tensor, cap: int):
    """The router and the dispatch plan of a (b, s, d) block batch.

    Returns (probs (b, s, e) fp32, gate_idx (b, s, k), gate_vals (b, s, k)
    renormalized with the dropped choices' gates zeroed, slot (b, s*k): the
    buffer slot of each (token, choice) in token-major order, ``e * cap``
    for a dropped one, gather_idx and filled (b, e * cap): the token each
    buffer slot holds and whether it holds one).
    """
    b, s, _ = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    dev = x.device
    logits = torch.einsum("bsd,de->bse", x.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)                          # (b, s, e)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)             # (b, s, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # block-local sort-based capacity dispatch
    flat_e = gate_idx.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)             # (b, s*k)
    se = torch.gather(flat_e, 1, order)
    stok = torch.div(order, k, rounding_mode="floor")              # token of each
    # position within its expert's segment (per block)
    experts = torch.arange(e, device=dev).repeat(b, 1)
    seg_start = torch.searchsorted(se, experts)                    # (b, e)
    pos = torch.arange(s * k, device=dev)[None] - torch.gather(seg_start, 1, se)
    keep = pos < cap
    slot_sorted = torch.where(keep, se * cap + pos, torch.full_like(se, e * cap))
    # scatter into e*cap + 1 columns: the last one takes every dropped
    # choice, and is cut off (the reference's ``.at[...].set(mode="drop")``)
    gather_idx = torch.zeros((b, e * cap + 1), dtype=torch.long, device=dev).scatter_(
        1, slot_sorted, stok)[:, :-1]
    filled = torch.zeros((b, e * cap + 1), dtype=torch.bool, device=dev).scatter_(
        1, slot_sorted, torch.ones_like(keep))[:, :-1]
    # invert the sort: the slot of each original (token, choice)
    slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    gate_vals = gate_vals * (slot.reshape(b, s, k) < e * cap).to(gate_vals.dtype)
    return probs, gate_idx, gate_vals, slot, gather_idx, filled


def aux_loss(probs: torch.Tensor, gate_idx: torch.Tensor, num_experts: int
             ) -> torch.Tensor:
    """The Switch load-balance loss from a block-local bincount."""
    b, s, k = gate_idx.shape
    counts = torch.zeros((b, num_experts), dtype=torch.float32, device=probs.device)
    counts = counts.scatter_add(1, gate_idx.reshape(b, s * k),
                                torch.ones((b, s * k), device=probs.device)) / s
    return num_experts * torch.mean(counts.mean(0) * probs.mean((0, 1)))


def moe_ffn(params: Dict, cfg: ModelConfig, x: torch.Tensor,
            capacity_factor: float = CAPACITY_FACTOR
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d) -> (y, aux_loss).  capacity_factor <= 0 => no-drop."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = _capacity(s, cfg, capacity_factor)
    probs, gate_idx, gate_vals, slot, gather_idx, filled = route(params, cfg, x, cap)
    aux = aux_loss(probs, gate_idx, e)

    # batched dispatch gather: (b, s, d) -> (b, e, cap, d)
    xe = torch.gather(x, 1, gather_idx[..., None].expand(b, e * cap, d))
    xe = (xe * filled[..., None].to(xe.dtype)).reshape(b, e, cap, d)
    g = torch.einsum("becd,edf->becf", xe, params["w_gate"])
    u = torch.einsum("becd,edf->becf", xe, params["w_up"])
    ye = torch.einsum("becf,efd->becd", F.silu(g) * u, params["w_down"])
    ye = ye.reshape(b, e * cap, d)

    # batched combine: gather each (token, choice)'s slot, weight, sum
    vals = torch.gather(ye, 1, slot.clamp(0, e * cap - 1)[..., None].expand(b, s * k, d))
    w = gate_vals.reshape(b, s * k, 1).to(vals.dtype)
    out = (vals * w).reshape(b, s, k, d).sum(2)
    return out, aux.float()
