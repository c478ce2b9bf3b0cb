"""Mixture-of-Experts FFN: token-choice top-k routing, block-local dispatch.

The port of ``repro.models.moe``, with its parameter names and layouts.
Routing runs per sequence (block) with a per-block capacity
``cap = int(seq * k / E * capacity_factor)`` (capped at the block's tokens,
then floored at 4); a choice past its expert's capacity is dropped.  The
dispatch is sort-based and batched over the block dim: a stable sort of the
(token, choice) pairs by expert gives each its position within its expert,
gathers fill an (b, E, cap, d) buffer, the expert products are batched
einsums over it, and a gather per (token, choice) combines the outputs.
On a mesh the reference's sharding hints (``lc``, ``gather_once``) hold
as they do there; routing, dispatch and combine run on each rank's batch
rows and the expert products on its experts (DTensor has no rule for
``searchsorted``, and would gather the whole batch for the gathers).

The auxiliary load-balance loss follows Switch Transformer (eq. 4-6).

Its stages are the regions ``moe.route`` (the router, the dispatch plan and
the aux loss), ``moe.dispatch``, ``moe.experts`` and ``moe.combine``
(:func:`repro_torch.obs.region`), and its routing is counted
(:mod:`repro_torch.obs.routing`) from the ``filled`` mask.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.distributed.sharding import lc, on_shards
from repro_torch.models.layers import ParamSpec
from repro_torch.obs import region, routing

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


def _dispatch(x: torch.Tensor, gather_idx: torch.Tensor, filled: torch.Tensor, e: int,
              cap: int) -> torch.Tensor:
    """(b, s, d) token rows -> the (b, e, cap, d) expert buffers."""
    b, _, d = x.shape
    xe = torch.gather(x, 1, gather_idx[..., None].expand(b, e * cap, d))
    return (xe * filled[..., None].to(xe.dtype)).reshape(b, e, cap, d)


def _combine(ye: torch.Tensor, slot: torch.Tensor, gate_vals: torch.Tensor,
             k: int) -> torch.Tensor:
    """(b, e * cap, d) expert outputs -> (b, s, d): each token's k slots,
    weighted by their gates, summed."""
    b, ecap, d = ye.shape
    s = slot.shape[1] // k
    vals = torch.gather(ye, 1, slot.clamp(0, ecap - 1)[..., None].expand(b, s * k, d))
    w = gate_vals.reshape(b, s * k, 1).to(vals.dtype)
    return (vals * w).reshape(b, s, k, d).sum(2)


def _expert_ffn(xe: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU on its (b, e, cap, d) buffer rows."""
    g = lc(torch.einsum("becd,edf->becf", xe, w_gate), ("batch", "experts", None, "moe_ffn"))
    u = lc(torch.einsum("becd,edf->becf", xe, w_up), ("batch", "experts", None, "moe_ffn"))
    return torch.einsum("becf,efd->becd", F.silu(g) * u, w_down)


def _experts(xe: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """:func:`_expert_ffn`; on a mesh each rank runs it on its own shard
    under ``local_map`` (DTensor's einsum backward views a non-contiguous
    shard and fails): its batch rows and experts, the weights of its experts
    gathered whole over the fsdp axis, or its slice of the FFN dim where
    ``moe_ffn`` shards that.  A weight's gradient is then a partial sum over
    the ranks that split the batch, and the output (and x's gradient) one
    over the ranks that split the FFN dim."""
    from repro_torch.distributed.sharding import ambient_mesh
    mesh = ambient_mesh()
    from torch.distributed.tensor import DTensor
    if mesh is None or not isinstance(xe, DTensor):
        return _expert_ffn(xe, w_gate, w_up, w_down)
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import axes_to_pspec, even_placements, rules_for
    rules = rules_for()

    def layout(t, axes):
        return list(even_placements(t.shape, axes_to_pspec(axes, rules), mesh))
    px = layout(xe, ("batch", "experts", None, "embed"))
    pin = layout(w_gate, ("experts", None, "moe_ffn"))
    pout = layout(w_down, ("experts", "moe_ffn", None))
    rows = {i for i, p in enumerate(px) if isinstance(p, Shard) and p.dim == 0}
    ffn = {i for i, p in enumerate(pin) if isinstance(p, Shard) and p.dim == 2}

    def partial_over(pl, dims):
        return [Partial() if i in dims else p for i, p in enumerate(pl)]
    return local_map(
        lambda x, wg, wu, wd: _expert_ffn(x, wg, wu, wd),
        out_placements=partial_over(px, ffn), in_placements=(px, pin, pin, pout),
        in_grad_placements=(partial_over(px, ffn), partial_over(pin, rows),
                            partial_over(pin, rows), partial_over(pout, rows)),
        device_mesh=mesh, redistribute_inputs=True)(xe, w_gate, w_up, w_down)


def moe_ffn(params: Dict, cfg: ModelConfig, x: torch.Tensor,
            capacity_factor: float = CAPACITY_FACTOR, gather_once: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d) -> (y, aux_loss).  capacity_factor <= 0 => no-drop.

    gather_once: on a mesh, gather the sequence-sharded x once before
    routing, so the dispatch and combine gathers are local, and scatter the
    output back after."""
    if gather_once:
        x = lc(x, ("batch", None, "embed"))
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = _capacity(s, cfg, capacity_factor)
    # on a mesh each rank routes its own rows (the dispatch is block-local;
    # DTensor has no rule for searchsorted)
    rows = ("batch",)
    with region("moe.route"):
        probs, gate_idx, gate_vals, slot, gather_idx, filled = on_shards(
            lambda xb, router: route({"router": router}, cfg, xb, cap), (x, params["router"]),
            (rows, (None, None)), (rows,) * 6)
        aux = aux_loss(probs, gate_idx, e)
    routing.note(filled, e, b * s * k)

    # batched dispatch gather: (b, s, d) -> (b, e, cap, d), and the batched
    # combine: gather each (token, choice)'s slot, weight, sum; on a mesh
    # each rank gathers its own rows (DTensor would gather the whole batch)
    with region("moe.dispatch"):
        xe = on_shards(lambda xb, ib, fb: _dispatch(xb, ib, fb, e, cap),
                       (x, gather_idx, filled), (rows,) * 3, (rows,))
        xe = lc(xe, ("batch", "experts", None, "embed"))
    with region("moe.experts"):
        ye = _experts(xe, params["w_gate"], params["w_up"], params["w_down"])
        ye = lc(ye, ("batch", "experts", None, "embed")).reshape(b, e * cap, d)
    with region("moe.combine"):
        out = on_shards(lambda yb, sb, gb: _combine(yb, sb, gb, k), (ye, slot, gate_vals),
                        (rows,) * 3, (rows,))
    if gather_once:
        out = lc(out, ("batch", "act_seq", "embed"))   # reduce-scatter back
    return out, aux.float()
