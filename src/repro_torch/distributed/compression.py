"""Gradient compression for data-parallel reduction.

The port of ``repro.distributed.compression``.  int8 all-gather
reduction: each rank quantizes its local gradient to int8 with a per-tensor
fp32 scale, all-gathers the (int8, scale) pairs over one mesh dim's process
group, and dequantize-sums locally.  Link payload vs a bf16 all-reduce: AG
moves (g-1)/g * size_int8 where AR moves 2(g-1)/g * size_bf16 -> ~4x less
traffic, at a quantization error bounded by max|g|/254 per element.

Error feedback (residual carried into the next step) removes the systematic
bias; the residual tensor lives in the training state when enabled.

Where the reference runs inside ``shard_map`` over a mesh axis name, these
functions take the mesh and the axis and run on each rank's local tensor.
``torch.round`` rounds half to even, as ``jnp.round`` does, so the
quantization is bit-exact with the reference's.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.optim import tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    xf = x.to(torch.float32)
    scale = torch.max(torch.abs(xf)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum_mean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Mean-reduce this rank's ``x`` over the ranks of ``mesh``'s ``axis``
    with an int8 payload: an all-gather of the int8 tensor (1/2 the bf16
    bytes, 1/4 the fp32 bytes) and of the g scales, then a dequantize-sum in
    fp32.  Every rank of the mesh calls it; each gets the mean of its own
    group."""
    import torch.distributed as dist
    group = mesh.get_group(axis)
    g = dist.get_world_size(group)
    q, scale = quantize_int8(x)
    qs = torch.empty((g * q.numel(),), dtype=torch.int8, device=q.device)
    scales = torch.empty((g,), dtype=torch.float32, device=q.device)
    dist.all_gather_into_tensor(qs, q.reshape(-1), group=group)
    dist.all_gather_into_tensor(scales, scale.reshape(1), group=group)
    qs = qs.reshape((g,) + tuple(q.shape))              # (g, ...) int8 payload
    total = torch.tensordot(scales, qs.to(torch.float32), dims=([0], [0]))
    return (total / g).to(x.dtype)


def compressed_grad_mean(grads: Any, mesh, axis: str = "data",
                         errors: Optional[Any] = None
                         ) -> Tuple[Any, Optional[Any]]:
    """DP gradient mean with int8 compression (+ optional error feedback).

    grads: a tree of this rank's *local* gradients.  With error feedback,
    pass the residual tree; returns (reduced grads, new residuals).
    """
    if errors is None:
        return tree_map(lambda g: compressed_psum_mean(g, mesh, axis), grads), None
    g_in = tree_map(lambda g, e: g + e, grads, errors)
    reduced = tree_map(lambda g: compressed_psum_mean(g, mesh, axis), g_in)
    return reduced, tree_map(lambda g, r: g - r, g_in, reduced)
