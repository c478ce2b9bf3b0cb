"""Pipeline parallelism over the ``pod`` axis (GPipe schedule, a ring
permute between stages).

The port of ``repro.distributed.pipeline``.  The multi-pod mesh's ``pod``
axis can act as pure DP (default) or as a pipeline: stage s holds layers
[s*L/S, (s+1)*L/S); microbatches flow through a ring permute.  The schedule
runs T = M + S - 1 ticks; stage 0 injects microbatch t at tick t; the last
stage emits outputs from tick S-1 on (the GPipe bubble = (S-1)/T).

The permute is the ``repro_torch::ring_permute`` op (point-to-point sends
over the axis's process group), differentiable: its backward is the
reverse ring, the transposed ``ppermute`` of the reference.  So
``pipeline_apply`` composes with autograd as the reference composes with
``jax.grad``, and a captured trace shows each tick's permute as one node.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.optim import tree_map


def _shift(x: torch.Tensor, group_name: str, shift: int) -> torch.Tensor:
    """``x`` of the rank ``shift`` places before this one in the group's
    ring (this rank's ``x`` goes ``shift`` places on)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    group = _resolve_process_group(group_name)
    n = dist.get_world_size(group)
    if n == 1 or shift % n == 0:
        return x.clone()
    me = dist.get_group_rank(group, dist.get_rank())
    send = dist.get_global_rank(group, (me + shift) % n)
    recv = dist.get_global_rank(group, (me - shift) % n)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, send, group), dist.P2POp(dist.irecv, out, recv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


@torch.library.custom_op("repro_torch::ring_permute", mutates_args=())
def ring_permute(x: torch.Tensor, group_name: str, shift: int) -> torch.Tensor:
    """Send ``x`` ``shift`` places on along the ring of the process group
    named ``group_name``; return what the rank ``shift`` places back sent."""
    return _shift(x, group_name, shift)


@ring_permute.register_fake
def _(x, group_name, shift):
    return torch.empty_like(x)


def _permute_context(ctx, inputs, output):
    ctx.group_name, ctx.shift = inputs[1], inputs[2]


def _permute_backward(ctx, grad):
    return ring_permute(grad, ctx.group_name, -ctx.shift), None, None


ring_permute.register_autograd(_permute_backward, setup_context=_permute_context)


class _Replicated(torch.autograd.Function):
    """The forward's value as every rank of ``group`` has it already (the
    last stage's outputs, summed over the axis).  Its gradient is the
    loss's gradient, which every rank computes alike, passed on as it is."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _StageSlice(torch.autograd.Function):
    """This rank's stage slice of a stacked (S, ...) leaf that every rank
    holds whole.  The backward gathers every stage's slice gradient, so each
    rank ends with the whole leaf's gradient, as the reference's
    ``jax.grad`` gives it."""

    @staticmethod
    def forward(ctx, p, sid, group):
        ctx.group = group
        return p[sid].clone()

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        n = dist.get_world_size(ctx.group)
        out = torch.empty((n * grad.numel(),), dtype=grad.dtype, device=grad.device)
        dist.all_gather_into_tensor(out, grad.reshape(-1), group=ctx.group)
        return out.reshape((n,) + tuple(grad.shape)), None, None


def pipeline_apply(stage_fn: Callable, stage_params: Any, x_micro: torch.Tensor,
                   *, mesh, axis: str = "pod") -> torch.Tensor:
    """Run microbatches through a stage pipeline.

    stage_fn(params_leaf_slice, x) -> y, same shape as x.
    stage_params: tree with leading dim S (stages) on every leaf, the same
    on every rank.
    x_micro: (M, b, ...) microbatched input (the same on every rank).
    Returns (M, b, ...) outputs (the same on every rank).  Every rank of the
    mesh calls it; each runs the stage its place on ``axis`` names.
    """
    group = mesh.get_group(axis)
    S = mesh.size(mesh.mesh_dim_names.index(axis))
    sid = mesh.get_local_rank(axis)
    M = x_micro.shape[0]
    T = M + S - 1
    params_local = tree_map(lambda p: _StageSlice.apply(p, sid, group), stage_params)
    # every rank runs the same program, as the reference's SPMD body does
    # (the stage id only selects values): so each rank's backward runs the
    # same reverse permutes in the same order as every other rank's
    is_first = torch.tensor(sid == 0, device=x_micro.device)
    is_last = torch.tensor(sid == S - 1, device=x_micro.device)
    state = torch.zeros_like(x_micro[0])
    outs = []
    for t in range(T):
        x_in = torch.where(is_first, x_micro[min(t, M - 1)], state)
        y = stage_fn(params_local, x_in)
        if t >= S - 1:                   # the last stage emits microbatch t-(S-1)
            outs.append(torch.where(is_last, y, torch.zeros_like(y)))
        state = ring_permute(y, group.group_name, 1)
    # broadcast the last stage's outputs to every group member
    return _Replicated.apply(torch.stack(outs), group)
