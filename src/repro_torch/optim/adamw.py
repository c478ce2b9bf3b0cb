"""AdamW with fp32 master weights (mixed-precision training).

The port of ``repro.optim.adamw``.  The state is the reference's
``TrainState`` (step, compute-dtype params, fp32 master, m and v, as trees
of tensors with the parameters' layout), so a state crosses between the two
packages leaf for leaf (:func:`repro_torch.models.transformer.state_from_jax`)
and a checkpoint either one writes, the other restores.

Where the reference builds a new state and donates the old buffers to it,
:func:`adamw_update` updates master, m, v and the params in place: at
qwen1.5-4b's 3.95 B parameters an out-of-place update would need another
47 GB of device memory.  Each tensor is walked in flat chunks of
``CHUNK`` elements, so the update's transients are a few fp32 copies of one
chunk, and within a chunk the arithmetic runs in the reference's order
(every product and sum rounded where the reference rounds it).  The step,
the learning rate, the clipping scale and the bias corrections stay 0-d
tensors on the state's device: the update never waits for the host.

On a mesh the trees hold DTensors, and the update walks each rank's local
shards (a gradient first laid out as its parameter is).  The global norm
sums every shard's squares once: over the mesh dims a leaf is sharded on,
its ranks' partial sums add up; over the dims it is replicated on, each
rank already holds the whole sum.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Tuple

import torch

from repro_torch.config import TrainConfig

#: elements of one chunk of the in-place update (64 MB of fp32)
CHUNK = 1 << 24


class TrainState(NamedTuple):
    step: torch.Tensor         # () int32
    params: Any                # compute-dtype (bf16) tree
    master: Any                # fp32 master copy
    m: Any                     # fp32 first moment
    v: Any                     # fp32 second moment


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, in the reference's order (keys
    sorted, as ``jax.tree.leaves`` orders a dict)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of trees of its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def state_axes(param_axes: Any) -> TrainState:
    """Logical axes tree matching the TrainState structure."""
    return TrainState((), param_axes, param_axes, param_axes, param_axes)


def _is_dtensor(t: Any) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def init_state(params: Any) -> TrainState:
    """The first state: fp32 copies of the params (copies even where a
    param is fp32 already: the update writes the master in place) and zero
    moments, on the params' device (DTensors laid out as the params are,
    for DTensor params)."""
    first = tree_leaves(params)[0]
    master = tree_map(lambda p: p.to(torch.float32, copy=True), params)
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return TrainState(torch.zeros((), dtype=torch.int32, device=first.device), params,
                      master, tree_map(zeros, params), tree_map(zeros, params))


def abstract_state(abstract_params: Any) -> TrainState:
    """A state of ``meta`` tensors over a tree of (meta) params: shapes and
    dtypes only (the reference's ``abstract_state``)."""
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    return TrainState(torch.empty((), dtype=torch.int32, device="meta"), abstract_params,
                      tree_map(f32, abstract_params), tree_map(f32, abstract_params),
                      tree_map(f32, abstract_params))


def _chunks(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """Flat views of ``t`` of at most ``CHUNK`` elements each."""
    if not t.is_contiguous():
        raise ValueError("the in-place update walks contiguous tensors only; got "
                         f"strides {t.stride()} for shape {tuple(t.shape)}")
    return iter(t.view(-1).split(CHUNK))


def _square_sum(t: torch.Tensor) -> torch.Tensor:
    sq = None
    for c in _chunks(t):
        part = torch.sum(torch.square(c.to(torch.float32)))
        sq = part if sq is None else sq + part
    return sq


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every element's square, in fp32 (chunked, so no
    fp32 copy of a whole bf16 tensor is made).  Over DTensor leaves the
    shards' sums are added over the mesh dims each leaf is sharded on, one
    reduction for all leaves of a layout."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    sq = None
    parts: Dict[Any, torch.Tensor] = {}
    for g in tree_leaves(tree):
        if _is_dtensor(g):
            layout = (g.device_mesh, tuple(Replicate() if p.is_replicate() else Partial()
                                           for p in g.placements))
            part = _square_sum(g.to_local())
            parts[layout] = part if layout not in parts else parts[layout] + part
            continue
        part = _square_sum(g)
        sq = part if sq is None else sq + part
    for (mesh, pl), part in parts.items():
        part = DTensor.from_local(part, mesh, pl, run_check=False).full_tensor()
        sq = part if sq is None else sq + part
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(state: TrainState, grads: Any, cfg: TrainConfig,
                 lr_fn: Callable) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One AdamW step on ``state``, in place: its master, m, v and params
    are overwritten, and the returned state holds those same trees with the
    step advanced.  ``grads`` has the params' tree (any float dtype)."""
    gnorm = global_norm(grads)
    if cfg.grad_clip:
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    step = state.step + 1
    lr = lr_fn(step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf

    leaves = zip(tree_leaves(grads), tree_leaves(state.master), tree_leaves(state.m),
                 tree_leaves(state.v), tree_leaves(state.params))
    for g, master, m, v, p in leaves:
        if _is_dtensor(p):
            if g.placements != p.placements:
                g = g.redistribute(p.device_mesh, p.placements)
            g, master, m, v, p = (t.to_local() for t in (g, master, m, v, p))
        for gc, mac, mc, vc, pc in zip(*map(_chunks, (g, master, m, v, p))):
            gc = gc.to(torch.float32) * scale
            mc.mul_(b1).add_(gc * (1 - b1))
            vc.mul_(b2).add_(torch.square(gc).mul_(1 - b2))
            mhat = mc / bc1
            vhat = vc / bc2
            upd = mhat.div_(vhat.sqrt_().add_(cfg.eps)).add_(cfg.weight_decay * mac)
            mac.sub_(upd.mul_(lr))
            pc.copy_(mac)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return TrainState(step, state.params, state.master, state.m, state.v), metrics
