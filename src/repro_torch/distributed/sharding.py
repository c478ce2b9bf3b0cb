"""Logical-axis sharding rules (MaxText-style), on DTensor.

The port of ``repro.distributed.sharding``.  Models annotate parameters and
activations with *logical* axis names ("batch", "qkv", "ffn", "experts",
...).  A rule table maps logical names to mesh axes; the mapping depends on
ShardingConfig (fsdp on/off, SP decode, pod role) so one model definition
serves every parallelism layout.  The rule tables are plain Python, kept
identical to the reference's.

Where the reference hands a ``PartitionSpec`` to ``NamedSharding``, the
port turns it into DTensor placements over a ``DeviceMesh``
(:func:`placements`): ``Shard(dim)`` on each mesh dim a tensor dim names,
``Replicate()`` on the rest.  :func:`lc` is the counterpart of
``with_sharding_constraint``: under the ambient rules and mesh installed by
:func:`use_rules` it redistributes a DTensor to the rule's placements;
without them (or on a plain tensor) it is the identity.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.config import MeshConfig, ShardingConfig

MeshAxes = Union[None, str, Tuple[str, ...]]
Rules = Dict[str, MeshAxes]


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name, or
    a tuple of mesh axis names (the dim split over their product), as
    ``jax.sharding.PartitionSpec`` holds them."""

    def __new__(cls, *entries: MeshAxes):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------

def logical_rules(mesh_cfg: MeshConfig, sharding: ShardingConfig) -> Rules:
    """Build the logical->mesh mapping for one run."""
    pod_is_data = mesh_cfg.is_multi_pod and mesh_cfg.pod_role == "data"
    batch_axes: MeshAxes = ("pod", "data") if pod_is_data else "data"
    fsdp_axes: MeshAxes = "data" if sharding.fsdp else None

    rules: Rules = {
        # --- activation axes ---
        "batch": batch_axes,
        "seq": None,
        # Megatron-style sequence sharding of the residual stream between
        # blocks (AG on block entry / RS on block exit) — divides saved-for-
        # backward activation memory by the model-axis size
        "act_seq": "model" if sharding.sequence_sharding else None,
        "kv_seq": "data" if sharding.sequence_parallel_decode else None,
        "embed": None,                # activation d_model dim stays replicated
        "qkv": "model",               # flattened heads*head_dim activation dim
        "heads": "model",
        "ffn": "model",
        "moe_ffn": "model" if not sharding.expert_parallel else None,
        "vocab": "model",
        "classes": None,
        # --- parameter-only axes ---
        "fsdp": fsdp_axes,            # weight input-dim shard (ZeRO-3 style)
        "embed_tbl": fsdp_axes if sharding.shard_embed_over == "data" else "model",
        "experts": "model" if sharding.expert_parallel else None,
        "exp_cap": "data",            # MoE capacity slots over the data axis
        "layers": None,
        "stages": "pod" if (mesh_cfg.is_multi_pod and mesh_cfg.pod_role == "pipeline") else None,
        # --- conv / misc ---
        "conv_in": None, "conv_out": None, "spatial": None,
        "state": None, "ssm_heads": "model", "frontend_seq": None,
    }
    rules.update(dict(sharding.extra_rules))

    # prune mesh axes that don't exist in this mesh (e.g. "pod" on single pod)
    def prune(ax: MeshAxes) -> MeshAxes:
        if ax is None:
            return None
        if isinstance(ax, str):
            return ax if ax in mesh_cfg.axis_names else None
        kept = tuple(a for a in ax if a in mesh_cfg.axis_names)
        return kept if kept else None
    return {k: prune(v) for k, v in rules.items()}


def axes_to_pspec(axes: Sequence[Optional[str]], rules: Rules) -> PartitionSpec:
    """Map a tuple of logical axis names (or None) to a PartitionSpec.

    A mesh axis may appear at most once in a PartitionSpec; later duplicates
    degrade to replication (standard logical-axis-rules behaviour).
    """
    used: set = set()
    out: List[MeshAxes] = []
    for name in axes:
        ax = rules.get(name) if name is not None else None
        if ax is None:
            out.append(None)
            continue
        ax_t = (ax,) if isinstance(ax, str) else tuple(ax)
        ax_t = tuple(a for a in ax_t if a not in used)
        if not ax_t:
            out.append(None)
            continue
        used.update(ax_t)
        out.append(ax_t[0] if len(ax_t) == 1 else ax_t)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def placements(spec: Sequence[MeshAxes], mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where tensor dim ``d`` names that mesh axis, else
    ``Replicate()``.  A dim split over several mesh axes shards on each of
    them, major axis first, as ``NamedSharding`` lays such a dim out."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out: List[Any] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in ((entry,) if isinstance(entry, str) else entry):
            if ax in names:
                out[names.index(ax)] = Shard(dim)
    return tuple(out)


def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def map_axes(fn, axes_tree: Any) -> Any:
    """``fn`` over the logical-axes tuples of a tree of dicts (and lists)."""
    if _is_axes(axes_tree):
        return fn(axes_tree)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v) for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(map_axes(fn, v) for v in axes_tree)
    return fn(axes_tree)


def param_shardings(axes_tree: Any, rules: Rules, mesh) -> Any:
    """Map a tree of logical-axes tuples to ``(mesh, placements)`` pairs."""
    return map_axes(lambda axes: (mesh, placements(axes_to_pspec(axes, rules), mesh)),
                    axes_tree)


# ---------------------------------------------------------------------------
# Ambient rules for activation constraints inside a step
# ---------------------------------------------------------------------------

class _Ambient:
    """The rules and mesh of the step being run.  Process-wide, where the
    reference keeps them per thread: on CUDA autograd runs the backward, and
    with it every layer's recompute, on a device thread of its own."""
    rules: Optional[Rules] = None
    mesh: Optional[Any] = None


_AMBIENT = _Ambient()


@contextmanager
def use_rules(rules: Rules, mesh: Optional[Any] = None):
    prev = (_AMBIENT.rules, _AMBIENT.mesh)
    _AMBIENT.rules, _AMBIENT.mesh = rules, mesh
    try:
        yield
    finally:
        _AMBIENT.rules, _AMBIENT.mesh = prev


def rules_for() -> Optional[Rules]:
    return _AMBIENT.rules


def ambient_mesh() -> Optional[Any]:
    """The mesh :func:`use_rules` installed, or None."""
    return _AMBIENT.mesh if _AMBIENT.rules is not None else None


def lc(x, axes: Sequence[Optional[str]]):
    """Apply a logical sharding constraint if rules are ambient, else no-op.

    Safe to call unconditionally from model code: in smoke tests (no mesh) it
    is the identity, and so it is on a plain tensor.  On a DTensor it
    redistributes to the rule's placements (gathers, reduce-scatters or
    all-to-alls as the move needs).  A dim whose size does not divide by its
    mesh axes is left replicated: DTensor would pad it unevenly, and XLA
    treats such a constraint as a hint.
    """
    rules = _AMBIENT.rules
    mesh = _AMBIENT.mesh
    if rules is None or mesh is None:
        return x   # constraints are meaningful only under an explicit mesh
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = axes_to_pspec(axes, rules)
    if all(s is None for s in spec):
        return x
    return x.redistribute(mesh, even_placements(x.shape, spec, mesh))


def even_placements(shape: Sequence[int], spec: Sequence[MeshAxes], mesh) -> Tuple[Any, ...]:
    """:func:`placements` with every shard of a dim that its mesh axes do
    not divide evenly dropped to replication, and with every mesh dim of
    size 1 replicated (it splits nothing, and DTensor refuses some views of
    a dim it calls split)."""
    names = mesh.mesh_dim_names
    kept = []
    for dim, entry in enumerate(spec):
        if entry is None or dim >= len(shape):
            kept.append(None)
            continue
        axes = tuple(ax for ax in ((entry,) if isinstance(entry, str) else entry)
                     if ax in names and mesh.size(names.index(ax)) > 1)
        n = 1
        for ax in axes:
            n *= mesh.size(names.index(ax))
        kept.append(axes if axes and shape[dim] % n == 0 else None)
    return placements(kept, mesh)


def shard_box(shape: Sequence[int], mesh, pl: Sequence[Any],
              coord: Sequence[int]) -> Tuple[slice, ...]:
    """The slices of a tensor of ``shape`` that the rank at mesh coordinate
    ``coord`` holds under placements ``pl`` (``Shard`` and ``Replicate``):
    a dim split over several mesh dims is chunked over each in turn, major
    first, in chunks of ``ceil(n / k)``, as DTensor chunks it."""
    box = [(0, int(n)) for n in shape]
    for i, p in enumerate(pl):
        if p.is_replicate():
            continue
        if not p.is_shard():
            raise ValueError(f"no box for placement {p}")
        d = p.dim % len(box)
        lo, hi = box[d]
        step = -(-(hi - lo) // mesh.size(i))
        a = min(lo + coord[i] * step, hi)
        box[d] = (a, min(a + step, hi))
    return tuple(slice(a, b) for a, b in box)


def from_full(t: torch.Tensor, mesh, pl: Sequence[Any],
              device: Optional[Union[str, torch.device]] = None):
    """``t`` (the same full tensor on every rank) as a DTensor on ``mesh``
    with placements ``pl``: each rank copies its own box to ``device``
    (default ``t``'s) and nothing is sent.  Only a rank whose box is all of
    ``t``, on that device already, keeps ``t`` itself as its shard."""
    from torch.distributed.tensor import DTensor
    box = shard_box(t.shape, mesh, pl, mesh.get_coordinate())
    part = t[box]
    dev = t.device if device is None else torch.device(device)
    with torch.no_grad():
        here = t.device.type == dev.type and dev.index in (None, t.device.index)
        if part.shape == t.shape and here and t.is_contiguous():
            local = t.detach()
        else:
            local = torch.empty(part.shape, dtype=t.dtype, device=dev).copy_(part)
        stride = [1] * t.ndim
        for d in range(t.ndim - 2, -1, -1):
            stride[d] = stride[d + 1] * t.shape[d + 1]
        out = DTensor.from_local(local, mesh, tuple(pl), run_check=False,
                                 shape=t.shape, stride=tuple(stride))
    return out.requires_grad_(t.requires_grad)


def distribute(t: torch.Tensor, axes: Sequence[Optional[str]], rules: Rules, mesh):
    """``t`` (the same full tensor on every rank) as a DTensor laid out by
    its logical axes: each rank keeps a copy of its shard, nothing is sent."""
    spec = axes_to_pspec(axes, rules)
    return from_full(t, mesh, even_placements(t.shape, spec, mesh))


def empty(shape: Sequence[int], axes: Sequence[Optional[str]], *,
          dtype: torch.dtype, device: Union[str, torch.device]) -> torch.Tensor:
    """An uninitialized buffer (a prefill's KV cache) laid out by its
    logical axes under the ambient rules and mesh: a DTensor there, a plain
    tensor without them."""
    rules, mesh = _AMBIENT.rules, _AMBIENT.mesh
    if rules is None or mesh is None:
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    from torch.distributed.tensor import empty as dt_empty
    return dt_empty(*shape, dtype=dtype, device_mesh=mesh,
                    placements=even_placements(shape, axes_to_pspec(axes, rules), mesh))


def gather_dims(x, dims: Optional[Sequence[int]] = None, unit: Optional[int] = None):
    """A DTensor with its dims ``dims`` whole on every rank (differentiably):
    each mesh dim that shards one of them is gathered, unless ``unit`` is
    given and the mesh dim's size divides it (the dim is about to be viewed
    as units of ``unit``, which each such shard holds whole).  ``dims``
    None: every dim, and any partial sum reduced.  Anything else as it is.

    For a view DTensor cannot make of a split dim (a merge or a split of
    it), a sum of scalars reduced two ways, or a product that folds two
    split dims (the (b, s) of an activation: DTensor cannot price the
    strided shard such a fold makes on fake tensors)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    if dims is None:
        return x.redistribute(mesh, [Replicate()] * mesh.ndim)
    want = {d % x.ndim for d in dims}
    pl = [Replicate() if isinstance(p, Shard) and p.dim % x.ndim in want
          and (unit is None or unit % mesh.size(i)) else p
          for i, p in enumerate(x.placements)]
    return x if pl == list(x.placements) else x.redistribute(mesh, pl)


def inner_dims(x) -> range:
    """The dims of ``x`` between its first and its last (the sequence dim
    of a (b, s, d) activation)."""
    return range(1, x.ndim - 1)


class _WholeGrad(torch.autograd.Function):
    """The identity, whose backward gathers the gradient's dims ``dims``
    (None: its inner dims) as :func:`gather_dims` does with ``unit``."""

    @staticmethod
    def forward(ctx, x, dims, unit):
        ctx.dims, ctx.unit = dims, unit
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        dims = inner_dims(grad) if ctx.dims is None else ctx.dims
        return gather_dims(grad, dims, unit=ctx.unit), None, None


def whole_grad(y, dims: Optional[Sequence[int]] = None, unit: Optional[int] = None):
    """``y``, with its gradient's dims ``dims`` (default its inner dims)
    gathered as :func:`gather_dims` gathers them (on a DTensor; a plain
    tensor as it is): the output of a product, whose gradient a
    sequence-split residual would otherwise hand back split, or of a merge
    of dims, whose backward splits the gradient again (``unit``: into how
    many parts)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(y, DTensor) or not torch.is_grad_enabled() or not y.requires_grad:
        return y
    return _WholeGrad.apply(y, None if dims is None else tuple(dims), unit)


class _SumOverGroup(torch.autograd.Function):
    """The sum of ``x`` over a process group's ranks, every rank getting it
    (a functional all-reduce, so a trace records it).  The gradient passes
    as it is: each rank's copy of the sum feeds the same loss."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def vocab_parallel_ce(logits, labels, label_smoothing: float = 0.0, z_loss: float = 0.0):
    """Per-row (ce, z-loss) of logits split over one mesh dim along the
    vocab (a DTensor), each rank on its own vocab slice: the max and the
    sum of exponentials and the true logit are reduced over that dim's
    group, so no rank gathers the vocab (Megatron's vocab-parallel cross
    entropy; XLA partitions the reference's the same way).  None where it
    does not apply (a plain tensor, the vocab not split over exactly one
    mesh dim, label smoothing): the caller computes it whole."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(logits, DTensor) or label_smoothing:
        return None
    mesh = logits.device_mesh
    last = logits.ndim - 1
    split = [i for i, p in enumerate(logits.placements)
             if isinstance(p, Shard) and p.dim % logits.ndim == last]
    if len(split) != 1:
        return None
    vdim = split[0]
    lg_pl = [Replicate() if p.is_partial() else p for p in logits.placements]
    rows = [Replicate() if i == vdim else p for i, p in enumerate(lg_pl)]
    if any(isinstance(p, Shard) and p.dim % logits.ndim == last for p in rows):
        return None
    group = mesh.get_group(vdim)
    n = mesh.size(vdim)
    vocab = logits.shape[-1]
    if vocab % n:
        return None
    offset = mesh.get_local_rank(vdim) * (vocab // n)

    def local(lg, lb):
        import torch.distributed._functional_collectives as funcol
        lg = lg.float()
        m = funcol.wait_tensor(funcol.all_reduce(lg.detach().amax(-1), "max", group))
        lse = m + torch.log(_SumOverGroup.apply(torch.exp(lg - m[..., None]).sum(-1), group))
        v_iota = torch.arange(lg.shape[-1], device=lg.device) + offset
        true = torch.where(v_iota == lb[..., None], lg,
                           torch.zeros((), device=lg.device)).sum(-1)
        ce = lse - _SumOverGroup.apply(true, group)
        zl = z_loss * lse.square() if z_loss else torch.zeros_like(lse)
        return ce, zl

    from torch.distributed.tensor.experimental import local_map
    return local_map(local, out_placements=(rows, rows), in_placements=(lg_pl, rows),
                     device_mesh=mesh, redistribute_inputs=True)(logits, labels)


def embed_rows(table, tokens):
    """``table[tokens]``.  On a mesh each rank looks up its own rows of
    tokens in its slice of the table's width (DTensor would gather every
    rank's tokens first): the output is split as the tokens' rows are and
    as the table's width is; the table's gradient is a partial sum over the
    ranks that split the rows.  A mesh dim that splits both is used for the
    rows, with the table gathered over it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(table, DTensor) or not isinstance(tokens, DTensor):
        return table[tokens]
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    rows = [p.is_shard(0) for p in tokens.placements]
    t_in, t_grad, tok_in, out = [], [], [], []
    for i, p in enumerate(table.placements):
        if rows[i]:
            t_in.append(Replicate())
            t_grad.append(Partial())
            tok_in.append(Shard(0))
            out.append(Shard(0))
        elif p.is_shard(1):
            t_in.append(Shard(1))
            t_grad.append(Shard(1))
            tok_in.append(Replicate())
            out.append(Shard(tokens.ndim))
        else:
            t_in.append(Replicate())
            t_grad.append(Replicate())
            tok_in.append(Replicate())
            out.append(Replicate())
    return local_map(lambda t, ids: t[ids], out_placements=out, in_placements=(t_in, tok_in),
                     in_grad_placements=(t_grad, tok_in), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def zip_axes(fn, tree: Any, axes: Any) -> Any:
    """``fn(leaf, its axes)`` over a tree of dicts (``None`` subtrees stay)."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: zip_axes(fn, v, axes[k]) for k, v in tree.items()}
    return fn(tree, axes)


def place(tree: Any, axes: Any, rules, mesh) -> Any:
    """A tree of full tensors (the same on every rank) as DTensors laid out
    by their logical axes on ``mesh``: each rank keeps its shard and nothing
    is sent.  Ints and ``None`` subtrees pass through."""
    return zip_axes(lambda t, a: distribute(t, a, rules, mesh)
                    if isinstance(t, torch.Tensor) else t, tree, axes)


def on_shards(fn, args: Sequence[torch.Tensor], arg_axes: Sequence[Sequence[Optional[str]]],
              out_axes: Sequence[Sequence[Optional[str]]]):
    """``fn(*args)`` run by each rank on its own shard of every arg, laid
    out by its logical axes (a mesh dim splits the same logical axis of
    every arg that has it, or none), its outputs laid out by ``out_axes``:
    for work that is independent per batch row and head but folds the two
    (a chunked scan), which DTensor cannot do.  Each output must carry
    every logical axis the mesh splits.  An arg that lacks one (a weight
    without a batch axis, the heads' shared input) is whole on those
    ranks, and its gradient is a partial sum over them.  Outside a mesh, a
    plain call."""
    rules, mesh = _AMBIENT.rules, _AMBIENT.mesh
    from torch.distributed.tensor import DTensor
    if rules is None or mesh is None or not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    # a plain tensor (a zero state the model made) is the same on every rank
    args = [a if isinstance(a, DTensor) else DTensor.from_local(
        a, mesh, [Replicate()] * mesh.ndim, run_check=False) for a in args]
    split: Dict[int, str] = {}
    whole: set = set()
    for a, ax in zip(args, arg_axes):
        pl = even_placements(a.shape, axes_to_pspec(ax, rules), mesh)
        spec = axes_to_pspec(ax, rules)
        for dim, name in enumerate(ax):
            if name is None or dim >= len(spec) or spec[dim] is None:
                continue
            for i, p in enumerate(pl):
                if mesh.mesh_dim_names[i] in ((spec[dim],) if isinstance(spec[dim], str)
                                              else spec[dim]):
                    if isinstance(p, Shard) and split.get(i, name) == name:
                        split[i] = name
                    else:
                        whole.add(i)
    split = {i: n for i, n in split.items() if i not in whole}

    def lay(ax):
        return [Shard(list(ax).index(split[i])) if i in split and split[i] in ax
                else Replicate() for i in range(mesh.ndim)]
    ins = tuple(lay(ax) for ax in arg_axes)
    grads = tuple([Partial() if i in split and split[i] not in ax else p
                   for i, p in enumerate(pl)] for pl, ax in zip(ins, arg_axes))
    outs = tuple(lay(ax) for ax in out_axes)
    return local_map(fn, out_placements=outs if len(outs) > 1 else outs[0], in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)
