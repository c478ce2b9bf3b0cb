"""Step functions: one training step, one prefill and one decode step.

The port of ``repro.runtime.steps``: the single source of truth for the
train/prefill/decode step functions, their abstract inputs and their
shardings, used by the trainer and
:class:`~repro_torch.runtime.server.Server` (which compile their steps with
:meth:`StepBundle.jit`, CUDA graphs on the card), the dry-run
(``launch/dryrun.py``) and the capture frontend
(:func:`repro_torch.core.capture.capture_bundle`, :meth:`StepBundle.lower`),
which traces a step whole.  A step is a plain function.

On a mesh (a ``DeviceMesh`` over the default process group) the state and
the batches are DTensors laid out by the logical rules
(:mod:`repro_torch.distributed.sharding`), and the step runs under those
rules and ``implicit_replication`` (a plain tensor the model makes, a
position or a mask, is the same on every rank), so every ``lc`` in the
models redistributes as the reference's sharding constraints do.  Each
rank runs the same program on its shards.

The training step's gradients.  The parameters are stacked on a leading
(L, ...) layer axis, as the reference keeps them.  Autograd through
``params[...][idx]`` would give each layer's gradient back as a zero tensor
of the whole stack with one slot filled, one such tensor a layer and a
parameter, so the step hands the model one leaf per layer instead: a detached view of that layer's slot, whose
``.grad`` is the matching slot of the step's gradient buffer.  Autograd
accumulates into an existing ``.grad`` in place, so each layer's gradient
is written once, into its slot.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import torch

from repro_torch.config import RunConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (axes_to_pspec, distribute, even_placements,
                                              logical_rules, use_rules, zip_axes)
from repro_torch.models import build_model
from repro_torch.optim import (TrainState, abstract_state, adamw_update, init_state,
                               state_axes, tree_leaves, tree_map, warmup_cosine)
from repro_torch.runtime.jit import GraphPool, Jitted, jit


@dataclass
class StepBundle:
    """A step function, its abstract inputs (``meta`` tensors: global
    shapes and dtypes, no storage) and, on a mesh, the layout of its inputs
    and outputs: trees of ``(mesh, placements)`` pairs (the reference's
    ``NamedSharding`` trees), the metrics replicated; and the arguments
    the step's caller gives up (the reference's ``donate_argnums``)."""
    fn: Callable
    abstract_inputs: Tuple[Any, ...]
    in_shardings: Optional[Tuple[Any, ...]] = None
    out_shardings: Optional[Any] = None
    mesh: Any = None
    donate_argnums: Tuple[int, ...] = ()

    def lower(self, name: str = "step", device: Any = None):
        """The step traced whole from its abstract inputs (fake tensors on
        ``device``, default cuda): the port's counterpart of lowering, a
        :class:`~repro_torch.core.capture.Captured` program."""
        from repro_torch.core.capture import capture_bundle
        return capture_bundle(self, name=name, device=device)

    def jit(self, pool: Optional[GraphPool] = None) -> Jitted:
        """The step compiled (:func:`repro_torch.runtime.jit.jit`): a CUDA
        graph per input signature on the card, the donated arguments
        written over in place; ``pool`` shares a graph pool with other
        compiled steps."""
        return jit(self.fn, self.donate_argnums, pool)


def run_rules(run_cfg: RunConfig, model):
    """The logical rules of one run: the mesh's and sharding config's, the
    model's overrides, and the batch replicated where it does not divide."""
    rules = logical_rules(run_cfg.mesh, run_cfg.sharding)
    rules.update(model.logical_overrides(run_cfg.mesh))
    mesh_cfg = run_cfg.mesh
    # batch divisibility: long_500k (batch=1) can't shard batch over data —
    # replicate batch and turn on sequence-parallel caches instead
    batch_ax = rules.get("batch")
    if batch_ax is not None:
        axes = (batch_ax,) if isinstance(batch_ax, str) else batch_ax
        div = 1
        for a in axes:
            div *= mesh_cfg.axis_size(a)
        if run_cfg.shape.global_batch % max(div, 1) != 0:
            rules["batch"] = None
            rules["kv_seq"] = "data"
    return rules


def _ambient(fn: Callable, rules, mesh) -> Callable:
    """``fn`` under the rules and mesh (nothing without a mesh)."""
    if mesh is None:
        return fn

    @functools.wraps(fn)
    def wrapped(*args):
        from torch.distributed.tensor.experimental import implicit_replication
        with use_rules(rules, mesh), implicit_replication():
            return fn(*args)
    return wrapped


def _layout(shapes: Any, axes: Any, rules, mesh) -> Any:
    """The ``(mesh, placements)`` of every tensor of ``shapes`` (a tree of
    meta tensors) by its logical axes.  A 0-d tensor (the decode position)
    has none: it stays a plain tensor, the same on every rank."""
    def one(t, a):
        if not isinstance(t, torch.Tensor) or t.dim() == 0:
            return None
        return mesh, even_placements(t.shape, axes_to_pspec(a, rules), mesh)
    return zip_axes(one, shapes, axes)


def _replicated_metrics(metrics: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The metrics as plain tensors, each rank holding the whole value."""
    from torch.distributed.tensor import DTensor
    return {k: v.full_tensor() if isinstance(v, DTensor) else v for k, v in metrics.items()}


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------

def _grad_leaves(params: Mapping[str, Any], grads: Mapping[str, Any]) -> Dict[str, Any]:
    """Leaves over ``params`` whose gradients autograd accumulates into
    ``grads`` in place: one per layer of the stacked ``layers`` tree (a list
    of per-layer trees, which the model reads as it reads the stack), one
    per other tensor."""
    def leaf(p, g):
        x = p.detach().requires_grad_()
        x.grad = g
        return x

    out = {}
    for key, tree in params.items():
        if key == "layers":
            n = tree_leaves(tree)[0].shape[0]
            out[key] = [tree_map(lambda p, g, i=i: leaf(p[i], g[i]), tree, grads[key])
                        for i in range(n)]
        else:
            out[key] = tree_map(leaf, tree, grads[key])
    return out


def loss_and_grads(model, params: Mapping[str, Any], batch: Mapping[str, torch.Tensor],
                   grads: Mapping[str, Any]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The model's loss and metrics on ``batch``, with d loss / d params
    added into ``grads`` (a tree of the params' shapes and dtypes)."""
    with torch.enable_grad():
        loss, metrics = model.loss(_grad_leaves(params, grads), batch)
        loss.backward()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}


def _microbatches(batch: Mapping[str, torch.Tensor], accum: int):
    """``accum`` equal microbatches of the batch's rows: consecutive rows,
    or on a mesh consecutive rows of each rank's shard (so no rank sends a
    row; the step sums over all rows either way)."""
    b = next(iter(batch.values())).shape[0]
    if b % accum:
        raise ValueError(f"batch {b} is not a multiple of accum_steps {accum}")
    return [{k: _rows(v, i, accum) for k, v in batch.items()} for i in range(accum)]


def _rows(t: torch.Tensor, i: int, accum: int) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        n = t.shape[0] // accum
        return t[i * n:(i + 1) * n]
    local = t.to_local()
    n = local.shape[0] // accum
    if local.shape[0] % accum:
        raise ValueError(f"a rank's {local.shape[0]} rows are not {accum} microbatches")
    shape = (t.shape[0] // accum,) + tuple(t.shape[1:])
    stride, step = [], 1
    for d in reversed(shape):          # contiguous, as the local slice is
        stride.insert(0, step)
        step *= d
    return DTensor.from_local(local[i * n:(i + 1) * n], t.device_mesh, t.placements,
                              run_check=False, shape=shape, stride=tuple(stride))


def _step_model(run_cfg: RunConfig):
    """The run's model object.  LeNet's is made without weights (on
    ``meta``): a step takes its params from the state, as an LM's does."""
    if run_cfg.model.family == "conv":
        return build_model(run_cfg.model, device="meta")
    return build_model(run_cfg.model, run_cfg.sharding)


def train_bundle(run_cfg: RunConfig, mesh: Any = None) -> StepBundle:
    """The training step ``fn(state, batch) -> (state, metrics)``: loss and
    gradients (``accum_steps`` microbatches summed in fp32, their metrics
    averaged, as the reference's scan does), then one AdamW update.  The
    update is in place: the state passed in is the state returned, advanced
    (the reference donates it).  On a mesh the state and batch are DTensors
    laid out as ``in_shardings`` says, and the metrics come back replicated."""
    model = _step_model(run_cfg)
    rules = run_rules(run_cfg, model)
    lr_fn = warmup_cosine(run_cfg.train)
    accum = max(run_cfg.train.accum_steps, 1)

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        if accum == 1:
            grads = tree_map(torch.zeros_like, state.params)
            loss, metrics = loss_and_grads(model, state.params, batch, grads)
        else:
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), state.params)
            micro = tree_map(torch.zeros_like, state.params)
            loss = torch.zeros((), dtype=torch.float32, device=state.step.device)
            runs = []
            for i, mb in enumerate(_microbatches(batch, accum)):
                if i:
                    for g in tree_leaves(micro):
                        g.zero_()
                mb_loss, mb_metrics = loss_and_grads(model, state.params, mb, micro)
                for acc, g in zip(tree_leaves(grads), tree_leaves(micro)):
                    acc.add_(g.to(torch.float32) / accum)
                loss = loss + mb_loss / accum
                runs.append(mb_metrics)
            del micro
            metrics = {k: torch.mean(torch.stack([m[k] for m in runs]), dim=0)
                       for k in runs[0]}
        state, opt_metrics = adamw_update(state, grads, run_cfg.train, lr_fn)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return state, _replicated_metrics(metrics)

    batch_specs, batch_axes = model.train_input_specs(run_cfg.shape)
    abstract = abstract_state(model.abstract())
    in_sh = out_sh = None
    if mesh is not None:
        st = state_axes(model.axes())
        state_sh = _layout(abstract._asdict(), st._asdict(), rules, mesh)
        state_sh = TrainState(**dict(state_sh, step=None))   # the step: a plain tensor
        in_sh = (state_sh, _layout(batch_specs, batch_axes, rules, mesh))
        out_sh = (state_sh, None)
    return StepBundle(_ambient(train_step, rules, mesh), (abstract, batch_specs),
                      in_sh, out_sh, mesh, donate_argnums=(0,))


def init_train_state(run_cfg: RunConfig, seed: int = 0,
                     device: Optional[Union[str, torch.device]] = None,
                     mesh: Any = None) -> TrainState:
    """The first training state: the model's random weights from ``seed``,
    drawn on ``device`` (default cuda), fp32 master copies and zero
    moments.  On a mesh every rank draws the same weights and keeps its
    shard of each (laid out by its logical axes) as it is drawn: the rank
    holds at most one whole leaf at a time, as the reference's init jitted
    with out-shardings does."""
    model = _step_model(run_cfg)
    keep = None
    if mesh is not None:
        rules = run_rules(run_cfg, model)
        keep = lambda t, spec: distribute(t, spec.axes, rules, mesh)
    return init_state(model.init(seed=seed, device=resolve_device(device), keep=keep))


# ---------------------------------------------------------------------------
# Serve
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill_step(model, params: Mapping[str, Any],
                 batch: Mapping[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(last-token logits, KV cache) of a prompt batch."""
    return model.prefill(params, batch)


@torch.no_grad()
def decode_step(model, params: Mapping[str, Any], cache: Mapping[str, Any],
                batch: Mapping[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(logits, advanced cache) of one token per sequence; the cache's
    tensors are updated in place."""
    return model.decode_step(params, cache, batch)


def _logits_spec(run_cfg: RunConfig, params_specs: Any) -> torch.Tensor:
    """One step's (b, 1, padded vocab) logits, as a ``meta`` tensor."""
    return torch.empty((run_cfg.shape.global_batch, 1, params_specs["head"].shape[-1]),
                       device="meta")


def prefill_bundle(run_cfg: RunConfig, mesh: Any = None) -> StepBundle:
    """The prefill ``fn(params, batch) -> (last-token logits, cache)``; on a
    mesh the params and prompts are DTensors laid out as ``in_shardings``
    says, and the logits and cache come back as ``out_shardings`` says."""
    model = build_model(run_cfg.model, run_cfg.sharding)
    rules = run_rules(run_cfg, model)
    fn = _ambient(functools.partial(prefill_step, model), rules, mesh)
    params_specs = model.abstract()
    batch_specs, batch_axes = model.prefill_input_specs(run_cfg.shape)
    in_sh = out_sh = None
    if mesh is not None:
        cache_specs, cache_axes, _, _ = model.decode_state_specs(run_cfg.shape)
        in_sh = (_layout(params_specs, model.axes(), rules, mesh),
                 _layout(batch_specs, batch_axes, rules, mesh))
        logits = _logits_spec(run_cfg, params_specs)
        out_sh = (_layout(logits, ("batch", None, "vocab"), rules, mesh),
                  _layout(cache_specs, cache_axes, rules, mesh))
    return StepBundle(fn, (params_specs, batch_specs), in_sh, out_sh, mesh)


def decode_bundle(run_cfg: RunConfig, mesh: Any = None) -> StepBundle:
    """One-token ``fn(params, cache, batch) -> (logits, cache)`` against a
    full-length cache (the decode_* shapes); the cache is donated, as the
    reference's: its K/V are updated in place, and a compiled step writes
    the rest of the new cache (the position, recurrent states) over it."""
    model = build_model(run_cfg.model, run_cfg.sharding)
    rules = run_rules(run_cfg, model)
    fn = _ambient(functools.partial(decode_step, model), rules, mesh)
    params_specs = model.abstract()
    cache_specs, cache_axes, tok_specs, tok_axes = model.decode_state_specs(run_cfg.shape)
    in_sh = out_sh = None
    if mesh is not None:
        cache_sh = _layout(cache_specs, cache_axes, rules, mesh)
        in_sh = (_layout(params_specs, model.axes(), rules, mesh), cache_sh,
                 _layout(tok_specs, tok_axes, rules, mesh))
        logits = _logits_spec(run_cfg, params_specs)
        out_sh = (_layout(logits, ("batch", None, "vocab"), rules, mesh), cache_sh)
    return StepBundle(fn, (params_specs, cache_specs, tok_specs), in_sh, out_sh, mesh,
                      donate_argnums=(1,))


def bundle_for(run_cfg: RunConfig, mesh: Any = None) -> StepBundle:
    """Pick the step kind the shape dictates (train/prefill/decode)."""
    kind = run_cfg.shape.kind
    if kind == "train":
        return train_bundle(run_cfg, mesh)
    if kind == "prefill":
        return prefill_bundle(run_cfg, mesh)
    return decode_bundle(run_cfg, mesh)
