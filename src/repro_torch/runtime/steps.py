"""Step functions: one training step, one prefill and one decode step.

The port of ``repro.runtime.steps`` without meshes or shardings (those wait
for the port's distributed layer, ROADMAP A5: a mesh raises
``NotImplementedError``).  PyTorch runs eagerly, so a step is a plain
function: the trainer and :class:`~repro_torch.runtime.server.Server` call
it directly, and the capture frontend traces it whole
(:func:`repro_torch.core.capture.capture_bundle`).

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

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import torch

from repro_torch.config import RunConfig
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.optim import (TrainState, abstract_state, adamw_update, init_state,
                               tree_leaves, tree_map, warmup_cosine)

#: the message of every mesh refusal
MESH_WAITS = ("meshes and shardings wait for the port's distributed layer "
              "(ROADMAP A5); run without a mesh")


@dataclass
class StepBundle:
    """A step function and its abstract inputs (``meta`` tensors: shapes
    and dtypes, no storage), the reference's ``StepBundle`` without
    shardings."""
    fn: Callable
    abstract_inputs: Tuple[Any, ...]


def _no_mesh(mesh: Any) -> None:
    if mesh is not None:
        raise NotImplementedError(MESH_WAITS)


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
    b = next(iter(batch.values())).shape[0]
    if b % accum:
        raise ValueError(f"batch {b} is not a multiple of accum_steps {accum}")
    n = b // accum
    return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()} for i in range(accum)]


def train_bundle(run_cfg: RunConfig, mesh: Any = None) -> StepBundle:
    """The training step ``fn(state, batch) -> (state, metrics)``: loss and
    gradients (``accum_steps`` microbatches summed in fp32, their metrics
    averaged, as the reference's scan does), then one AdamW update.  The
    update is in place: the state passed in is the state returned, advanced
    (the reference donates it)."""
    _no_mesh(mesh)
    model = build_model(run_cfg.model, run_cfg.sharding)
    lr_fn = warmup_cosine(run_cfg.train)
    accum = max(run_cfg.train.accum_steps, 1)

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        if accum == 1:
            grads = tree_map(torch.zeros_like, state.params)
            loss, metrics = loss_and_grads(model, state.params, batch, grads)
        else:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), state.params)
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
        return state, metrics

    batch_specs, _ = model.train_input_specs(run_cfg.shape)
    return StepBundle(train_step, (abstract_state(model.abstract()), batch_specs))


def init_train_state(run_cfg: RunConfig, seed: int = 0,
                     device: Optional[Union[str, torch.device]] = None,
                     mesh: Any = None) -> TrainState:
    """The first training state: the model's random weights from ``seed``,
    drawn on ``device`` (default cuda), fp32 master copies and zero
    moments."""
    _no_mesh(mesh)
    model = build_model(run_cfg.model, run_cfg.sharding)
    return init_state(model.init(seed=seed, device=resolve_device(device)))


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
