"""Serving step functions: one prefill and one decode step of a model.

The port of ``repro.runtime.steps.prefill_bundle``/``decode_bundle`` without
meshes or shardings (those come with ``repro_torch.distributed``).  PyTorch
runs eagerly, so a step is a plain function: :class:`~repro_torch.runtime.
server.Server` calls it directly and the capture frontend traces it whole.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch


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
