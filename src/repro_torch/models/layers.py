"""Parameter specs and the layers LeNet uses, in PyTorch.

Only what the LeNet slice needs is here: :class:`ParamSpec`, the
``normal``/``zeros`` initializers drawn from an explicit
``torch.Generator``, and :func:`softmax_cross_entropy`.  Layouts follow the
reference package (``repro.models.layers``) so parameters transfer 1:1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros
    scale: float = 1.0
    dtype: Optional[str] = None   # None -> model compute dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


def spec_param_count(specs: Mapping[str, ParamSpec]) -> int:
    """Analytic number of parameters of a flat spec dict."""
    return sum(int(np.prod(s.shape)) for s in specs.values())


def _init_one(spec: ParamSpec, generator: torch.Generator,
              default_dtype: str) -> torch.Tensor:
    dtype = torch_dtype(spec.dtype or default_dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype)
    if spec.init == "normal":
        # the reference's fan-in rule: leading dim for rank >= 2
        fan_in = spec.shape[0] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
        std = spec.scale / np.sqrt(max(fan_in, 1))
        draw = torch.randn(spec.shape, generator=generator, dtype=torch.float32)
        return (draw * std).to(dtype)
    raise ValueError(f"unknown init {spec.init!r}")


def init_params(specs: Mapping[str, ParamSpec], generator: torch.Generator,
                dtype: str = "float32") -> Dict[str, torch.Tensor]:
    """Materialize a flat spec dict on the CPU, in the specs' order.

    ``jax.random`` and ``torch.Generator`` draw different numbers from the
    same seed: to give both packages identical weights, make them with
    numpy and load them with ``repro_torch.models.lenet.params_from_jax``.
    """
    return {name: _init_one(s, generator, dtype) for name, s in specs.items()}


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          label_smoothing: float = 0.0,
                          z_loss: float = 0.0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-level CE with optional z-loss. Returns (loss, z_loss) per row."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    # gather-free true-logit extraction, as the reference does it
    v_iota = torch.arange(logits.shape[-1], device=logits.device)
    true_logit = torch.where(v_iota == labels[..., None], logits,
                             torch.zeros((), device=logits.device)).sum(-1)
    ce = lse - true_logit
    if label_smoothing:
        ce = (1.0 - label_smoothing) * ce + label_smoothing * (
            lse - logits.mean(-1))
    zl = z_loss * lse.square() if z_loss else torch.zeros_like(lse)
    return ce, zl
