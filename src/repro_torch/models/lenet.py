"""LeNet-5 — the paper's section IV correlation workload, as an ``nn.Module``.

The port of ``repro.models.lenet``: the same parameter names, layouts
(HWIO conv filters, (in, out) FC weights) and dtypes as
``LeNet.param_specs``, NHWC images, and a selectable conv algorithm.  Every
FC product runs through the hand ``tiled_matmul`` kernel on CUDA, as do the
``gemm`` convs; the 3x3 ``winograd`` convs run through ``winograd_tiles``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.tiled_matmul.ops import matmul
from repro_torch.models.conv_algos import conv2d
from repro_torch.models.layers import (ParamSpec, init_params,
                                       softmax_cross_entropy, torch_dtype)

Params = Dict[str, torch.Tensor]


def _pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    k = cfg.conv_kernel
    c1, c2 = cfg.conv_channels
    hw = cfg.image_hw
    # conv1 SAME + pool, conv2 VALID + pool
    h2 = (hw // 2 - (k - 1)) // 2
    flat = h2 * h2 * c2
    f1, f2 = cfg.fc_dims
    return {
        "conv1": ParamSpec((k, k, cfg.image_c, c1), (None, None, "conv_in", "conv_out")),
        "b1": ParamSpec((c1,), ("conv_out",), init="zeros"),
        "conv2": ParamSpec((k, k, c1, c2), (None, None, "conv_in", "conv_out")),
        "b2": ParamSpec((c2,), ("conv_out",), init="zeros"),
        "fc1": ParamSpec((flat, f1), ("fsdp", "ffn")),
        "fb1": ParamSpec((f1,), ("ffn",), init="zeros"),
        "fc2": ParamSpec((f1, f2), ("ffn", "fsdp")),
        "fb2": ParamSpec((f2,), (None,), init="zeros"),
        "fc3": ParamSpec((f2, cfg.num_classes), ("fsdp", "classes")),
        "fb3": ParamSpec((cfg.num_classes,), ("classes",), init="zeros"),
    }


def params_from_jax(params: Mapping[str, np.ndarray],
                    cfg: Optional[ModelConfig] = None) -> Params:
    """The reference package's LeNet parameters (numpy arrays) as the port's.

    Names, layouts and dtypes carry over unchanged; with ``cfg`` every name
    and shape is checked against :func:`param_specs`.  Returns CPU tensors.
    """
    out = {name: torch.from_numpy(np.array(v, copy=True))
           for name, v in params.items()}
    if cfg is not None:
        specs = param_specs(cfg)
        if set(out) != set(specs):
            raise KeyError(f"parameter names {sorted(out)} != {sorted(specs)}")
        dtype = torch_dtype(cfg.dtype)
        for name, spec in specs.items():
            t = out[name]
            if tuple(t.shape) != spec.shape or t.dtype != dtype:
                raise ValueError(f"{name}: got {tuple(t.shape)} {t.dtype}, "
                                 f"expected {spec.shape} {dtype}")
    return out


class LeNet(nn.Module):
    def __init__(self, cfg: ModelConfig, conv_algo: str = "implicit",
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.conv_algo = conv_algo
        self.device = resolve_device(device)
        init = init_params(self.param_specs(), torch.Generator().manual_seed(seed),
                           cfg.dtype)
        self.params = nn.ParameterDict(
            {k: nn.Parameter(v.to(self.device)) for k, v in init.items()})

    def param_specs(self) -> Dict[str, ParamSpec]:
        return param_specs(self.cfg)

    def axes(self) -> Dict[str, Tuple[Optional[str], ...]]:
        return {k: s.axes for k, s in self.param_specs().items()}

    def logical_overrides(self, mesh_cfg) -> Dict[str, object]:
        return {}

    def load_jax_params(self, params: Mapping[str, np.ndarray]) -> None:
        """Load the reference package's parameters (see :func:`params_from_jax`)."""
        with torch.no_grad():
            for name, t in params_from_jax(params, self.cfg).items():
                self.params[name].copy_(t)

    def param_dict(self) -> Params:
        """The parameters as detached tensors sharing their storage, for
        functional steps (:func:`sgd_step`)."""
        return {k: v.detach() for k, v in self.params.items()}

    def logits(self, params: Mapping[str, torch.Tensor],
               images: torch.Tensor) -> torch.Tensor:
        """Logits of ``images`` (b, hw, hw, c) under ``params`` (the
        reference model's ``apply``)."""
        x = images.to(torch_dtype(self.cfg.dtype))
        x = F.relu(conv2d(x, params["conv1"], self.conv_algo, "SAME") + params["b1"])
        x = _pool(x)
        x = F.relu(conv2d(x, params["conv2"], self.conv_algo, "VALID") + params["b2"])
        x = _pool(x)
        x = x.reshape(x.shape[0], -1)
        x = F.relu(matmul(x, params["fc1"]) + params["fb1"])
        x = F.relu(matmul(x, params["fc2"]) + params["fb2"])
        return matmul(x, params["fc3"]) + params["fb3"]

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.logits(dict(self.params), images)

    def abstract(self) -> Dict[str, torch.Tensor]:
        """The parameters as ``meta`` tensors: shapes and dtypes, no storage."""
        dtype = torch_dtype(self.cfg.dtype)
        return {k: torch.empty(s.shape, dtype=dtype, device="meta")
                for k, s in self.param_specs().items()}

    def train_input_specs(self, shape: ShapeConfig
                          ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Tuple[str, ...]]]:
        """The train batch as ``meta`` tensors, and its logical axes (the
        reference model's)."""
        cfg, b = self.cfg, shape.global_batch
        specs = {"images": torch.empty((b, cfg.image_hw, cfg.image_hw, cfg.image_c),
                                       dtype=torch.float32, device="meta"),
                 "labels": torch.empty((b,), dtype=torch.int32, device="meta")}
        axes = {"images": ("batch", "spatial", "spatial", "conv_in"), "labels": ("batch",)}
        return specs, axes

    def loss(self, params: Mapping[str, torch.Tensor], batch: Mapping[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean cross entropy, and the metrics, of a batch {"images",
        "labels"} (the reference model's signature, which
        :func:`repro_torch.runtime.steps.train_bundle` calls)."""
        images, labels = batch["images"], batch["labels"]
        logits = self.logits(params, images)
        ce, _ = softmax_cross_entropy(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        return ce.mean(), {"ce": ce.mean(), "accuracy": acc}


def sgd_step(model: LeNet, params: Mapping[str, torch.Tensor],
             images: torch.Tensor, labels: torch.Tensor, lr: float = 0.05
             ) -> Tuple[Params, torch.Tensor, torch.Tensor]:
    """One functional SGD step: (new params, loss, accuracy).

    The same function trains the model eagerly and is traced whole
    (forward, ``torch.autograd.grad``, update) by the capture frontend.
    """
    live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss, metrics = model.loss(live, {"images": images, "labels": labels})
    grads = torch.autograd.grad(loss, list(live.values()))
    new = {k: (p - lr * g).detach() for (k, p), g in zip(live.items(), grads)}
    return new, loss.detach(), metrics["accuracy"].detach()
