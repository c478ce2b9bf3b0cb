"""What the benchmark takes from the program (``repro_torch``): its model
configuration, its kernels' build, and the layout its parameters must have.
Every import of the program is inside a function, so that the reference and
the yardstick load none of it."""
from __future__ import annotations

from typing import Mapping

import torch

import weights as W


def model_config(cfg: Mapping):
    """The port's ``ModelConfig`` of a configuration file (the published
    keys, as the file holds them)."""
    from repro_torch.config import ModelConfig
    moe = bool(cfg.get("num_experts"))
    return ModelConfig(
        name=cfg["name"], family="moe" if moe else "dense",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"], num_kv_heads=cfg["num_key_value_heads"],
        head_dim=W.head_dim(cfg),
        d_ff=cfg["moe_intermediate_size"] if moe else cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], num_experts=cfg.get("num_experts", 0),
        experts_per_token=cfg.get("num_experts_per_tok", 0), rope_theta=cfg["rope_theta"],
        norm_eps=cfg["rms_norm_eps"], qkv_bias=bool(cfg.get("qkv_bias")),
        dtype=cfg["torch_dtype"])


def check_layout(model_cfg, params: Mapping) -> None:
    """Raise unless the benchmark's tree is the port's, leaf for leaf."""
    from repro_torch.models import build_model
    want = W.shapes_of(build_model(model_cfg).abstract())
    got = W.shapes_of(params)
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))
        raise ValueError(f"the benchmark's weights are not the port's tree: {diff[:6]}")


def build_kernels(device) -> None:
    """Compile the port's CUDA kernels into its build directory inside the
    checkout, or find them built there."""
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import build
        build.build()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
