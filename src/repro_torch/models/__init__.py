"""Model zoo of the port: one model class per family, as in the reference.

Every LM exposes ``param_specs``/``init``/``abstract``, ``loss`` (train),
``prefill``/``decode_step`` (serving) and ``train_input_specs``/
``prefill_input_specs``; LeNet has its own interface.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.config import ModelConfig, ShardingConfig
from repro_torch.models.layers import spec_param_count


def build_model(cfg: ModelConfig, sharding: Optional[ShardingConfig] = None, **kw):
    """The model object of ``cfg``'s family (``kw`` goes to LeNet).  Of the
    sharding config only ``remat_policy`` is read, by the LMs."""
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models.transformer import DecoderLM
        return DecoderLM(cfg, sharding)
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import HybridLM
        return HybridLM(cfg, sharding)
    if cfg.family == "zamba2":
        from repro_torch.models.zamba2 import Zamba2LM
        return Zamba2LM(cfg, sharding)
    if cfg.family == "ssm":
        from repro_torch.models.rwkv_model import RWKVLM
        return RWKVLM(cfg, sharding)
    if cfg.family in ("encdec", "audio"):
        from repro_torch.models.encdec import EncDecLM
        return EncDecLM(cfg, sharding)
    if cfg.family == "conv":
        from repro_torch.models.lenet import LeNet
        return LeNet(cfg, **kw)
    raise ValueError(f"no model for family {cfg.family!r}")


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic parameter count (``ModelConfig.param_count`` calls this);
    with ``active_only`` the expert tensors count at the fraction of experts
    a token uses."""
    if cfg.family == "conv":
        from repro_torch.models.lenet import param_specs
        return spec_param_count(param_specs(cfg))
    frac = 1.0
    if active_only and cfg.num_experts:
        frac = cfg.experts_per_token / cfg.num_experts
    return spec_param_count(build_model(cfg).param_specs(), active_expert_frac=frac)
