"""Model zoo of the port: the paper's LeNet and the dense decoder LM."""
from __future__ import annotations

from typing import Optional

from repro_torch.config import ModelConfig, ShardingConfig
from repro_torch.models.layers import spec_param_count


def build_model(cfg: ModelConfig, sharding: Optional[ShardingConfig] = None, **kw):
    """The model object of ``cfg``'s family (``kw`` goes to LeNet).  Of the
    sharding config only ``remat_policy`` is read, by the LM."""
    if cfg.family == "dense":
        from repro_torch.models.transformer import DecoderLM
        return DecoderLM(cfg, sharding)
    if cfg.family == "conv":
        from repro_torch.models.lenet import LeNet
        return LeNet(cfg, **kw)
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet")


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic parameter count (``ModelConfig.param_count`` calls this)."""
    if cfg.family == "dense":
        from repro_torch.models.transformer import DecoderLM
        return spec_param_count(DecoderLM(cfg).param_specs())
    if cfg.family == "conv":
        from repro_torch.models.lenet import param_specs
        return spec_param_count(param_specs(cfg))
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
