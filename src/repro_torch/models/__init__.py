"""Model zoo of the port.  This slice carries the paper's LeNet only."""
from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.models.layers import spec_param_count


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic parameter count (``ModelConfig.param_count`` calls this)."""
    if cfg.family != "conv":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    from repro_torch.models.lenet import param_specs
    return spec_param_count(param_specs(cfg))
