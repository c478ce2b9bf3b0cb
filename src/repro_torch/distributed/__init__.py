"""The port's distributed layer: meshes, logical sharding rules on DTensor,
int8 gradient compression and the GPipe pipeline (``repro.distributed``'s
counterparts; its ``_compat`` shim across jax versions has none)."""
from repro_torch.distributed.mesh import build_mesh, make_mesh_config
from repro_torch.distributed.sharding import (
    Rules,
    axes_to_pspec,
    lc,
    logical_rules,
    param_shardings,
    rules_for,
    use_rules,
)

__all__ = [
    "build_mesh", "make_mesh_config", "Rules", "axes_to_pspec", "lc",
    "logical_rules", "param_shardings", "rules_for", "use_rules",
]
