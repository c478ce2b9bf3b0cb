from repro_torch.config.base import (
    DECODE_32K,
    LONG_500K,
    MULTI_POD_MESH,
    PREFILL_32K,
    SHAPES_BY_NAME,
    SINGLE_POD_MESH,
    SMOKE_MESH,
    STANDARD_SHAPES,
    TRAIN_4K,
    MeshConfig,
    ModelConfig,
    RunConfig,
    ShapeConfig,
    ShardingConfig,
    TrainConfig,
)
from repro_torch.config.registry import ArchEntry, get, iter_cells, list_archs, register

__all__ = [
    "ModelConfig", "ShapeConfig", "MeshConfig", "RunConfig", "ShardingConfig",
    "TrainConfig", "ArchEntry", "get", "register", "list_archs", "iter_cells",
    "STANDARD_SHAPES", "SHAPES_BY_NAME", "TRAIN_4K", "PREFILL_32K", "DECODE_32K",
    "LONG_500K", "SINGLE_POD_MESH", "MULTI_POD_MESH", "SMOKE_MESH",
]
