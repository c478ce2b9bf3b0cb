"""Architecture registry.

``repro_torch.configs.<arch>`` modules call :func:`register` at import time.  The
registry maps arch id -> (full ModelConfig, smoke ModelConfig, metadata).
"""
from __future__ import annotations

import importlib
import pkgutil
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

from repro_torch.config.base import ModelConfig, ShapeConfig, STANDARD_SHAPES


@dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    full: ModelConfig
    smoke: ModelConfig
    source: str = ""                      # provenance citation from the pool
    shape_skips: Tuple[Tuple[str, str], ...] = ()  # (shape_name, reason)
    accum_steps: int = 1                  # grad-accum needed to fit 16GB HBM

    def skip_reason(self, shape: ShapeConfig) -> Optional[str]:
        for name, reason in self.shape_skips:
            if name == shape.name:
                return reason
        return None


_REGISTRY: Dict[str, ArchEntry] = {}
_LOADED = False


def register(entry: ArchEntry) -> ArchEntry:
    if entry.arch_id in _REGISTRY:
        raise ValueError(f"duplicate arch id {entry.arch_id}")
    _REGISTRY[entry.arch_id] = entry
    return entry


def _ensure_loaded() -> None:
    """Import every module in repro_torch.configs exactly once."""
    global _LOADED
    if _LOADED:
        return
    import repro_torch.configs as configs_pkg

    for mod in pkgutil.iter_modules(configs_pkg.__path__):
        if not mod.name.startswith("_"):
            importlib.import_module(f"repro_torch.configs.{mod.name}")
    _LOADED = True


def get(arch_id: str) -> ArchEntry:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


def iter_cells(include_skipped: bool = False):
    """Yield (entry, shape, skip_reason) for every (arch x standard shape) cell."""
    _ensure_loaded()
    for arch_id in list_archs():
        entry = _REGISTRY[arch_id]
        for shape in STANDARD_SHAPES:
            reason = entry.skip_reason(shape)
            if reason is None or include_skipped:
                yield entry, shape, reason
