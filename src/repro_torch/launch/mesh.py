"""Production mesh construction.

The port of ``repro.launch.mesh``.  ``make_production_mesh`` is a FUNCTION
(not a module-level constant) so that importing this module never touches
process-group state: the mesh spans the default process group, which the
caller starts (``launch/dryrun.py`` starts a fake one of 256 or 512 ranks).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.config import MULTI_POD_MESH, SINGLE_POD_MESH, MeshConfig
from repro_torch.distributed.mesh import build_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[Union[str, torch.device]] = None):
    """The (16, 16) data x model mesh, or (2, 16, 16) pod x data x model,
    over a default process group of 256 or 512 ranks, on ``device``'s type
    (default cuda)."""
    return build_mesh(production_mesh_config(multi_pod=multi_pod), device=device)


def production_mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    return MULTI_POD_MESH if multi_pod else SINGLE_POD_MESH
