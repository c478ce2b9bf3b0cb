"""Device-mesh construction from MeshConfig.

The port of ``repro.distributed.mesh``.  ``build_mesh`` is the only place
that makes a ``DeviceMesh``; everything else works with the abstract
``MeshConfig``.  The mesh spans the ranks of the default process group
(started by the caller: NCCL on the card, gloo on the CPU), one device a
rank.  For elastic restarts the mesh can be rebuilt from however many ranks
survive (``allow_fewer``): the first ``shrink_to(...).num_devices`` ranks
form it, and the others are left out.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

from repro_torch.config import MeshConfig


def make_mesh_config(num_devices: int, model_parallel: int = 1,
                     pods: int = 1) -> MeshConfig:
    """Derive a MeshConfig for an arbitrary device count (elastic rescale)."""
    if num_devices % (model_parallel * pods):
        raise ValueError(
            f"{num_devices} devices not divisible by model={model_parallel} x pods={pods}")
    data = num_devices // (model_parallel * pods)
    if pods > 1:
        return MeshConfig((pods, data, model_parallel), ("pod", "data", "model"))
    return MeshConfig((data, model_parallel), ("data", "model"))


def build_mesh(cfg: MeshConfig, num_devices: Optional[int] = None,
               allow_fewer: bool = False,
               device: Optional[Union[str, torch.device]] = None):
    """A ``DeviceMesh`` of ``cfg``'s shape and axis names over the default
    process group, on ``device``'s type (default cuda; the CPU only when
    asked for).

    ``num_devices`` (default: the group's world size) is how many ranks may
    take part.  If that is fewer than cfg requests and ``allow_fewer`` is
    set, the data axis shrinks (elastic degradation) — the model axis is
    kept because parameter shardings depend on it.  Every rank of the group
    must call this; a rank outside the mesh gets ``None``.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.device import resolve_device
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs a started default process group "
                           "(torch.distributed.init_process_group)")
    have = dist.get_world_size() if num_devices is None else num_devices
    need = cfg.num_devices
    if have < need:
        if not allow_fewer:
            raise ValueError(
                f"mesh {cfg.shape} needs {need} ranks, have {have} "
                f"(pass allow_fewer=True for elastic shrink)")
        cfg = shrink_to(cfg, have)
        need = cfg.num_devices
    dev_type = resolve_device(device).type
    if dev_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    # every rank builds the same groups (a collective call); on a shrunk
    # mesh the ranks past it take no part
    mesh = DeviceMesh(dev_type, torch.arange(need).reshape(cfg.shape),
                      mesh_dim_names=cfg.axis_names)
    return mesh if dist.get_rank() < need else None


def fabric_spec(cfg: MeshConfig) -> str:
    """The :mod:`repro_torch.topology` fabric spec a mesh maps onto.

    Meshes are laid out on the physical torus axis-by-axis, so a mesh with
    two-plus non-trivial axes simulates as a torus of those axis sizes, a
    single non-trivial axis as a ring, and a trivial (1-device) mesh as a
    1-ring.  Feed the result into ``HardwareSpec.ici_topology`` (or
    ``Fleet.from_spec(..., topology=...)``) so simulated collectives land on
    the links the mesh would actually use::

        hw = dataclasses.replace(V5E, ici_topology=fabric_spec(cfg))
    """
    dims = [d for d in cfg.shape if d > 1]
    if len(dims) >= 2:
        return "torus:" + "x".join(str(d) for d in dims)
    return f"ring:{dims[0] if dims else 1}"


def shrink_to(cfg: MeshConfig, num_devices: int) -> MeshConfig:
    """Elastic shrink: keep the model axis, shrink data (and drop pod) axes."""
    model = cfg.axis_size("model")
    if num_devices < model:
        raise ValueError(f"cannot shrink below model-parallel degree {model}")
    data = num_devices // model
    # round data down to a power of two for balanced collectives
    data = 2 ** int(math.log2(data)) if data > 0 else 1
    return MeshConfig((data, model), ("data", "model"))


def start_process_group(device: Optional[Union[str, torch.device]] = None,
                        timeout_s: float = 600.0) -> bool:
    """Start the default process group if none is running: from the
    launcher's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, as ``torchrun`` sets them), or else as the one rank of
    its own group on a free local port.  NCCL on cuda, gloo on the CPU.
    Returns whether it started one (the caller then destroys it)."""
    import datetime
    import os
    import socket

    import torch.distributed as dist

    from repro_torch.device import resolve_device
    if dist.is_initialized():
        return False
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, timeout=timeout)
        return True
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, timeout=timeout)
    return True
