"""Checkpoint store: atomic, async, in the reference package's on-disk format.

Layout (one directory per step):

    <dir>/step_000100/
        manifest.json     # leaf paths, shapes, dtypes, step metadata
        arrays.npz        # one entry per leaf (copied to host)
    <dir>/step_000100.COMMITTED   # commit marker -> crash-safe

The port of ``repro.checkpoint.store``: a checkpoint either package writes,
the other restores bit for bit.  Leaves are ordered and named as JAX's tree
utilities order and name them (dict keys sorted, ``['key']`` and ``[i]``
path strings), and a 16-bit or 8-bit float without a numpy dtype (bfloat16,
float8) is stored as raw void bytes, as ``np.savez`` stores JAX's.
:func:`restore` returns CPU tensors; :func:`restore_resharded` lays them out
on a (possibly different) mesh, the elastic-rescale path, each rank copying
its own shard of each leaf to its device.  A state of DTensors is saved
whole by rank 0 alone: each distinct shard of a leaf is sent to it on its
own and copied to host memory at once, so no rank's device holds a leaf
whole.  The paper
analogue (§III-F): training state checkpointing is the "global memory"
snapshot; the simulator's op-window checkpoint lives in
``repro_torch.core.sim_checkpoint`` and composes with this store.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import shutil
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

#: float dtypes numpy has no dtype for: stored as raw bytes of this width
_RAW = {torch.bfloat16: (np.int16, "bfloat16"),
        torch.float8_e4m3fn: (np.uint8, "float8_e4m3fn"),
        torch.float8_e5m2: (np.uint8, "float8_e5m2")}
_RAW_BY_NAME = {name: (dt, ints) for dt, (ints, name) in _RAW.items()}


def _flatten(tree: Any, path: str = "", is_leaf=None) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in JAX's order: dict keys sorted, sequences in
    order, ``None`` an empty subtree (a leaf where ``is_leaf`` says so)."""
    if is_leaf is not None and is_leaf(tree):
        return [(path, tree)]
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], f"{path}[{k!r}]", is_leaf))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten(v, f"{path}[{i}]", is_leaf))
        return out
    return [(path, tree)]


def _unflatten(like: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            new = {k: build(t[k]) for k in sorted(t)}
            return {k: new[k] for k in t}
        if isinstance(t, (list, tuple)):
            vals = [build(v) for v in t]
            return type(t)(vals) if isinstance(t, list) else tuple(vals)
        return next(it)
    return build(like)


def _to_host(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf as the numpy array ``arrays.npz`` holds, and its dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in _RAW:
            ints, name = _RAW[t.dtype]
            arr = t.contiguous().view(torch.int16 if ints is np.int16 else torch.uint8).numpy()
            return arr.view(np.dtype(f"V{arr.itemsize}")), name
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if arr.dtype.kind == "V":   # npz stores bf16/f8 as raw void bytes
        torch_dtype, ints = _RAW_BY_NAME[dtype]
        return torch.from_numpy(np.ascontiguousarray(arr).view(ints)).view(torch_dtype)
    return torch.from_numpy(np.array(arr))


def _shards(leaf) -> List[Tuple[int, Tuple[slice, ...]]]:
    """(owner rank, box) of each distinct shard of a DTensor: the first
    rank in mesh order that holds that box."""
    from repro_torch.distributed.sharding import shard_box
    mesh = leaf.device_mesh
    owners: Dict[Tuple[Tuple[int, int], ...], int] = {}
    for coord in itertools.product(*(range(n) for n in mesh.mesh.shape)):
        box = shard_box(leaf.shape, mesh, leaf.placements, coord)
        owners.setdefault(tuple((s.start, s.stop) for s in box), int(mesh.mesh[coord]))
    return [(r, tuple(slice(a, b) for a, b in key)) for key, r in owners.items()]


def _host_copy(leaf: Any, writes: bool) -> Any:
    """A leaf whole in host memory on the rank that writes, None elsewhere.
    A DTensor's distinct shards reach rank 0 one at a time, point to point
    in an order every rank computes alike: a rank's device holds at most
    its own shards and, on rank 0, one other's."""
    from torch.distributed.tensor import DTensor
    if not isinstance(leaf, DTensor):
        if not writes:
            return None
        # a copy even of a host tensor: the writer thread reads it while the
        # next step updates the state in place
        return leaf.detach().to("cpu", copy=True) if isinstance(leaf, torch.Tensor) else leaf
    import torch.distributed as dist
    me = dist.get_rank()
    local = leaf.to_local().detach()
    out = torch.empty(leaf.shape, dtype=leaf.dtype) if writes else None
    for owner, box in _shards(leaf):
        shape = [s.stop - s.start for s in box]
        if math.prod(shape) == 0:
            continue
        if owner == me:
            if writes:
                out[box] = local.cpu()
            else:
                dist.send(local.contiguous().reshape(-1).view(torch.uint8), dst=0)
        elif writes:
            buf = torch.empty(math.prod(shape) * leaf.element_size(), dtype=torch.uint8,
                              device=local.device)
            dist.recv(buf, src=owner)
            out[box] = buf.cpu().view(leaf.dtype).reshape(shape)
            del buf
    return out


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0, or the only one."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def save(directory: str, step: int, tree: Any, blocking: bool = True,
         extra_meta: Optional[Dict] = None) -> Optional[threading.Thread]:
    """Write a checkpoint; returns the writer thread (join if blocking=False),
    or None on a rank that does not write."""
    # copy to host memory synchronously (cheap vs. a training step); disk
    # I/O can then proceed async without racing later in-place updates
    flat = _flatten(tree)
    paths = [p for p, _ in flat]
    writes = _writes()
    host = [_host_copy(leaf, writes) for _, leaf in flat]
    if not writes:
        return None
    host = [_to_host(leaf) for leaf in host]
    os.makedirs(directory, exist_ok=True)

    def _write():
        name = f"step_{step:08d}"
        tmp = os.path.join(directory, f".tmp_{name}_{uuid.uuid4().hex[:8]}")
        final = os.path.join(directory, name)
        os.makedirs(tmp, exist_ok=True)
        arrays = {f"leaf_{i}": arr for i, (arr, _) in enumerate(host)}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "paths": paths,
            "shapes": [list(arr.shape) for arr, _ in host],
            "dtypes": [dt for _, dt in host],
            "time": time.time(),
            "extra": extra_meta or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final, ignore_errors=True)
        try:
            os.rename(tmp, final)
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)   # concurrent same-step save won
        open(final + ".COMMITTED", "w").close()

    t = threading.Thread(target=_write, daemon=True)
    t.start()
    if blocking:
        t.join()
    return t


def list_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
                os.path.join(directory, name + ".COMMITTED")):
            steps.append(int(name.split("_")[1]))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int, like: Any) -> Any:
    """Restore to CPU tensors with the structure of ``like``."""
    name = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(name, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(name, "arrays.npz"))
    leaves = [_from_host(data[f"leaf_{i}"], dt)
              for i, dt in enumerate(manifest["dtypes"])]
    want = len(_flatten(like))
    if want != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, target tree expects "
            f"{want} — structure changed since save")
    return _unflatten(like, leaves)


def restore_resharded(directory: str, step: int, like: Any, shardings: Any) -> Any:
    """Restore onto a (possibly different) mesh: the elastic-rescale path.

    ``shardings`` has ``like``'s structure; each leaf is ``(mesh,
    placements)`` (the leaf becomes a DTensor: every rank reads the whole
    checkpoint into host memory and copies its own shard to the mesh's
    device), a device (the leaf is moved there) or
    None (it stays on the CPU).  Each leaf takes ``like``'s dtype."""
    from repro_torch.distributed.sharding import from_full
    host = restore(directory, step, like)
    targets = [t for _, t in _flatten(shardings, is_leaf=_is_layout)]
    leaves = [leaf for _, leaf in _flatten(host)]
    likes = [leaf for _, leaf in _flatten(like)]
    out = []
    for leaf, target, lk in zip(leaves, targets, likes):
        leaf = leaf.to(lk.dtype)
        if isinstance(target, tuple):
            mesh, placements = target
            leaf = from_full(leaf, mesh, placements, device=mesh.device_type)
        elif target is not None:
            leaf = leaf.to(target)
        out.append(leaf)
    return _unflatten(like, out)


def _is_layout(x: Any) -> bool:
    """A leaf of a shardings tree: None, a device or ``(mesh, placements)``."""
    return not isinstance(x, (dict, list, tuple)) or (
        len(x) == 2 and hasattr(x[0], "mesh_dim_names"))


class CheckpointManager:
    """Cadenced async checkpointing with retention, for the trainer loop."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3,
                 async_write: bool = True):
        self.directory = directory
        self.every = every
        self.keep = keep
        self.async_write = async_write
        self._pending: List[threading.Thread] = []

    def maybe_save(self, step: int, tree: Any, force: bool = False) -> bool:
        if not force and (self.every <= 0 or step % self.every != 0):
            return False
        t = save(self.directory, step, tree, blocking=not self.async_write)
        if t is not None and self.async_write:
            self._pending.append(t)
        else:
            self._gc()
        return True

    def wait(self):
        for t in self._pending:
            t.join()
        self._pending.clear()
        self._gc()   # retention enforced once all async writes committed

    def _gc(self):
        if not _writes():
            return
        steps = list_steps(self.directory)
        for s in steps[:-self.keep] if self.keep > 0 else []:
            name = os.path.join(self.directory, f"step_{s:08d}")
            shutil.rmtree(name, ignore_errors=True)
            try:
                os.remove(name + ".COMMITTED")
            except OSError:
                pass
