"""Fault-tolerant training loop.

The port of ``repro.runtime.trainer``.  Responsibilities: build the step,
stream data, checkpoint at cadence, detect injected/real failures, restart
on the devices that are left, restore, and continue — plus straggler-
deadline monitoring (per-step wall-clock vs a rolling median; slow steps
are logged and counted, the real-cluster analogue being reassignment of
that host's data shard).

The step is compiled (``bundle.jit()``, as the reference's): on the card
the first step of a build runs eagerly, the second is captured into a
CUDA graph, and every later one replays it; on the CPU it is the plain
step.  The metrics are the graph's outputs, which the next replay
overwrites, so the loss is read as soon as the step returns.

Checkpoints go through the port's ``checkpoint`` store, in the reference's
on-disk format, so either package can resume the other's run.  A save
copies the state to host memory before the next step updates it in place.
``checkpoint_every <= 0`` turns checkpoints off, the final save included
(where the reference always writes one: a full-width state is tens of GB).

With ``use_mesh=True`` (the reference's default) every rank of the default
process group runs this loop: the mesh is built over those ranks
(``build_mesh(rc.mesh, allow_fewer=True)``), the state and batches are
DTensors on it, rank 0 writes the checkpoints, and an elastic restart
rebuilds the mesh over the ranks that are left (``shrink_to``) and restores
the resharded checkpoint; a rank outside the new mesh leaves the loop
cleanly.  With ``use_mesh=False`` the step runs on one device.
"""
from __future__ import annotations

import logging
import statistics
import time
from dataclasses import dataclass, field
from typing import List, Optional, Union

import torch

from repro_torch.checkpoint import (CheckpointManager, latest_step, restore,
                                    restore_resharded)
from repro_torch.config import RunConfig
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import batches_for
from repro_torch.device import resolve_device
from repro_torch.distributed.mesh import build_mesh
from repro_torch.models import build_model
from repro_torch.optim import TrainState, abstract_state, tree_map
from repro_torch.runtime.failure import FailurePlan, NodeFailure
from repro_torch.runtime.steps import run_rules, init_train_state, train_bundle

log = logging.getLogger("repro_torch.trainer")


@dataclass
class TrainReport:
    steps_done: int = 0
    restarts: int = 0
    final_loss: float = float("nan")
    losses: List[float] = field(default_factory=list)
    slow_steps: int = 0
    checkpoints: int = 0


class Trainer:
    def __init__(self, run_cfg: RunConfig, use_mesh: bool = True,
                 failure_plan: Optional[FailurePlan] = None,
                 straggler_factor: float = 3.0,
                 device: Optional[Union[str, torch.device]] = None):
        self.run_cfg = run_cfg
        self.use_mesh = use_mesh
        self.device = resolve_device(device)
        self.failure_plan = failure_plan or FailurePlan()
        self.straggler_factor = straggler_factor
        self.report = TrainReport()
        self._step_times: List[float] = []

    # -- setup ---------------------------------------------------------------
    def _device_count(self) -> int:
        import torch.distributed as dist
        if self.use_mesh:
            return dist.get_world_size()
        return torch.cuda.device_count() if self.device.type == "cuda" else 1

    def _build(self, num_devices: Optional[int] = None):
        """(mesh, step bundle, data); the mesh None without one, and all
        three None on a rank the mesh left out."""
        rc = self.run_cfg
        mesh = None
        if self.use_mesh:
            mesh = build_mesh(rc.mesh, num_devices, allow_fewer=True, device=self.device)
            if mesh is None:
                return None, None, None
        bundle = train_bundle(rc, mesh)
        model = build_model(rc.model, rc.sharding)
        _, batch_axes = model.train_input_specs(rc.shape)
        data = DataPipeline(batches_for(rc.model, rc.shape, rc.train.seed), self.device,
                            axes=batch_axes, rules=run_rules(rc, model), mesh=mesh)
        return mesh, bundle, data

    def _init_or_restore(self, mesh=None, bundle=None):
        rc = self.run_cfg
        ckpt_dir = rc.train.checkpoint_dir
        last = latest_step(ckpt_dir)
        if last is None:
            return init_train_state(rc, rc.train.seed, self.device, mesh=mesh), 0
        like = abstract_state(build_model(rc.model, rc.sharding).abstract())
        if mesh is not None:
            state = TrainState(*restore_resharded(ckpt_dir, last, like,
                                                  bundle.in_shardings[0]))
            state = state._replace(step=state.step.to(self.device))
        else:
            tree = restore(ckpt_dir, last, like)
            state = TrainState(*(tree_map(lambda t: t.to(self.device), part)
                                 for part in tree))
        log.info("restored step %d from %s", last, ckpt_dir)
        return state, last

    # -- loop ----------------------------------------------------------------
    def train(self, num_steps: Optional[int] = None) -> TrainReport:
        rc = self.run_cfg
        total = num_steps or rc.train.total_steps
        ckpt = CheckpointManager(rc.train.checkpoint_dir, rc.train.checkpoint_every,
                                 rc.train.keep_checkpoints,
                                 async_write=rc.train.async_checkpoint)
        num_devices = None
        while True:
            mesh, bundle, data = self._build(num_devices)
            if self.use_mesh and mesh is None:
                log.warning("this rank is outside the %d-rank mesh: leaving", num_devices)
                return self.report
            step_fn = bundle.jit()
            state, start = self._init_or_restore(mesh, bundle)
            try:
                for step in range(start, total):
                    t0 = time.perf_counter()
                    # live plans sleep here; simulated plans only report the
                    # injected seconds, folded into the measured step time
                    # below so the straggler detector sees the same signal
                    injected = self.failure_plan.straggle(step)
                    batch = next(data)
                    state, metrics = step_fn(state, batch)
                    self.failure_plan.check(step)
                    loss = float(metrics["loss"])
                    self.report.losses.append(loss)
                    dt = time.perf_counter() - t0
                    if self.failure_plan.simulated:
                        dt += injected
                    self._note_step_time(step, dt)
                    if ckpt.maybe_save(step + 1, state):
                        self.report.checkpoints += 1
                    self.report.steps_done += 1
                data.close()
                if rc.train.checkpoint_every > 0:
                    ckpt.maybe_save(total, state, force=True)
                ckpt.wait()
                self.report.final_loss = (self.report.losses[-1] if self.report.losses
                                          else float("nan"))
                return self.report
            except NodeFailure as e:
                # elastic restart: drop the lost devices, rebuild a smaller
                # mesh, restore the last checkpoint onto it
                data.close()
                ckpt.wait()
                _barrier()      # every rank sees the checkpoint rank 0 committed
                # the restart restores from disk: free the state first, and
                # the compiled step, whose graphs keep it (their inputs) and
                # their pool (the metrics are the pool's)
                state = step_fn = metrics = None
                self.report.restarts += 1
                num_devices = max(self._device_count() - e.lost_devices, 1)
                log.warning("failure at step %d -> elastic restart on %d device(s)",
                            e.step, num_devices)

    def _note_step_time(self, step: int, dt: float):
        self._step_times.append(dt)
        window = self._step_times[-21:-1]
        if len(window) >= 5:
            med = statistics.median(window)
            if dt > self.straggler_factor * med:
                self.report.slow_steps += 1
                log.warning("straggler: step %d took %.3fs (median %.3fs)",
                            step, dt, med)


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()
