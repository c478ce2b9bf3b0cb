"""The trainer's compiled step (``Trainer`` through ``StepBundle.jit``), on
the CPU.

* A proxy for what a CUDA graph of a train step needs, as
  ``tests/test_torch_jit.py`` holds the decode steps: under a
  ``TorchDispatchMode`` two consecutive ``train_bundle(rc).fn`` steps of
  every trainable family (smoke size, fp32), over the learning rate's
  warm-up boundary, dispatch no op that reads a device value on the host
  and the same ops with the same shapes and non-tensor arguments; so
  again with ``accum_steps=2`` and with clipping off;
* the ``Trainer`` builds its step through ``StepBundle.jit`` and runs every
  step through it, on one device and on a (2, 2) mesh of four gloo ranks
  (``tests/torch_dist_cases.py``);
* on a restart the first compiled step (which keeps the state its graph
  read) and the state are garbage before the trainer restores;
* ``warmup_cosine`` on a 0-d int32 step stays on that step's device, reads
  nothing on the host, and equals the reference's at every step.

The graphed step against the eager one on the card is in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 28.
"""
import dataclasses
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as RefTrainConfig
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro_torch import config as C
from repro_torch.data.synthetic import batches_for
from repro_torch.optim import tree_leaves, warmup_cosine
from repro_torch.runtime.failure import FailurePlan
from repro_torch.runtime.jit import Jitted
from repro_torch.runtime.steps import StepBundle, init_train_state, train_bundle
from repro_torch.runtime.trainer import Trainer
from test_torch_distributed import _run_case
from test_torch_jit import _Ops

#: every family ``train_bundle`` trains
FAMILIES = ["qwen1.5-4b", "qwen3-moe-30b-a3b", "internvl2-2b", "zamba2-7b", "rwkv6-1.6b",
            "seamless-m4t-large-v2", "lenet"]
#: (arch, TrainConfig fields beside warmup_steps=1): every family with the
#: defaults (one microbatch, clipping at 1.0), and the dense config with two
#: microbatches and with clipping off
CASES = ([(arch, {}) for arch in FAMILIES]
         + [("qwen1.5-4b", {"accum_steps": 2}), ("qwen1.5-4b", {"grad_clip": 0.0})])


def _smoke_run_cfg(arch, **train):
    cfg = dataclasses.replace(C.get(arch).smoke, dtype="float32")
    return C.RunConfig(model=cfg, shape=C.ShapeConfig("t", 32, 4, "train"), mesh=C.SMOKE_MESH,
                       train=C.TrainConfig(**{"warmup_steps": 1, "total_steps": 10, **train}))


@pytest.mark.parametrize("arch,train", CASES,
                         ids=[a + "".join(f"-{k}={v}" for k, v in t.items()) for a, t in CASES])
def test_train_steps_are_graph_safe(arch, train):
    """Steps 1 and 2 (the rate still warming up, then decaying): no host
    read, one op sequence."""
    rc = _smoke_run_cfg(arch, **train)
    state = init_train_state(rc, 0, "cpu")
    data = batches_for(rc.model, rc.shape, 0)
    step = train_bundle(rc).fn
    runs, lrs = [], []
    for _ in range(2):
        batch = {k: torch.from_numpy(v) for k, v in next(data).items()}
        with _Ops() as ops:
            state, metrics = step(state, batch)
        assert ops.host_reads() == [], (arch, ops.host_reads())
        runs.append(ops.ops)
        lrs.append(float(metrics["lr"]))
    assert len(runs[0]) > 0 and runs[0] == runs[1]
    assert lrs[0] == pytest.approx(rc.train.learning_rate) and lrs[1] < lrs[0]
    assert int(state.step) == 2


def test_warmup_cosine_stays_on_the_steps_device_and_matches_the_reference():
    cfg = C.TrainConfig(warmup_steps=3, total_steps=12, learning_rate=2e-3)
    ref = ref_warmup_cosine(RefTrainConfig(warmup_steps=3, total_steps=12, learning_rate=2e-3))
    lr = warmup_cosine(cfg)
    for step in range(15):
        t = torch.tensor(step, dtype=torch.int32)
        with _Ops() as ops:
            got = lr(t)
        assert ops.host_reads() == []
        assert got.device == t.device and got.dtype == torch.float32 and got.dim() == 0
        want = np.asarray(ref(jnp.asarray(step, jnp.int32)), np.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0.0)
    # a step on the meta device: anything that read it on the host would fail
    assert lr(torch.tensor(4, dtype=torch.int32, device="meta")).device.type == "meta"


def _trainer_cfg(tmp_path, total):
    rc = _smoke_run_cfg("llama3-8b")
    return dataclasses.replace(rc, train=dataclasses.replace(
        rc.train, total_steps=total, checkpoint_every=1, keep_checkpoints=2,
        checkpoint_dir=str(tmp_path)))


def test_trainer_runs_every_step_through_bundle_jit(tmp_path, monkeypatch):
    made, calls = [], []
    real_jit, real_call = StepBundle.jit, Jitted.__call__

    def spy_jit(self, *args):
        made.append(real_jit(self, *args))
        return made[-1]

    def spy_call(self, *args):
        calls.append(self)
        return real_call(self, *args)

    monkeypatch.setattr(StepBundle, "jit", spy_jit)
    monkeypatch.setattr(Jitted, "__call__", spy_call)
    report = Trainer(_trainer_cfg(tmp_path, 3), use_mesh=False, device="cpu").train()
    assert report.steps_done == 3 and len(made) == 1 and calls == made * 3


def test_trainer_on_a_mesh_runs_every_step_through_bundle_jit(tmp_path):
    reports = _run_case("trainer_jit", tmp_path, ckpt_dir=np.array(str(tmp_path / "c")))[
        "reports"]
    assert reports == [{"steps_done": 2, "made": 1, "through_it": 2, "calls": 2}] * 4


def test_a_restart_frees_the_compiled_step_and_the_state_before_it_restores(
        tmp_path, monkeypatch):
    """The old step (on the card: its graph, the inputs it keeps, its
    pool) and the old state are freed when the restart allocates again."""
    made, states, dead = [], [], []
    real_jit, real_init = StepBundle.jit, Trainer._init_or_restore

    def spy_jit(self, *args):
        step = real_jit(self, *args)
        made.append(weakref.ref(step))
        return step

    def spy_init(self, *args):
        dead.append(([r() is None for r in made], [r() is None for r in states]))
        state, start = real_init(self, *args)
        states.append(weakref.ref(tree_leaves(state.master)[0]))
        return state, start

    monkeypatch.setattr(StepBundle, "jit", spy_jit)
    monkeypatch.setattr(Trainer, "_init_or_restore", spy_init)
    report = Trainer(_trainer_cfg(tmp_path, 4), use_mesh=False, device="cpu",
                     failure_plan=FailurePlan(failures={2: 0})).train()
    assert report.restarts == 1 and report.steps_done >= 4
    assert dead == [([False], []), ([True, False], [True])]
