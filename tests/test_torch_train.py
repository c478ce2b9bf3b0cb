"""The port's training half against the reference package's, on the CPU.

Every comparison hands both packages the same inputs, made with numpy from
a seed, in fp32 (the configs with ``dtype="float32"``), and one training
state carried across (``state_from_jax``).  Tolerances, of each tensor's
largest magnitude (sums run in another order in the two packages, and the
schedule's cosine differs in the last ulp):

* the learning rate: rtol 1e-6;
* the loss: rtol 1e-5; every gradient leaf: 1e-5 (measured: 2.2e-6);
* the new params and master: 2e-5 (measured: 3.3e-6, against an update of
  about 1e-2 of the weights); m and v: 1e-5 (measured: 6e-7).

The captured train step's dot FLOPs are held to the live reference capture
and to an analytic count.  The one difference is named: the flash op's
backward recomputes q.k^T and p.v through ``attention_ref`` (as the
reference's ``custom_vjp`` would), on top of the layer recompute that
reruns the kernel, so the port counts 2 more attention products a layer
than the reference's plain ``sdpa``.  The five ``Trainer`` tests of
``tests/test_fault_tolerance.py`` run on the port's trainer.
"""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as RC
from repro.core import Simulator as RefSimulator
from repro.models import build_model as ref_build_model
from repro.models.layers import lm_loss_from_hidden as ref_lm_loss
from repro.optim import TrainState as RefTrainState
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro.runtime.steps import train_bundle as ref_train_bundle
from repro_torch import config as C
from repro_torch.checkpoint.store import list_steps
from repro_torch.core.capture import capture_bundle
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models.layers import lm_loss_from_hidden, pad_vocab
from repro_torch.models.transformer import state_from_jax
from repro_torch.optim import (TrainState, adamw_update, init_state, tree_leaves,
                               tree_map, warmup_cosine)
from repro_torch.runtime.failure import FailurePlan
from repro_torch.runtime.steps import (init_train_state, loss_and_grads,
                                       train_bundle)
from repro_torch.runtime.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen1.5-4b", "gemma3-12b", "gemma3-27b"]
B, S = 4, 40
TRAIN = dict(warmup_steps=2, total_steps=10, learning_rate=1e-2)


def _rel_err(mine, ref):
    mine = mine.detach().float().numpy() if isinstance(mine, torch.Tensor) else mine
    ref = np.asarray(ref, np.float32)
    assert mine.shape == ref.shape
    return float(np.abs(mine - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


def _trees_close(mine, ref, tol):
    leaves = tree_leaves(mine)
    ref_leaves = jax.tree.leaves(ref)
    assert len(leaves) == len(ref_leaves)
    worst = max(_rel_err(a, b) for a, b in zip(leaves, ref_leaves))
    assert worst <= tol, worst


def _np_tree(specs, rng):
    """Weights in the reference's tree: unit-scale activations, random norm
    gains and biases (the reference initializes them to zero)."""
    if not isinstance(specs, dict):
        shape = specs.shape
        if specs.init == "zeros":
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        std = 0.5 if specs.init == "embed" else 1.0 / np.sqrt(shape[-2])
        return (std * rng.standard_normal(shape)).astype(np.float32)
    return {k: _np_tree(v, rng) for k, v in specs.items()}


def _np_state(specs, rng, step=3):
    """A state some steps in: weights, their master copy, random moments."""
    w = _np_tree(specs, rng)
    m = jax.tree.map(lambda a: (1e-2 * rng.standard_normal(a.shape)).astype(np.float32), w)
    v = jax.tree.map(lambda a: (1e-4 * rng.random(a.shape)).astype(np.float32), w)
    return RefTrainState(np.int32(step), w, jax.tree.map(np.copy, w), m, v)


def _batch(rng, b=B, s=S, vocab=256):
    tok = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _run_cfgs(arch, accum=1, b=B, s=S):
    ref = RC.RunConfig(model=dataclasses.replace(RC.get(arch).smoke, dtype="float32"),
                       shape=RC.ShapeConfig("t", s, b, "train"), mesh=RC.SMOKE_MESH,
                       train=RC.TrainConfig(accum_steps=accum, **TRAIN))
    port = C.RunConfig(model=dataclasses.replace(C.get(arch).smoke, dtype="float32"),
                       shape=C.ShapeConfig("t", s, b, "train"), mesh=C.SMOKE_MESH,
                       train=C.TrainConfig(accum_steps=accum, **TRAIN))
    return ref, port


# -- schedule and optimizer -------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 100, 550, 1000, 1200],
                         ids=["0", "1", "warmup", "midway", "total", "past-total"])
def test_warmup_cosine_matches_reference(step):
    cfg = C.TrainConfig()          # warmup 100, total 1000
    want = float(ref_warmup_cosine(RC.TrainConfig())(step))
    got = warmup_cosine(cfg)(torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32 and got.shape == ()
    assert math.isclose(float(got), want, rel_tol=1e-6, abs_tol=0.0)


@pytest.mark.parametrize("clip", [1.0, 1e3], ids=["clipping", "not-clipping"])
def test_adamw_update_matches_reference(clip):
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 5, 7), "b": {"c": (11,), "d": (4, 300)}}
    w = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                     is_leaf=lambda x: isinstance(x, tuple))
    g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), w)
    m = jax.tree.map(lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32), w)
    v = jax.tree.map(lambda a: (0.01 * rng.random(a.shape)).astype(np.float32), w)
    cfg = dict(grad_clip=clip, warmup_steps=2, total_steps=10, learning_rate=1e-2)
    ref_cfg = RC.TrainConfig(**cfg)
    ref_state = RefTrainState(jnp.int32(4), *(jax.tree.map(jnp.asarray, t)
                                               for t in (w, w, m, v)))
    want, want_m = ref_adamw_update(ref_state, jax.tree.map(jnp.asarray, g), ref_cfg,
                                    ref_warmup_cosine(ref_cfg))
    conv = lambda t: tree_map(lambda a: torch.from_numpy(np.array(a)), t)
    state = TrainState(torch.tensor(4, dtype=torch.int32), *(conv(t) for t in (w, w, m, v)))
    port_cfg = C.TrainConfig(**cfg)
    got, got_m = adamw_update(state, conv(g), port_cfg, warmup_cosine(port_cfg))
    assert int(got.step) == int(want.step) == 5
    assert (float(want_m["grad_norm"]) > clip) == (clip == 1.0)
    for key in ("grad_norm", "lr"):
        assert math.isclose(float(got_m[key]), float(want_m[key]), rel_tol=1e-6)
    for name, tol in (("params", 2e-5), ("master", 2e-5), ("m", 1e-5), ("v", 1e-5)):
        _trees_close(getattr(got, name), getattr(want, name), tol)
    # in place: the state passed in is the state updated
    assert got.master is state.master and got.params is state.params


@pytest.mark.parametrize("s,chunk,masked", [(600, 512, False), (600, 512, True),
                                            (96, 64, True), (40, 512, False)],
                         ids=["s600", "s600-mask", "s96-chunk48-mask", "s40"])
def test_lm_loss_from_hidden_matches_reference(s, chunk, masked):
    """Value and gradients (x and the head), with a mask and with an s whose
    chunk is not 512 (600 -> 300, 96 at chunk 64 -> 48)."""
    rng = np.random.default_rng(2)
    b, d, vocab = 2, 16, 64
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    head = (rng.standard_normal((d, vocab)) / 4).astype(np.float32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.7).astype(np.float32) if masked else None

    def ref_fn(x_, h_):
        return ref_lm_loss(x_, h_, jnp.asarray(labels), z_loss=1e-4, chunk=chunk,
                           mask=None if mask is None else jnp.asarray(mask))
    (want, want_ce), want_g = jax.value_and_grad(ref_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(head))
    xt, ht = (torch.from_numpy(a).requires_grad_() for a in (x, head))
    got, got_ce = lm_loss_from_hidden(xt, ht, torch.from_numpy(labels), z_loss=1e-4,
                                      chunk=chunk,
                                      mask=None if mask is None else torch.from_numpy(mask))
    got.backward()
    assert math.isclose(float(got.detach()), float(want), rel_tol=1e-5)
    assert math.isclose(float(got_ce.detach()), float(want_ce), rel_tol=1e-5)
    assert _rel_err(xt.grad, want_g[0]) <= 1e-5
    assert _rel_err(ht.grad, want_g[1]) <= 1e-5


# -- the train step --------------------------------------------------------

@pytest.fixture(scope="module", params=[(a, acc) for a in ARCHS for acc in (1, 2)],
                ids=[f"{a}-accum{acc}" for a in ARCHS for acc in (1, 2)])
def steps(request):
    """One smoke train step in both packages from one carried-across state:
    (loss, grads, new state, metrics) of each."""
    arch, accum = request.param
    ref_rc, rc = _run_cfgs(arch, accum)
    ref_model = ref_build_model(ref_rc.model)
    rng = np.random.default_rng(3)
    st_np = _np_state(ref_model.param_specs(), rng)
    batch = _batch(rng)
    ref_state = jax.tree.map(jnp.asarray, st_np)
    rb = {k: jnp.asarray(x) for k, x in batch.items()}
    (ref_loss, _), ref_grads = jax.value_and_grad(
        lambda p: ref_model.loss(p, rb), has_aux=True)(ref_state.params)
    ref_new, ref_metrics = jax.jit(ref_train_bundle(ref_rc).fn)(ref_state, rb)

    state = state_from_jax(st_np, rc.model)
    pb = {k: torch.from_numpy(x) for k, x in batch.items()}
    grads = tree_map(torch.zeros_like, state.params)
    loss, _ = loss_and_grads(build_model(rc.model), state.params, pb, grads)
    new, metrics = train_bundle(rc).fn(state, pb)
    return dict(accum=accum, ref=(ref_loss, ref_grads, ref_new, ref_metrics),
                port=(loss, grads, new, metrics))


def test_train_step_loss_and_grads_match_reference(steps):
    (ref_loss, ref_grads, _, _), (loss, grads, _, _) = steps["ref"], steps["port"]
    assert math.isclose(float(loss), float(ref_loss), rel_tol=1e-5)
    _trees_close(grads, ref_grads, 1e-5)


def test_train_step_state_and_metrics_match_reference(steps):
    """The whole step (microbatched at accum 2, as the reference's scan):
    the loss and metrics, and the new params, master, m and v."""
    (_, _, ref_new, ref_m), (_, _, new, metrics) = steps["ref"], steps["port"]
    assert int(new.step) == int(ref_new.step) == 4
    assert set(metrics) == set(ref_m)
    for key in ("loss", "ce", "grad_norm"):
        assert math.isclose(float(metrics[key]), float(ref_m[key]), rel_tol=1e-5), key
    assert math.isclose(float(metrics["lr"]), float(ref_m["lr"]), rel_tol=1e-6)
    for name, tol in (("params", 2e-5), ("master", 2e-5), ("m", 1e-5), ("v", 1e-5)):
        _trees_close(getattr(new, name), getattr(ref_new, name), tol)


@pytest.mark.parametrize("policy", ["none", "dots"])
def test_remat_policies_give_the_full_policys_gradients(policy):
    """Recompute changes what is stored, not what is computed."""
    _, rc = _run_cfgs("qwen1.5-4b")
    rng = np.random.default_rng(4)
    weights = _np_tree(build_model(rc.model).param_specs(), rng)
    batch = {k: torch.from_numpy(x) for k, x in _batch(rng).items()}
    outs = []
    for pol in ("full", policy):
        model = build_model(rc.model, C.ShardingConfig(remat_policy=pol))
        params = tree_map(lambda a: torch.from_numpy(a.copy()), weights)
        grads = tree_map(torch.zeros_like, params)
        loss, _ = loss_and_grads(model, params, batch, grads)
        outs.append((loss, grads))
    assert float(outs[0][0]) == float(outs[1][0])
    for a, b in zip(tree_leaves(outs[0][1]), tree_leaves(outs[1][1])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_grads_land_in_their_layer_slots():
    """A layer's gradient is written into its slot of the stacked buffer:
    the buffer passed in is the one filled, and the two layers' slots
    hold their own gradients (the reference's stacked grads)."""
    _, rc = _run_cfgs("qwen1.5-4b")
    model = build_model(rc.model)
    state = init_state(model.init(seed=0, device="cpu"))
    batch = {k: torch.from_numpy(x) for k, x in _batch(np.random.default_rng(5)).items()}
    grads = tree_map(torch.zeros_like, state.params)
    ptr = grads["layers"]["ffn"]["w_gate"].data_ptr()
    loss_and_grads(model, state.params, batch, grads)
    w = grads["layers"]["ffn"]["w_gate"]
    assert w.data_ptr() == ptr
    assert bool((w[0] != 0).any()) and bool((w[1] != 0).any())
    assert not torch.equal(w[0], w[1])


def test_state_from_jax_checks_the_tree():
    ref_rc, rc = _run_cfgs("qwen1.5-4b")
    st = _np_state(ref_build_model(ref_rc.model).param_specs(), np.random.default_rng(6))
    port = state_from_jax(st, rc.model)
    assert port.step.dtype == torch.int32 and int(port.step) == 3
    assert port.master["head"].dtype == torch.float32
    st.m["layers"]["ffn"].pop("w_up")
    with pytest.raises(KeyError, match="w_up"):
        state_from_jax(st, rc.model)


def test_a_mesh_waits_for_the_distributed_layer(tmp_path):
    """The mesh path (the trainer's default, ``use_mesh=True``) builds its
    mesh over the default process group, and says so when none is running;
    the bundle lays out a state and batch on a mesh it is given (the runs on
    one are ``tests/test_torch_distributed.py``'s)."""
    import torch.distributed as dist
    from repro_torch.distributed.mesh import build_mesh
    _, rc = _run_cfgs("qwen1.5-4b")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        build_mesh(rc.mesh, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        Trainer(rc, device="cpu").train()                     # use_mesh=True
    bundle = train_bundle(rc)
    assert bundle.mesh is None and bundle.in_shardings is None


# -- data ------------------------------------------------------------------

def test_pipeline_prefetches_in_order_and_ends():
    src = iter([{"tokens": np.full((2, 3), i, np.int32)} for i in range(5)])
    data = DataPipeline(src, "cpu")
    got = [int(b["tokens"][0, 0]) for b in data]
    assert got == list(range(5))
    with pytest.raises(StopIteration):
        next(data)
    data.close()
    assert not data._thread.is_alive()


def test_pipeline_hands_a_worker_error_to_the_consumer():
    def src():
        yield {"tokens": np.zeros((2, 3), np.int32)}
        raise ValueError("bad shard")
    data = DataPipeline(src(), "cpu")
    assert next(data)["tokens"].dtype == torch.int32
    with pytest.raises(ValueError, match="bad shard"):
        next(data)
    data.close()


def test_pipeline_closes_while_its_queue_is_full():
    def forever():
        while True:
            yield {"x": np.zeros(4, np.float32)}
    data = DataPipeline(forever(), "cpu", prefetch=1)
    next(data)
    data.close()
    assert not data._thread.is_alive()


# -- capture ---------------------------------------------------------------

def _mxu_flops(module):
    return sum(scale * module.op_flops(comp, op)["mxu"]
               for op, comp, scale in module.walk_entry())


@pytest.fixture(scope="module")
def train_captures():
    """The smoke train step of qwen1.5-4b at b 1, s 1024 (two loss chunks:
    with one, XLA folds the reference's chunk recompute into the forward),
    captured by both packages."""
    b, s = 1, 1024
    arch = "qwen1.5-4b"
    rc = C.RunConfig(model=C.get(arch).smoke, shape=C.ShapeConfig("t", s, b, "train"),
                     mesh=C.SMOKE_MESH)
    port = capture_bundle(train_bundle(rc), device="cpu")
    ref_rc = RC.RunConfig(model=RC.get(arch).smoke, shape=RC.ShapeConfig("t", s, b, "train"),
                          mesh=RC.SMOKE_MESH)
    ref = RefSimulator().capture_bundle(ref_train_bundle(ref_rc))
    return rc.model, b, s, port, ref


def test_train_capture_dot_flops_match_analytic_and_reference(train_captures):
    """Per layer: q, k, v, o and the FFN products forward, recomputed and
    twice in the backward, except the down projection, whose output no
    backward reads (the recompute stops before it); attention 2 products
    forward, 2 recomputed by the kernel, and 6 in its backward through
    attention_ref; the head 4 times a chunk.  The reference: the same less
    the 2 attention products of the flash op's backward recompute."""
    cfg, b, s, port, ref = train_captures
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    n = b * s
    proj = 2 * n * d * (h + 2 * kv) * hd + 2 * n * h * hd * d + 3 * 2 * n * d * cfg.d_ff
    down = 2 * n * cfg.d_ff * d
    att = 2 * b * h * s * s * hd
    head = 2 * n * d * pad_vocab(cfg.vocab_size)
    want = cfg.num_layers * (4 * proj - down + 10 * att) + 4 * head
    assert _mxu_flops(port.module) == want
    assert _mxu_flops(port.module) == _mxu_flops(ref.module) + cfg.num_layers * 2 * att


def test_train_capture_holds_the_backward_and_the_recompute(train_captures):
    """Two flash launches a layer (the forward and the recompute), the
    attention backward, and the in-place AdamW update of every leaf."""
    cfg, _, _, port, _ = train_captures
    nodes = list(port.graph.graph.nodes)
    flash = torch.ops.repro_torch.flash_attention.default
    assert sum(n.target is flash for n in nodes) == 2 * cfg.num_layers
    assert sum(n.target is torch.ops.aten._softmax_backward_data.default
               for n in nodes) == cfg.num_layers
    n_leaves = len(tree_leaves(build_model(cfg).param_specs()))
    assert sum(n.target is torch.ops.aten.sqrt_.default for n in nodes) == n_leaves


# -- the trainer (tests/test_fault_tolerance.py on the port) ----------------

def _tiny_run_cfg(tmp_path, total=8, every=2, accum=1):
    shape = C.ShapeConfig("tiny_train", 32, 4, "train")
    train = C.TrainConfig(total_steps=total, warmup_steps=2,
                          checkpoint_every=every, keep_checkpoints=2,
                          checkpoint_dir=str(tmp_path), learning_rate=1e-3,
                          accum_steps=accum)
    return C.RunConfig(model=C.get("llama3-8b").smoke, shape=shape, mesh=C.SMOKE_MESH,
                       train=train)


def test_train_loop_loss_decreases(tmp_path):
    """From the reference's own initial state (saved in its format, resumed
    by the port's trainer) on the same synthetic stream: the loss falls, and
    follows the reference trainer's losses within 0.1 (bf16: the port keeps
    the attention probabilities in fp32, where the reference rounds them to
    bf16; measured 0.067).  With its own random init the port's first ten
    steps are too noisy at lr 1e-3 to show a fall (a torch.Generator draws
    other weights than jax.random)."""
    from repro.checkpoint.store import save as ref_save
    from repro.runtime.steps import init_train_state as ref_init_train_state
    from repro.runtime.trainer import Trainer as RefTrainer
    rc = _tiny_run_cfg(tmp_path / "a", total=10)
    ref_rc = RC.RunConfig(
        model=RC.get("llama3-8b").smoke, shape=RC.ShapeConfig("tiny_train", 32, 4, "train"),
        mesh=RC.SMOKE_MESH, train=RC.TrainConfig(
            total_steps=10, warmup_steps=2, checkpoint_every=2, keep_checkpoints=2,
            checkpoint_dir=str(tmp_path / "ref"), learning_rate=1e-3))
    ref_save(str(tmp_path / "a"), 0, ref_init_train_state(ref_rc, jax.random.key(0)))
    want = RefTrainer(ref_rc, use_mesh=False).train().losses
    report = Trainer(rc, use_mesh=False, device="cpu").train()
    assert report.steps_done == 10
    assert report.checkpoints >= 4
    first3, last3 = np.mean(report.losses[:3]), np.mean(report.losses[-3:])
    assert last3 < first3, f"loss did not fall: {first3} -> {last3}"
    assert np.abs(np.array(report.losses) - np.array(want)).max() < 0.1


def test_failure_recovery_resumes_from_checkpoint(tmp_path):
    rc = _tiny_run_cfg(tmp_path / "b", total=8, every=2)
    plan = FailurePlan(failures={4: 0})
    report = Trainer(rc, use_mesh=False, failure_plan=plan, device="cpu").train()
    assert report.restarts == 1
    # steps 0..4 ran, failure, restore from the step-4 checkpoint, re-run 4..8
    assert report.steps_done >= 8
    assert list_steps(str(tmp_path / "b"))[-1] == 8


def test_straggler_detection(tmp_path):
    rc = _tiny_run_cfg(tmp_path / "c", total=10, every=100)
    plan = FailurePlan(stragglers={7: 30.0}, simulated=True)
    report = Trainer(rc, use_mesh=False, failure_plan=plan, straggler_factor=3.0,
                     device="cpu").train()
    assert report.slow_steps >= 1, "injected straggler not detected"


def test_elastic_rescale_on_simulated_clock(tmp_path):
    rc = _tiny_run_cfg(tmp_path / "e", total=8, every=2)
    plan = FailurePlan(stragglers={2: 30.0, 6: 45.0}, simulated=True)
    plan.add_failure(5)
    plan.add_failure(5)            # simultaneous: losses accumulate
    assert plan.failures == {5: 2}
    report = Trainer(rc, use_mesh=False, failure_plan=plan, straggler_factor=3.0,
                     device="cpu").train()
    assert report.restarts == 1    # one failure event, two devices lost
    assert report.steps_done >= 8
    assert report.slow_steps >= 1
    assert list_steps(str(tmp_path / "e"))[-1] == 8


def test_grad_accum_matches_no_accum(tmp_path):
    rc1 = _tiny_run_cfg(tmp_path / "d1", total=1, accum=1)
    rc2 = _tiny_run_cfg(tmp_path / "d2", total=1, accum=2)
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.integers(0, rc1.model.vocab_size, (4, 32)).astype(np.int32))
    batch = {"tokens": tok, "labels": tok}
    s1, m1 = train_bundle(rc1).fn(init_train_state(rc1, 0, "cpu"), batch)
    s2, m2 = train_bundle(rc2).fn(init_train_state(rc2, 0, "cpu"), batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 2e-2
    w1, w2 = tree_leaves(s1.master)[0], tree_leaves(s2.master)[0]
    np.testing.assert_allclose(w1.numpy(), w2.numpy(), rtol=2e-2, atol=2e-4)


def test_async_checkpoint_holds_the_state_of_its_step(tmp_path, monkeypatch):
    """An asynchronous save of a CPU state is not torn by the next step's
    in-place update: the writer is held until that step has run, and the
    checkpoint restores leaf for leaf to the state as it was at the save."""
    import threading

    from repro_torch.checkpoint import store
    from repro_torch.optim import abstract_state
    rc = _tiny_run_cfg(tmp_path, total=2)
    step_fn = train_bundle(rc).fn
    rng = np.random.default_rng(3)
    tok = torch.from_numpy(rng.integers(0, rc.model.vocab_size, (2, 4, 32)).astype(np.int32))
    state, _ = step_fn(init_train_state(rc, 0, "cpu"), {"tokens": tok[0], "labels": tok[0]})
    want = [t.clone() for part in state for t in tree_leaves(part)]
    stepped = threading.Event()
    savez = store.np.savez

    def held_savez(*args, **kwargs):
        assert stepped.wait(60)
        return savez(*args, **kwargs)

    monkeypatch.setattr(store.np, "savez", held_savez)
    manager = store.CheckpointManager(str(tmp_path), every=1, async_write=True)
    assert manager.maybe_save(1, state)
    state, _ = step_fn(state, {"tokens": tok[1], "labels": tok[1]})
    stepped.set()
    manager.wait()
    got = store.restore(str(tmp_path), 1, abstract_state(build_model(rc.model).abstract()))
    got = [t for part in got for t in tree_leaves(part)]
    now = [t for part in state for t in tree_leaves(part)]
    assert len(got) == len(want) == len(now)
    moved = 0
    for a, b, c in zip(got, want, now):
        assert a.dtype == b.dtype and torch.equal(a, b)
        moved += not torch.equal(b, c)
    assert moved > 0, "the second step changed nothing: the test would not see a torn save"


def test_trainer_restores_a_checkpoint_the_reference_wrote(tmp_path):
    """The store's format is the reference's: a state the reference saved
    is resumed by the port's trainer, leaf for leaf."""
    from repro.checkpoint.store import save as ref_save
    ref_rc, rc = _run_cfgs("qwen1.5-4b", b=4, s=32)
    st = _np_state(ref_build_model(ref_rc.model).param_specs(), np.random.default_rng(7),
                   step=6)
    ref_save(str(tmp_path), 6, jax.tree.map(jnp.asarray, st))
    rc = dataclasses.replace(rc, train=dataclasses.replace(
        rc.train, checkpoint_dir=str(tmp_path), total_steps=6))
    trainer = Trainer(rc, use_mesh=False, device="cpu")
    state, start = trainer._init_or_restore()
    assert start == 6 and int(state.step) == 6
    _trees_close(state.v, st.v, 0.0)
    assert trainer.train().steps_done == 0


def test_launch_train_smoke_on_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen1.5-4b",
         "--smoke", "--device", "cpu", "--steps", "4", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("done: steps=4 final_loss=")
    assert out.stdout.strip().endswith("restarts=0")


def test_launch_train_without_a_ckpt_dir_starts_fresh(capsys):
    """Without ``--ckpt-dir`` a rerun does not resume the last run's steps."""
    for _ in range(2):
        assert launch_train.main(["--arch", "qwen1.5-4b", "--smoke", "--device", "cpu",
                                  "--steps", "2"]) == 0
        assert capsys.readouterr().out.startswith("done: steps=2 final_loss=")


def test_launch_train_full_path_waits_for_a_mesh(tmp_path):
    """The full path trains on a mesh, after an up-front check that its
    devices hold the step: train_4k's batch of 256 at qwen1.5-4b (63.2 GB of
    state and 214.7 GB of saved layer inputs) is refused before any weight
    is drawn, naming the bytes."""
    with pytest.raises(MemoryError, match=r"needs at least 278\.0 GB a device on a "
                                          r"1-device mesh"):
        launch_train.main(["--arch", "qwen1.5-4b", "--device", "cpu", "--steps", "1",
                           "--ckpt-dir", str(tmp_path)])
    rc = dataclasses.replace(_run_cfgs("qwen1.5-4b")[1], model=C.get("qwen1.5-4b").full,
                             shape=C.TRAIN_4K, mesh=C.SINGLE_POD_MESH)
    assert launch_train.step_bytes(rc) / 256 < 16e9      # the production mesh holds it
    assert launch_train.mesh_for(1, False) == C.SMOKE_MESH
    assert launch_train.mesh_for(8, False).shape == (1, 8)
    assert launch_train.mesh_for(512, True) == C.MULTI_POD_MESH


def test_flash_backward_in_pieces_equals_the_whole(monkeypatch):
    """The flash op's backward, recomputed one (sequence, head group) at a
    time, gives attention_ref's gradients of the whole tensors (GQA group
    2, pieces of 1 kv head forced by a small score budget)."""
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.kernels.flash_attention import ops
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 4, 24, 16), (2, 2, 24, 16), (2, 2, 24, 16)))
    g = torch.from_numpy(rng.standard_normal((2, 4, 24, 16)).astype(np.float32))
    monkeypatch.setattr(ops, "BACKWARD_SCORE_BYTES", 4 * 2 * 24 * 24)
    assert ops.backward_pieces(2, 2, 2, 24, 24) == [(0, 0, 1), (0, 1, 1), (1, 0, 1), (1, 1, 1)]
    mine = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    (flash_attention(*mine, causal=True, window=8) * g).sum().backward()
    (attention_ref(*ref, causal=True, window=8) * g).sum().backward()
    for a, b in zip(mine, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b,kvh,group,s,expect", [
    (1, 20, 1, 4096, [(0, 0, 8), (0, 8, 8), (0, 16, 4)]),   # qwen1.5-4b at s 4096
    (2, 8, 2, 2048, [(0, 0, 8), (1, 0, 8)]),
    (1, 1, 1, 20000, [(0, 0, 1)])])                          # one head over budget
def test_backward_pieces_cover_every_head(b, kvh, group, s, expect):
    from repro_torch.kernels.flash_attention.ops import backward_pieces
    assert backward_pieces(b, kvh, group, s, s) == expect


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "gemma3-27b", "qwen3-moe-30b-a3b",
                                  "dbrx-132b", "internvl2-2b", "zamba2-7b", "rwkv6-1.6b",
                                  "seamless-m4t-large-v2"])
def test_analysis_cli_simulates_an_lm_train_step(arch, capsys):
    """``python -m repro_torch.analysis <lm>`` captures the train step at
    --seq-len x --batch from abstract inputs and reconciles its buckets."""
    from repro_torch.analysis.__main__ import main
    assert main([arch, "--device", "cpu", "--seq-len", "32", "--batch", "2"]) == 0
    out = capsys.readouterr()
    assert f"== {arch}: modeled step" in out.out
    assert "seq=32, batch=2" in out.err
    assert "max rel error 0.000%" in out.out
