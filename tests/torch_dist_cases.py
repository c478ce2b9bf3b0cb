"""Multi-process cases of ``tests/test_torch_distributed.py``: four gloo
ranks on the CPU, one process each.

    python tests/torch_dist_cases.py <case> <dir>

reads its inputs from ``<dir>/in.npz`` (written by the test), runs the
case on every rank and has rank 0 write ``<dir>/out.pt``.  Every rank
starts its process group with a timeout, so a rank that dies cannot hang
the others past it.  No jax here: the test computes the reference's side.
"""
import dataclasses
import datetime
import os
import socket
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
ARCH = "llama3-8b"
TRAIN = dict(warmup_steps=2, total_steps=10, learning_rate=1e-2)


def _tree(flat, prefix):
    """A nested dict of tensors from npz keys ``prefix/a/b``."""
    out = {}
    for key, val in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def _mesh(shape, names):
    from repro_torch import config as C
    from repro_torch.distributed.mesh import build_mesh
    return build_mesh(C.MeshConfig(shape, names), device="cpu")


def _full(tree):
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


def _run_cfg(batch, seq, mesh_shape=(2, 2), **train):
    from repro_torch import config as C
    cfg = dataclasses.replace(C.get(ARCH).smoke, dtype="float32")
    return C.RunConfig(model=cfg, shape=C.ShapeConfig("t", seq, batch, "train"),
                       mesh=C.MeshConfig(mesh_shape, ("data", "model")),
                       train=C.TrainConfig(**{**TRAIN, **train}))


def case_compression(rank, inp):
    from repro_torch.distributed.compression import compressed_grad_mean, compressed_psum_mean
    mesh = _mesh((WORLD,), ("data",))
    x = torch.from_numpy(inp["xs"][rank])
    out = compressed_psum_mean(x, mesh, "data")
    rows = [torch.empty_like(out) for _ in range(WORLD)]
    dist.all_gather(rows, out)
    # error feedback: a residual carried in, the new residual what the
    # compressed mean missed of the gradient with it
    resid = torch.full_like(x, 0.01)
    reduced, new_err = compressed_grad_mean({"g": {"x": x}}, mesh, "data",
                                            errors={"g": {"x": resid}})
    plain, none = compressed_grad_mean({"g": {"x": x}}, mesh, "data")
    return {"out": torch.stack(rows), "with_feedback": reduced["g"]["x"],
            "feedback_want": compressed_psum_mean(x + resid, mesh, "data"),
            "new_err": new_err["g"]["x"], "x_plus_resid": x + resid,
            "plain": plain["g"]["x"], "no_errors": none is None}


def case_pipeline(rank, inp):
    from repro_torch.distributed.pipeline import pipeline_apply
    mesh = _mesh((WORLD,), ("pod",))
    ws = torch.from_numpy(inp["ws"]).requires_grad_()
    x = torch.from_numpy(inp["x"])
    out = pipeline_apply(lambda w, xm: torch.tanh(xm @ w), ws, x, mesh=mesh, axis="pod")
    grad, = torch.autograd.grad(out.sum(), ws)
    outs = [torch.empty_like(out) for _ in range(WORLD)]
    dist.all_gather(outs, out.detach())
    return {"out": out.detach(), "grad": grad, "same_on_every_rank":
            all(bool(torch.equal(o, outs[0])) for o in outs)}


def case_train(rank, inp):
    """One llama3-8b smoke step on the (2, 2) data x model mesh with fsdp,
    from the reference's state."""
    from repro_torch.distributed.sharding import place
    from repro_torch.models import build_model
    from repro_torch.models.transformer import state_from_jax
    from repro_torch.optim import TrainState
    from repro_torch.runtime.steps import run_rules, train_bundle
    rc = _run_cfg(int(inp["b"]), int(inp["s"]))
    mesh = _mesh((2, 2), ("data", "model"))
    model = build_model(rc.model, rc.sharding)
    rules = run_rules(rc, model)
    st = state_from_jax((inp["step"], *(_tree(inp, k) for k in ("params", "master", "m", "v"))),
                        rc.model)
    axes = model.axes()
    state = TrainState(st.step, *(place(t, axes, rules, mesh) for t in st[1:]))
    _, batch_axes = model.train_input_specs(rc.shape)
    batch = place({k: torch.from_numpy(inp[k]) for k in ("tokens", "labels")},
                  batch_axes, rules, mesh)
    bundle = train_bundle(rc, mesh)
    new, metrics = bundle.fn(state, batch)
    sharded = [type(leaf).__name__ == "DTensor" and any(p.is_shard() for p in leaf.placements)
               for leaf in (new.params["layers"]["attn"]["wq"], new.m["head"])]
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "step": int(new.step),
            "params": _full(new.params), "master": _full(new.master), "m": _full(new.m),
            "v": _full(new.v), "sharded": sharded}


class _Float64:
    """Every float32 the code asks for made float64 (a function mode over
    the step: ``.float()``, ``dtype=torch.float32`` and ``.to(torch.float32)``),
    so a step runs in float64 end to end.  Autograd's recompute of a
    checkpointed unit runs outside the mode, so the step runs without
    recompute meanwhile (the values do not change)."""

    def __init__(self):
        from torch.overrides import TorchFunctionMode

        class Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                kwargs = dict(kwargs or {})
                if func is torch.Tensor.float:
                    return args[0].to(torch.float64)
                if kwargs.get("dtype") is torch.float32:
                    kwargs["dtype"] = torch.float64
                args = tuple(torch.float64 if a is torch.float32 else a for a in args)
                return func(*args, **kwargs)
        self.mode = Mode()

    def __enter__(self):
        from repro_torch.models import layers, transformer
        self.saved = layers.checkpoint, transformer.checkpoint
        layers.checkpoint = transformer.checkpoint = lambda fn, *a, **k: fn(*a)
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers, transformer
        layers.checkpoint, transformer.checkpoint = self.saved
        return self.mode.__exit__(*exc)


def case_train_family(rank, inp):
    """One smoke train step of a family on a data x model mesh (default
    (2, 2)) with fsdp and the same step without a mesh, from the same
    state, in fp32 and (``fp64`` set) in float64: the metrics and the new
    first moments (the gradients, scaled) of both."""
    from repro_torch import config as C
    from repro_torch.data.synthetic import batches_for
    from repro_torch.distributed.sharding import place
    from repro_torch.models import build_model
    from repro_torch.optim import init_state, tree_map
    from repro_torch.runtime.steps import init_train_state, run_rules, train_bundle
    cfg = dataclasses.replace(C.get(str(inp["arch"])).smoke, dtype="float32")
    shape = tuple(int(n) for n in inp.get("mesh", (2, 2)))
    rc = C.RunConfig(model=cfg, shape=C.ShapeConfig("t", 32, 4, "train"),
                     mesh=C.MeshConfig(shape, ("data", "model")),
                     train=C.TrainConfig(**TRAIN))
    mesh = _mesh(shape, ("data", "model"))
    model = build_model(cfg, rc.sharding)
    rules = run_rules(rc, model)
    batch = {k: torch.from_numpy(v) for k, v in next(batches_for(cfg, rc.shape, seed=0)).items()}
    _, batch_axes = model.train_input_specs(rc.shape)
    sharded_batch = place(batch, batch_axes, rules, mesh)
    out = {}
    plain, pm = train_bundle(rc).fn(init_train_state(rc, seed=0, device="cpu"), batch)
    sharded, sm = train_bundle(rc, mesh).fn(init_train_state(rc, seed=0, device="cpu", mesh=mesh),
                                            sharded_batch)
    out["fp32"] = {"metrics": {k: float(v) for k, v in sm.items()},
                   "want_metrics": {k: float(v) for k, v in pm.items()},
                   "m": _full(sharded.m), "want_m": plain.m}
    if not inp.get("fp64", False):
        return out
    def params():   # the step updates its state in place: a fresh copy each
        return tree_map(torch.Tensor.double, init_train_state(rc, seed=0, device="cpu").params)
    with _Float64():
        plain, pm = train_bundle(rc).fn(init_state(params()), batch)
        sharded, sm = train_bundle(rc, mesh).fn(
            init_state(place(params(), model.axes(), rules, mesh)), sharded_batch)
    out["fp64"] = {"metrics": {k: float(v) for k, v in sm.items()},
                   "want_metrics": {k: float(v) for k, v in pm.items()},
                   "m": _full(sharded.m), "want_m": plain.m}
    return out


def case_init(rank, inp):
    """``init_train_state`` on the (2, 2) mesh against the plain one: the
    weights, for each leaf drawn the earlier draws still alive then and
    those alive at the end (kept whole as the rank's own shard), and the
    checkpoint bytes (``tree_nbytes``) of both states."""
    import weakref
    from repro_torch.models import layers
    from repro_torch.runtime.steps import init_train_state
    rc = _run_cfg(4, 32)
    mesh = _mesh((2, 2), ("data", "model"))
    draws, live_at_draw = [], []
    draw = layers._init_one

    def hooked(*args, **kwargs):
        live_at_draw.append([i for i, r in enumerate(draws) if r() is not None])
        t = draw(*args, **kwargs)
        draws.append(weakref.ref(t))
        return t
    layers._init_one = hooked
    try:
        state = init_train_state(rc, seed=0, device="cpu", mesh=mesh)
    finally:
        layers._init_one = draw
    kept = [i for i, r in enumerate(draws) if r() is not None]
    plain = init_train_state(rc, seed=0, device="cpu")
    from repro_torch.faults.pricing import tree_nbytes
    local = sum(t.to_local().numel() * t.element_size() for t in _leaves_of(list(state))
                if type(t).__name__ == "DTensor")
    return {"live_at_draw": live_at_draw, "kept": kept, "n_draws": len(draws),
            "nbytes": tree_nbytes(state), "nbytes_plain": tree_nbytes(plain),
            "local_nbytes": local,
            "params": _full(state.params), "master": _full(state.master),
            "want": plain.params, "sharded": [type(t).__name__ == "DTensor" and any(
                p.is_shard() for p in t.placements) for t in _leaves_of(state.params)]}


def _leaves_of(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_of(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves_of(t)]
    return [tree]


class _Allocations:
    """The bytes of every tensor an op makes in a storage of its own (not a
    view of an input) while it is entered: a dispatch mode, so it sees
    factory calls and collectives."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        outer = self
        self.sizes = []

        def ptr(t):
            try:
                return t.untyped_storage().data_ptr()
            except RuntimeError:    # a wrapper (a collective's result) has no storage
                return None

        def storages(tree):
            return {ptr(t) for t in torch.utils._pytree.tree_leaves(tree)
                    if isinstance(t, torch.Tensor)} - {None}

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                seen = storages((args, kwargs))
                out = func(*args, **kwargs)
                for t in torch.utils._pytree.tree_leaves(out):
                    if isinstance(t, torch.Tensor) and ptr(t) not in seen:
                        outer.sizes.append((t.numel() * t.element_size(), tuple(t.shape)))
                return out
        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def case_save(rank, inp):
    """A sharded llama3-8b smoke state (the (2, 2) mesh, fsdp) saved by rank
    0 and restored resharded: every new tensor each rank made while saving,
    the leaves, and what the restored shards hold."""
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint.store import _flatten, restore_resharded, save
    from repro_torch.optim import TrainState, abstract_state
    from repro_torch.models import build_model
    from repro_torch.runtime.steps import init_train_state, train_bundle
    rc = _run_cfg(4, 32)
    mesh = _mesh((2, 2), ("data", "model"))
    state = init_train_state(rc, seed=0, device="cpu", mesh=mesh)
    with _Allocations() as allocs:
        save(str(inp["dir"]), 1, state)
    dist.barrier()
    like = abstract_state(build_model(rc.model, rc.sharding).abstract())
    back = TrainState(*restore_resharded(str(inp["dir"]), 1, like,
                                         train_bundle(rc, mesh).in_shardings[0]))
    pairs = [(a, b) for (_, a), (_, b) in zip(_flatten(list(state)), _flatten(list(back)),
                                              strict=True)]
    dleaves = [a for a, _ in pairs if isinstance(a, DTensor)]
    sizes = [None] * WORLD
    dist.all_gather_object(sizes, allocs.sizes)
    return {
        "sizes": sizes,
        "local_bytes": [a.to_local().numel() * a.element_size() for a in dleaves],
        "full_shapes": [tuple(a.shape) for a in dleaves],
        "sharded_shapes": [tuple(a.shape) for a in dleaves
                           if any(p.is_shard() for p in a.placements)],
        "n_leaves": len(pairs),
        "same": all(bool(torch.equal(a.to_local(), b.to_local()))
                    if isinstance(a, DTensor) else bool(torch.equal(a, b)) for a, b in pairs),
        "same_layout": all(a.placements == b.placements for a, b in pairs
                           if isinstance(a, DTensor)),
        # a restored shard owns its storage: the whole leaf is not kept
        "own_storage": all(b.to_local().untyped_storage().nbytes()
                           == b.to_local().numel() * b.element_size()
                           for _, b in pairs if isinstance(b, DTensor)),
        "whole": [state.step, *(_full(t) for t in state[1:])],
    }


def case_serve(rank, inp):
    """Prefill and three greedy decode steps on the mesh and without it."""
    from repro_torch import config as C
    from repro_torch.distributed.sharding import place
    from repro_torch.models import build_model
    from repro_torch.models.transformer import params_from_jax
    from repro_torch.runtime.server import Server
    from repro_torch.runtime.steps import decode_bundle, prefill_bundle, run_rules
    cfg = dataclasses.replace(C.get(str(inp["arch"])).smoke, dtype="float32")
    tokens = torch.from_numpy(inp["tokens"]).long()
    b, s = tokens.shape
    shape = tuple(int(n) for n in inp.get("mesh", (2, 2)))
    rc = C.RunConfig(model=cfg, shape=C.ShapeConfig("p", s, b, "prefill"),
                     mesh=C.MeshConfig(shape, ("data", "model")))
    mesh = _mesh(shape, ("data", "model"))
    model = build_model(cfg)
    params = params_from_jax(_tree(inp, "params"), cfg)
    rules = run_rules(rc, model)
    dparams = place(params, model.axes(), rules, mesh)
    batch = {"tokens": tokens}
    if "frontend_emb" in inp:
        batch["frontend_emb"] = torch.from_numpy(inp["frontend_emb"])
    _, axes = model.prefill_input_specs(rc.shape)
    logits, cache = prefill_bundle(rc, mesh).fn(dparams, place(batch, axes, rules, mesh))
    want, pcache = model.prefill(params, batch)
    got, exp = [logits.full_tensor()], [want]
    cache, pcache = Server._grow_cache(cache, 4), Server._grow_cache(pcache, 4)
    step = decode_bundle(rc, mesh).fn
    tok = want.argmax(-1)
    for _ in range(3):
        lg, cache = step(dparams, cache, place({"token": tok}, {"token": ("batch", "seq")},
                                               rules, mesh))
        lp, pcache = model.decode_step(params, pcache, {"token": tok})
        got.append(lg.full_tensor())
        exp.append(lp)
        tok = lp.argmax(-1)
    return {"got": torch.stack(got), "want": torch.stack(exp), "pos": cache["pos"],
            "cache": _full(cache), "cache_want": pcache}


def case_cache_write(rank, inp):
    """``_write_row`` on DTensor caches of every layout against the plain
    write."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.attention import _write_row
    mesh = _mesh((2, 2), ("data", "model"))
    gen = torch.Generator().manual_seed(0)
    full = torch.randn(2, 8, 4, 3, generator=gen)
    new = torch.randn(2, 1, 4, 3, generator=gen)
    bad, checked = [], 0
    for pl in ([Shard(1), Replicate()], [Shard(0), Shard(2)], [Replicate(), Shard(2)],
               [Replicate(), Replicate()]):
        for row in (0, 5, 7):
            cache = distribute_tensor(full.clone(), mesh, pl)
            with implicit_replication():
                _write_row(cache, distribute_tensor(new, mesh, [Replicate(), Replicate()]),
                           torch.tensor([row]))
            want = full.clone()
            want[:, row] = new[:, 0]
            checked += 1
            if not torch.equal(cache.full_tensor(), want):
                bad.append((str(pl), row))
    return {"checked": checked, "bad": bad}


def case_trainer(rank, inp):
    """The trainer on the (2, 2) mesh; a failure at step 3 loses 2 ranks:
    ranks 0 and 1 go on on a (1, 2) mesh from the resharded checkpoint,
    ranks 2 and 3 leave."""
    from repro_torch.runtime.failure import FailurePlan
    from repro_torch.runtime.trainer import Trainer
    rc = _run_cfg(4, 32, checkpoint_every=2, keep_checkpoints=5, total_steps=6,
                  checkpoint_dir=str(inp["ckpt_dir"]), learning_rate=1e-3)
    trainer = Trainer(rc, use_mesh=True, failure_plan=FailurePlan(failures={3: 2}),
                      device="cpu")
    report = trainer.train()
    reports = [None] * WORLD
    dist.all_gather_object(reports, {"restarts": report.restarts,
                                     "steps_done": report.steps_done,
                                     "losses": report.losses,
                                     "final_loss": report.final_loss})
    return {"reports": reports}


def case_trainer_jit(rank, inp):
    """The trainer on the (2, 2) mesh, two steps: each rank builds its step
    through ``StepBundle.jit`` and runs both steps through it."""
    from repro_torch.runtime.jit import Jitted
    from repro_torch.runtime.steps import StepBundle
    from repro_torch.runtime.trainer import Trainer
    made, calls = [], []
    real_jit, real_call = StepBundle.jit, Jitted.__call__

    def spy_jit(self, *args):
        made.append(real_jit(self, *args))
        return made[-1]

    def spy_call(self, *args):
        calls.append(self)
        return real_call(self, *args)

    StepBundle.jit, Jitted.__call__ = spy_jit, spy_call
    try:
        rc = _run_cfg(4, 32, checkpoint_every=0, total_steps=2,
                      checkpoint_dir=str(inp["ckpt_dir"]))
        report = Trainer(rc, use_mesh=True, device="cpu").train()
    finally:
        StepBundle.jit, Jitted.__call__ = real_jit, real_call
    reports = [None] * WORLD
    dist.all_gather_object(reports, {"steps_done": report.steps_done, "made": len(made),
                                     "through_it": sum(c is made[0] for c in calls),
                                     "calls": len(calls)})
    return {"reports": reports}


def _worker(rank, case, directory, port):
    torch.set_num_threads(max(1, (os.cpu_count() or WORLD) // WORLD))   # the cores, shared
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=WORLD, timeout=datetime.timedelta(seconds=120))
        inp = dict(np.load(os.path.join(directory, "in.npz"), allow_pickle=False))
        out = globals()[f"case_{case}"](rank, inp)
        if rank == 0:
            torch.save(out, os.path.join(directory, "out.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)


def main():
    case, directory = sys.argv[1], sys.argv[2]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_worker, args=(case, directory, port), nprocs=WORLD)


if __name__ == "__main__":
    main()
