"""The training loop as ``Trainer.train`` runs it, without checkpoints:
``train_bundle(...).jit()`` (a CUDA graph on the card) fed by
``DataPipeline``, each step's loss read to the host as the trainer reads it.

Set-up makes the weights from the seed and the first state from them
(``init_state``: fp32 master copies, zero moments), then drives that state
through its first ``check_steps`` steps on the traffic's batches: the first
runs eagerly, the second is captured and replayed.  It reads what the
comparison needs as it happens: the losses, the first step's clipped
gradient (from the first moment, before the second step overwrites it) and
each leaf's change after the last of them (before the window's first step
moves it).  The window then steps the same state until ``--seconds`` have
passed, timing each step from the batch's fetch to its loss on the host,
and the fetch alone.  A traced run profiles ``trace_steps`` more steps.
"""
from __future__ import annotations

import math
import time

import port
import reference
import devtrace as TR
import traffic as T
import weights as W
import check
from harness import log


def train_config(tr) -> dict:
    o = tr["optimizer"]
    return dict(learning_rate=o["learning_rate"], warmup_steps=o["warmup_steps"],
                total_steps=o["total_steps"], weight_decay=o["weight_decay"],
                beta1=o["beta1"], beta2=o["beta2"], eps=o["eps"], grad_clip=o["grad_clip"],
                checkpoint_every=0)


def leaf(tree):
    """The accessor of a state tree's leaves, by path and layer."""
    return lambda path, layer: W.get(tree, path, layer)


def first_steps(cfg, tr, seed, dev, step, state) -> dict:
    """Drive the state through its first ``check_steps`` steps (``step()``
    runs one and returns the loss it read; ``state()`` is the state now)
    and read what the comparison needs as it happens."""
    prog = {"losses": []}
    for i in range(tr["check_steps"]):
        prog["losses"].append(step())
        if i == 0:
            prog["first_grad"] = check.leaf_norms(cfg, leaf(state().m),
                                                  1.0 / (1.0 - tr["optimizer"]["beta1"]))
    prog["change"] = check.program_change(cfg, seed, leaf(state().master), dev)
    return prog


def run(r) -> None:
    from repro_torch.config import SMOKE_MESH, RunConfig, ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.optim import init_state
    from repro_torch.runtime.steps import train_bundle

    cfg, tr, dev = r.config, r.traffic, r.device
    rc = RunConfig(model=port.model_config(cfg),
                   shape=ShapeConfig(r.workload["traffic"], tr["seq_len"], tr["batch"], "train"),
                   mesh=SMOKE_MESH, train=TrainConfig(**train_config(tr)))
    port.build_kernels(dev)
    params = W.make(cfg, r.seed, dev)
    port.check_layout(rc.model, params)
    state = init_state(params)
    params = None
    log(r, "state made")
    step_fn = train_bundle(rc).jit()
    data = DataPipeline(T.lm_batches(tr, cfg, r.seed), dev)

    steps = []

    def step():
        nonlocal state
        t0 = time.perf_counter()
        batch = next(data)
        t1 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        steps.append({"t0": t0, "fetched": t1, "t1": time.perf_counter(), "loss": loss})
        return loss

    try:
        prog = first_steps(cfg, tr, r.seed, dev, step, lambda: state)
        log(r, f"first steps read: losses {prog['losses']}")
        if r.trace:
            r.tracer = TR.Tracer(dev)
            r.tracer.warm()
        port.sync(dev)
        setup = len(steps)

        start = time.perf_counter()
        r.setup_s = start - r.t0
        while True:
            step()
            if steps[-1]["t1"] - start >= r.seconds:
                break
        window = steps[setup:]
        log(r, f"window closed: {len(window)} steps")
        if r.trace:
            with r.tracer.segment():
                for _ in range(tr["trace_steps"]):
                    r.tracer.enter("step")
                    step()
                    r.tracer.leave("step")
        r.memory_peak = port.memory_peak(dev)
    finally:
        data.close()

    r.e2e = {"setup_s": r.setup_s,
             "train_step_ms": 1e3 * (window[-1]["t1"] - start) / len(window)}
    r.records["steps"] = window
    r.attempted = len(steps) - setup
    r.failed = sum(not math.isfinite(s["loss"]) for s in steps[setup:])

    # the check, with the program's state freed
    state = step_fn = data = None
    port.free(dev)
    batches = T.lm_batches(tr, cfg, r.seed)
    ref = reference.train_steps(cfg, r.seed, [next(batches) for _ in range(tr["check_steps"])],
                                tr["optimizer"], dev)
    log(r, "reference done")
    r.records["check"] = {"program": prog, "reference": ref}
    for name, value in check.train_numbers(prog, ref).items():
        r.check(name, value)
