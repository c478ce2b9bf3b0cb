"""The readings a cell's limits are set from, on the card at the cell's own
size, in one process:

* the program's sound runs over many seeds (the lower readings): the
  cell's timed path, set up once and given each seed's weights in place,
  serves as many requests as a run compares (or takes the first steps),
  and is compared with the reference as a run compares it;
* the control over a few of those seeds (the upper readings): the
  reference put in the program's place, computed in float8 e4m3 (one
  precision below the configuration's bf16: its products' operands and its
  kept activations), held to the fp32 reference by the same numbers; for
  serving, at each position of the same prompts and served tokens, the
  token the control puts first;
* over the same seeds, ``fp8_products``: the reference with its products'
  operands alone in float8, the step to fp8 a faster program would take;
* for training, the faults the cell can have, planted in the reference put
  in the program's place: half of each batch left out (the mean taken over
  the rest).  A state left unchanged reads 1 on ``change_gap``, and so does
  one leaf's update doubled, by the measure itself.

    python3 port_bench/control.py --workload <name> --seeds 1,2,... \\
        --control-seeds 1,2,3 [--out readings.json]

Prints one JSON object: each seed's numbers, the control's and the faults';
``--out`` also keeps, for training, each leaf's norms on every side.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT / "src"))

import harness  # noqa: E402

#: the lower precisions read over the control seeds, by the name they go under
LOWER = {"control": "fp8", "fp8_products": "fp8_products"}


def serve_readings(r, seeds, control_seeds) -> dict:
    import numpy as np
    import torch
    from repro_torch.config import SMOKE_MESH, RunConfig, ShapeConfig
    from repro_torch.runtime.server import Server

    import check
    import port
    import traffic as T
    import weights as W
    cfg, tr, dev = r.config, r.traffic, r.device
    b, s, n = tr["batch"], tr["prompt_len"], tr["new_tokens"]
    rc = RunConfig(model=port.model_config(cfg),
                   shape=ShapeConfig(r.workload["traffic"], s, b, "prefill"), mesh=SMOKE_MESH)
    port.build_kernels(dev)
    params = W.make(cfg, seeds[0], dev)
    server = Server(rc, params, eos_token=-1, temperature=0.0)
    calls = -(-tr["check_requests"] // b)
    served = {}
    for seed in seeds:
        for path, layer, _, init in W.leaves(cfg):
            W.fill_leaf(W.get(params, path, layer), cfg, seed, path, layer, init)
        prompts = [T.prompts(tr, cfg, seed, i, dev) for i in range(calls)]
        outs = [server.generate({"tokens": p}, max_new_tokens=n) for p in prompts]
        rows = [(c, j) for c in range(calls) for j in range(b)]
        pick = check.sample_requests([n] * len(rows), tr["check_requests"], seed)
        served[seed] = (torch.stack([prompts[rows[k][0]][rows[k][1]] for k in pick]).cpu(),
                        np.stack([outs[rows[k][0]][rows[k][1]] for k in pick]))
        harness.log(r, f"served seed {seed}")
    server = params = None
    port.free(dev)
    out = {}
    for seed in seeds:
        prompts, tokens = served[seed]
        prompts = prompts.to(dev)
        ref = check.serve_reference(cfg, seed, prompts, tokens, dev)
        one = {"logit_gap": float(check.gaps(ref, torch.as_tensor(tokens)).max()),
               "logit_std": float(ref.std())}
        if seed in control_seeds:
            for side, lowp in LOWER.items():
                low = check.serve_reference(cfg, seed, prompts, tokens, dev, lowp=lowp)
                one[f"{side}.logit_gap"] = float(check.gaps(ref, low.argmax(-1)).max())
        out[seed] = one
        harness.log(r, f"seed {seed}: {one}")
    return out


def train_readings(r, seeds, control_seeds) -> dict:
    import torch
    from repro_torch.config import SMOKE_MESH, RunConfig, ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.optim import init_state, tree_leaves
    from repro_torch.runtime.steps import train_bundle

    import check
    import port
    import reference
    import traffic as T
    import weights as W
    loop = harness.load_module(BENCH / "loops" / "train.py", "port_bench_loop_train")
    cfg, tr, dev = r.config, r.traffic, r.device
    rc = RunConfig(model=port.model_config(cfg),
                   shape=ShapeConfig(r.workload["traffic"], tr["seq_len"], tr["batch"], "train"),
                   mesh=SMOKE_MESH, train=TrainConfig(**loop.train_config(tr)))
    port.build_kernels(dev)
    state = init_state(W.make(cfg, seeds[0], dev))
    step_fn = train_bundle(rc).jit()
    progs = {}
    for seed in seeds:
        with torch.no_grad():
            for path, layer, _, init in W.leaves(cfg):
                p = W.get(state.params, path, layer)
                W.fill_leaf(p, cfg, seed, path, layer, init)
                W.get(state.master, path, layer).copy_(p)
            for t in tree_leaves(state.m) + tree_leaves(state.v):
                t.zero_()
            state.step.zero_()
        data = DataPipeline(T.lm_batches(tr, cfg, seed), dev)
        box = {"state": state}

        def step():
            box["state"], metrics = step_fn(box["state"], next(data))
            return float(metrics["loss"])
        try:
            progs[seed] = loop.first_steps(cfg, tr, seed, dev, step, lambda: box["state"])
        finally:
            data.close()
        state = box["state"]
        harness.log(r, f"trained seed {seed}: losses {progs[seed]['losses']}")
    state = step_fn = box = step = data = None
    port.free(dev)
    out = {}
    for seed in seeds:
        gen = T.lm_batches(tr, cfg, seed)
        batches = [next(gen) for _ in range(tr["check_steps"])]
        ref = reference.train_steps(cfg, seed, batches, tr["optimizer"], dev)
        one = dict(check.train_numbers(progs[seed], ref))
        one["leaves"] = {"program": progs[seed], "reference": ref}
        if seed in control_seeds:
            half = [{k: v[:len(v) // 2] for k, v in bt.items()} for bt in batches]
            sides = {side: (batches, lowp) for side, lowp in LOWER.items()}
            sides["half_batch"] = (half, None)
            for side, (bts, lowp) in sides.items():
                low = reference.train_steps(cfg, seed, bts, tr["optimizer"], dev, lowp=lowp)
                one.update({f"{side}.{k}": v for k, v in check.train_numbers(low, ref).items()})
                one["leaves"][side] = low
        out[seed] = one
        harness.log(r, f"seed {seed}: { {k: v for k, v in one.items() if k != 'leaves'} }")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(x) for x in args.seeds.split(",")]
    control = {int(x) for x in args.control_seeds.split(",") if x}
    r = harness.prepare(ROOT, BENCH, args.workload, seeds[0], 0.0, False, "cuda", T0)
    fn = serve_readings if r.traffic["loop"] == "serve" else train_readings
    out = {"workload": args.workload, "readings": fn(r, seeds, control)}
    if args.out:
        Path(args.out).write_text(json.dumps(out))
    for one in out["readings"].values():
        one.pop("leaves", None)         # each leaf's norms go to --out alone
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
