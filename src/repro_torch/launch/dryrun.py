"""Multi-pod dry-run: prove the distribution config is coherent without a
cluster.

The port of ``repro.launch.dryrun``.  For every (architecture x input
shape) cell this traces one rank's step function on the production meshes:

    single-pod:  (16, 16)      axes (data, model)        = 256 ranks
    multi-pod:   (2, 16, 16)   axes (pod, data, model)   = 512 ranks

under a fake process group of that many ranks (no device, no network: every
collective returns a fake tensor), on fake DTensors laid out as the step
bundle's ``in_shardings`` say.  ``make_fx`` records rank 0's program: its
share of every product and the functional collectives DTensor inserts.
The capture frontend (``core/capture.py``) emits that as HLO text, with
``replica_groups`` from each collective's process group, and the
simulator's IR parser, collective census and engine (on the ``h100``
spec, where the reference's prices its default TPU) read it, as the
reference reads XLA's partitioned HLO.  The memory record is the
counterpart of ``memory_analysis()``: arguments (rank 0's shards of the
inputs), outputs, temporaries (the peak of the trace's live allocations,
views and in-place results counted once) and the bytes outputs alias their
inputs by (the step's in-place state or cache).  There is no compile:
``trace_s`` takes the place of the reference's ``lower_s`` and
``compile_s``.  Artifacts land in
``experiments/dryrun_torch/<arch>.<shape>.<mesh>.json``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--save-hlo]

It runs on the host's CPU only, as the reference's does.  DTensor moves a
split from one dim to another with an all-to-all on a GPU mesh but, on a
CPU mesh (gloo has no all-to-all), as an all-gather and a slice: the trace
runs the GPU mesh's all-to-all (:func:`gpu_alltoall`), so the census and
the temporaries are those of the program NCCL ranks run.

A config of more than two repeats of its layer pattern (a dense model's
layer, gemma3's window/global cycle, zamba2's Mamba2 group) is traced at 1
and 2 repeats, and at 2 and 3 microbatches where the step has 3 or more,
and the record extended to its depth and microbatch count
(:func:`extrapolate`); any other is traced whole.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import operator
import os
import sys
import time
import traceback
from typing import Any, Dict, List, Tuple

import torch

from repro_torch import config as C
from repro_torch.launch.mesh import make_production_mesh, production_mesh_config
from repro_torch.runtime.steps import bundle_for

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def start_fake_group(world: int) -> None:
    """A fake default process group of ``world`` ranks, this process rank
    0 (an existing group of another size is destroyed first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


@contextlib.contextmanager
def gpu_alltoall():
    """DTensor's move of a split between dims as a GPU mesh runs it, one
    ``shard_dim_alltoall`` over the mesh dim's group, also on a CPU mesh
    (where DTensor would gather the dim whole and slice it)."""
    import torch.distributed.tensor.placement_types as pt

    def alltoall(x, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            x, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)
    saved = pt.shard_dim_alltoall
    pt.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        pt.shard_dim_alltoall = saved


def _is_layout(x: Any) -> bool:
    return x is None or (isinstance(x, tuple) and len(x) == 2
                         and hasattr(x[0], "mesh_dim_names"))


def trace_bundle(bundle) -> Tuple[torch.fx.GraphModule, int]:
    """Rank 0's program of a mesh bundle, traced by ``make_fx`` on fake
    local shards, and the bytes of those shards (the arguments)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils._pytree import tree_flatten, tree_unflatten

    leaves, spec = tree_flatten(bundle.abstract_inputs)
    layouts, _ = tree_flatten(bundle.in_shardings, is_leaf=_is_layout)
    if len(layouts) != len(leaves):
        raise ValueError(f"{len(leaves)} inputs but {len(layouts)} layouts")
    # shapes first: DTensor's shard arithmetic cannot run under a fake mode
    metas = [None if not isinstance(t, torch.Tensor) or lay is None else
             (lay[0], lay[1], t.shape, t.stride(),
              compute_local_shape_and_global_offset(t.shape, lay[0], lay[1])[0])
             for t, lay in zip(leaves, layouts)]
    with FakeTensorMode():
        args = [t if not isinstance(t, torch.Tensor) else
                torch.empty(t.shape if m is None else m[4], dtype=t.dtype)
                for t, m in zip(leaves, metas)]
    idx = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
    arg_bytes = sum(args[i].numel() * args[i].element_size() for i in idx)

    def step(*tensors):
        full = list(args)
        for i, t in zip(idx, tensors):
            m = metas[i]
            full[i] = t if m is None else DTensor.from_local(
                t, m[0], m[1], run_check=False, shape=m[2], stride=m[3])
        out, _ = tree_flatten(bundle.fn(*tree_unflatten(full, spec)))
        return [o.to_local() if isinstance(o, DTensor) else o for o in out
                if isinstance(o, torch.Tensor)]

    with gpu_alltoall():
        gm = make_fx(step, tracing_mode="fake")(*[args[i] for i in idx])
    _prune(gm)
    return gm, arg_bytes


def _roots(nodes) -> Dict[torch.fx.Node, torch.fx.Node]:
    """Each node's storage: itself, or for a view or in-place result the
    storage of its first input."""
    root: Dict[torch.fx.Node, torch.fx.Node] = {}
    for n in nodes:
        if n.op == "call_function" and _is_alias(n) and n.args and \
                isinstance(n.args[0], torch.fx.Node):
            root[n] = root.get(n.args[0], n.args[0])
        else:
            root[n] = n
    return root


def _prune(gm: torch.fx.GraphModule) -> None:
    """Drop what neither the outputs nor the inputs' in-place updates need.
    Some DTensor versions trace each wrapper they make as an allocation of
    the global shape, with views and in-place updates of it that nothing
    reads; an in-place update stays where what it updates is needed."""
    nodes = list(gm.graph.nodes)
    root = _roots(nodes)
    live = set()

    def mark(n):
        stack = [n]
        while stack:
            m = stack.pop()
            if m not in live:
                live.add(m)
                stack.extend(m.all_input_nodes)
    mark(nodes[-1])
    for n in nodes:
        if n.op == "placeholder":
            mark(n)
    updates = [n for n in nodes if n.op == "call_function" and n.args
               and isinstance(n.args[0], torch.fx.Node)
               and getattr(getattr(n.target, "_schema", None), "name", "").endswith("_")]
    grew = True
    while grew:
        grew = False
        for n in updates:
            if n not in live and root[n] in live:
                mark(n)
                grew = True
    for n in reversed(nodes):
        if n.op == "call_function" and n not in live and not n.users:
            gm.graph.erase_node(n)
    gm.recompile()


def _bytes(val: Any) -> int:
    if isinstance(val, torch.Tensor):
        return val.numel() * val.element_size()
    if isinstance(val, (list, tuple)):
        return sum(_bytes(v) for v in val)
    return 0


def _is_alias(node: torch.fx.Node) -> bool:
    """Whether a node's value is (a view of) its first input's storage: a
    view, an in-place op, a wait on a collective or a part of a split."""
    from repro_torch.core.capture import _SIMPLE
    t = node.target
    if t is operator.getitem:
        src = node.args[0]
        return isinstance(src, torch.fx.Node) and _is_alias(src)
    if _SIMPLE.get(t) == "bitcast":
        aten = torch.ops.aten
        return t not in (aten.empty.memory_format, aten.empty_like.default,
                         aten.empty_strided.default, aten.new_empty.default,
                         aten.new_empty_strided.default)
    name = getattr(getattr(t, "_schema", None), "name", "")
    return name.endswith("_") or name.endswith("wait_tensor")


def memory_record(gm: torch.fx.GraphModule) -> Dict[str, int]:
    """(output, temporary, alias) bytes of a traced step: every allocation
    lives from its node to the last use of it or of any view of it; the
    temporaries are the peak of those that are not outputs; the aliased
    bytes are the outputs that are (views of) inputs."""
    nodes = list(gm.graph.nodes)
    pos = {n: i for i, n in enumerate(nodes)}
    root = _roots(nodes)
    last: Dict[torch.fx.Node, int] = {}
    for n in nodes:
        for a in n.all_input_nodes:
            r = root[a]
            last[r] = max(last.get(r, 0), pos[n])
    out_node = nodes[-1]
    outs = {root[a] for a in out_node.all_input_nodes}
    out_bytes = sum(_bytes(a.meta.get("val")) for a in out_node.all_input_nodes)
    alias = sum(_bytes(a.meta.get("val")) for a in out_node.all_input_nodes
                if root[a].op == "placeholder")
    events: List[Tuple[int, int]] = []
    for n in nodes:
        if n.op != "call_function" or root[n] is not n or n in outs:
            continue
        size = _bytes(n.meta.get("val"))
        if size:
            events.append((pos[n], size))
            events.append((last.get(n, pos[n]) + 1, -size))
    live = peak = 0
    for _, delta in sorted(events):
        live += delta
        peak = max(peak, live)
    return {"output_bytes": out_bytes, "temp_bytes": peak, "alias_bytes": alias}


def _local_bytes(tree: Any, layouts: Any) -> int:
    """Rank 0's bytes of a tree of meta tensors laid out as ``layouts``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.utils._pytree import tree_flatten
    leaves, _ = tree_flatten(tree)
    lays, _ = tree_flatten(layouts, is_leaf=_is_layout)
    total = 0
    for t, lay in zip(leaves, lays):
        if not isinstance(t, torch.Tensor):
            continue
        shape = t.shape if lay is None else \
            compute_local_shape_and_global_offset(t.shape, lay[0], lay[1])[0]
        n = 1
        for d in shape:
            n *= int(d)
        total += n * t.element_size()
    return total


def measure(run_cfg: C.RunConfig, mesh, save_hlo: str = "") -> dict:
    """One traced step's record: trace seconds, memory, cost, collective
    census, IR census and totals, and the engine's summary."""
    from repro_torch.core.capture import emit_graph
    from repro_torch.core.engine import Engine
    from repro_torch.core.hlo_ir import parse_hlo_module, summarize_collectives
    from repro_torch.core.hw import H100

    t0 = time.time()
    bundle = bundle_for(run_cfg, mesh)
    gm, arg_bytes = trace_bundle(bundle)
    hlo_text, _ = emit_graph(gm)
    t_trace = time.time() - t0
    if save_hlo:
        import gzip
        with gzip.open(save_hlo, "wt") as f:
            f.write(hlo_text)
    mem = memory_record(gm)
    params = bundle.abstract_inputs[0]
    params_sh = bundle.in_shardings[0]
    if run_cfg.shape.kind == "train":
        params, params_sh = params.params, params_sh.params
    module = parse_hlo_module(hlo_text)
    totals = module.totals()
    return {
        "trace_s": round(t_trace, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": mem["output_bytes"],
            "temp_bytes": mem["temp_bytes"],
            "alias_bytes": mem["alias_bytes"],
            "code_bytes": 0,          # eager kernels: no program is generated
            "param_bytes": _local_bytes(params, params_sh),
            # per-device live-bytes upper bound: args + temps (aliased args re-used)
            "per_device_bytes": (arg_bytes + mem["temp_bytes"] + mem["output_bytes"]
                                 - mem["alias_bytes"]),
        },
        "cost": {"flops": totals["mxu_flops"] + totals["vpu_flops"],
                 "transcendentals": totals["trans_flops"],
                 "bytes accessed": totals["hbm_bytes"]},
        "collectives": summarize_collectives(module),
        "ir_ops": module.op_census(),
        "ir_totals": totals,
        "engine": Engine(hw=H100).simulate(module).summary(),
    }


#: fields that are not sums over the step's ops: taken from the largest
#: traced point, not extrapolated
_NOT_ADDITIVE = {"max_group", "mfu", "hbm_utilization", "peak_hbm_fraction",
                 "spill_fraction", "trace_s"}


def _period(cfg: C.ModelConfig) -> Tuple[int, int]:
    """(layers a repeat of the layer pattern holds, layers past the last
    whole repeat): gemma3's window/global cycle, zamba2's Mamba2 group."""
    p = cfg.global_every if cfg.global_every > 0 else (
        cfg.attn_every if cfg.family == "hybrid" else 1)
    if cfg.family in ("audio", "encdec") and cfg.encoder_layers != cfg.num_layers:
        raise ValueError("extrapolation needs as many encoder layers as decoder layers")
    return p, cfg.num_layers % p


def _cut(run_cfg: C.RunConfig, repeats: int, micro: int) -> C.RunConfig:
    """``run_cfg`` at ``repeats`` repeats of its layer pattern and ``micro``
    microbatches of its microbatch size."""
    cfg = run_cfg.model
    p, rest = _period(cfg)
    layers = repeats * p + rest
    model = dataclasses.replace(cfg, num_layers=layers, **(
        {"encoder_layers": layers} if cfg.family in ("audio", "encdec") else {}))
    accum = max(run_cfg.train.accum_steps, 1)
    per_micro = run_cfg.shape.global_batch // accum
    shape = dataclasses.replace(run_cfg.shape, global_batch=per_micro * micro)
    return dataclasses.replace(run_cfg, model=model, shape=shape,
                               train=dataclasses.replace(run_cfg.train, accum_steps=micro))


def _fit(points: Dict[Tuple[int, int], Any], x: int, a: int) -> Any:
    """Each number of the records, extended from the traced (repeats,
    microbatches) points to (x, a): linear in each, bilinear across
    (every microbatch runs every layer)."""
    (x1, a1), (x2, a2) = min(points), max(points)
    f11, f22 = points[(x1, a1)], points[(x2, a2)]
    f21, f12 = points.get((x2, a1), f22), points.get((x1, a2), f11)

    def one(v11, v21, v12, v22, key=""):
        if isinstance(v22, dict):
            keys = set(v22) | set(v11)
            return {k: one(v11.get(k, 0), v21.get(k, 0), v12.get(k, 0), v22.get(k, 0), k)
                    for k in keys}
        if key in _NOT_ADDITIVE or not isinstance(v22, (int, float)) or isinstance(v22, bool):
            return v22
        u = (x - x1) / (x2 - x1)
        w = (a - a1) / (a2 - a1) if a2 != a1 else 0.0
        val = v11 + u * (v21 - v11) + w * (v12 - v11) + u * w * (v22 - v21 - v12 + v11)
        return int(round(val)) if isinstance(v22, int) else val
    return one(f11, f21, f12, f22)


def extrapolate(run_cfg: C.RunConfig, mesh) -> dict:
    """The step's record from traces of the same step cut to 1 and 2
    repeats of its layer pattern (and, with 3 or more microbatches, 2 and 3
    of them), extended to the config's depth and microbatch count: every
    repeat and every microbatch adds the same ops.  The temporaries' peak
    is extended the same way: each repeat adds its saved activations, and
    each microbatch a few scalars kept to the step's end."""
    p, rest = _period(run_cfg.model)
    full_x = (run_cfg.model.num_layers - rest) // p
    accum = max(run_cfg.train.accum_steps, 1)
    micros = (2, 3) if accum >= 3 else (accum,)
    points, spent = {}, 0.0
    for x in (1, 2):
        for a in micros:
            rec = measure(_cut(run_cfg, x, a), mesh)
            spent += rec["trace_s"]
            points[(x, a)] = rec
    out = _fit(points, full_x, accum)
    m = out["memory"]
    m["per_device_bytes"] = (m["argument_bytes"] + m["temp_bytes"] + m["output_bytes"]
                             - m["alias_bytes"])
    out["trace_s"] = round(spent, 2)
    out["extrapolated_from"] = [[x * p + rest, a] for x, a in sorted(points)]
    return out


def _repeats(cfg: C.ModelConfig) -> int:
    """Whole repeats of the layer pattern, or 0 where the record cannot be
    extended over them (an encoder of another depth than its decoder)."""
    try:
        p, rest = _period(cfg)
    except ValueError:
        return 0
    return (cfg.num_layers - rest) // p


def record(run_cfg: C.RunConfig, mesh, save_hlo: str = "") -> dict:
    """The step's record: extended from cut traces where the config has
    more than two repeats of its layer pattern, else traced whole."""
    if _repeats(run_cfg.model) > 2:
        return extrapolate(run_cfg, mesh)
    return measure(run_cfg, mesh, save_hlo=save_hlo)


def cell_config(arch: str, shape_name: str, multi_pod: bool) -> C.RunConfig:
    """A cell's run config: the arch's full config on the production mesh,
    with its own microbatch count."""
    entry = C.get(arch)
    train_cfg = dataclasses.replace(C.TrainConfig(), accum_steps=entry.accum_steps)
    return C.RunConfig(model=entry.full, shape=C.SHAPES_BY_NAME[shape_name],
                       mesh=production_mesh_config(multi_pod=multi_pod), train=train_cfg)


def run_cell(arch: str, shape_name: str, multi_pod: bool, save_hlo: bool = False,
             quiet: bool = False) -> dict:
    entry = C.get(arch)
    shape = C.SHAPES_BY_NAME[shape_name]
    reason = entry.skip_reason(shape)
    if reason is not None:
        return {"arch": arch, "shape": shape_name, "skipped": reason}

    run_cfg = cell_config(arch, shape_name, multi_pod)
    mesh_cfg = run_cfg.mesh
    start_fake_group(mesh_cfg.num_devices)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    tag = "x".join(map(str, mesh_cfg.shape))
    os.makedirs(ART_DIR, exist_ok=True)
    stem = os.path.join(ART_DIR, f"{arch}.{shape_name}.{tag}")
    rec = record(run_cfg, mesh, save_hlo=stem + ".hlo.gz" if save_hlo else "")
    result = {"arch": arch, "shape": shape_name, "mesh": tag,
              "num_devices": mesh_cfg.num_devices, "kind": shape.kind, "engine_hw": "h100",
              "accum_steps": entry.accum_steps, **rec}
    if not quiet:
        by_kind = {k: v["bytes"] for k, v in result["collectives"]["by_kind"].items()}
        how = (f" (extrapolated from layers x microbatches {result['extrapolated_from']})"
               if "extrapolated_from" in result else "")
        print(f"[dryrun] {arch} {shape_name} mesh={tag} trace={result['trace_s']:.1f}s "
              f"per_dev={result['memory']['per_device_bytes'] / 2**30:.2f}GiB{how}")
        print(f"  memory: {json.dumps(result['memory'])}")
        print(f"  collectives: {result['collectives']['count']} ops, "
              f"{result['collectives']['total_bytes']:.4e} bytes; by kind {json.dumps(by_kind)}")
        print(f"  ir: mxu_flops={result['ir_totals']['mxu_flops']:.4e} "
              f"hbm_bytes={result['ir_totals']['hbm_bytes']:.4e}; engine "
              f"total_seconds={result['engine']['total_seconds']:.6e}")
    with open(stem + ".json", "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--save-hlo", action="store_true",
                    help="also write the traced HLO (of a step traced whole)")
    ap.add_argument("--skip-lenet", action="store_true", default=True,
                    help="taken, as the reference's CLI takes it; LeNet has no "
                         "production-mesh cell, so --all never runs it")
    args = ap.parse_args(argv)
    if not args.all and not args.arch:
        ap.error("give --arch (and --shape), or --all")

    cells = []
    if args.all:
        for entry, shape, _ in C.iter_cells():
            if entry.arch_id == "lenet":
                continue
            cells.append((entry.arch_id, shape.name))
    else:
        shapes = [args.shape] if args.shape else [s.name for s in C.STANDARD_SHAPES]
        cells = [(args.arch, s) for s in shapes]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    try:
        for arch, shape_name in cells:
            for mp in meshes:
                try:
                    run_cell(arch, shape_name, mp, save_hlo=args.save_hlo)
                except Exception:
                    traceback.print_exc()
                    failures.append((arch, shape_name, mp))
                gc.collect()
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    if failures:
        print(f"FAILED cells: {failures}")
        return 1
    print("dry-run OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
