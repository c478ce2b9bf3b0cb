"""The port's dry-run (``python -m repro_torch.launch.dryrun``) on the CPU.

Each case runs in a subprocess: the dry-run starts a fake process group of
4, 256 or 512 ranks, which must not leak into the test process.

* A tiny DTensor program at fake world 4 is captured to HLO whose
  collective census equals the payloads counted by hand, with each
  collective's ``replica_groups`` (or ``source_target_pairs``) the ranks of
  its mesh dim.
  A split moved from one dim to another is one all-to-all, as on a GPU
  mesh, not the all-gather DTensor runs on a CPU mesh.
* llama3-8b decode_32k on the (16, 16) mesh: 256 ranks; rank 0's parameter
  bytes equal each parameter's bytes divided by the sizes of the mesh axes
  its spec names under the reference's own rules; the IR has products,
  collectives and a simulated time.  Its 32 layers are extended from
  traces of 1 and 2: the sums and the memory equal the whole trace's.
* A small train step of 4 microbatches, extended from traces of 1 and 2
  layers and 2 and 3 microbatches, against its whole trace: the sums
  equal, the temporaries' peak within 0.1%.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import config as RC
from repro.distributed.sharding import axes_to_pspec, logical_rules
from repro.models import build_model as ref_build_model

ROOT = Path(__file__).resolve().parents[1]
ART = ROOT / "experiments" / "dryrun_torch"

TINY = r"""
import json, torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch import config as C
from repro_torch.core.capture import emit_graph
from repro_torch.core.hlo_ir import parse_hlo_module, summarize_collectives
from repro_torch.distributed.mesh import build_mesh
from repro_torch.distributed.pipeline import ring_permute
from repro_torch.launch import dryrun as D
from repro_torch.runtime.steps import StepBundle
D.start_fake_group(4)
mesh = build_mesh(C.MeshConfig((2, 2), ("data", "model")), device="cpu")
def fn(x, y):
    a = x.redistribute(mesh, [Replicate(), Replicate()])           # all-gather over data
    p = DTensor.from_local(y.to_local(), mesh, [Partial(), Replicate()])
    b = p.redistribute(mesh, [Replicate(), Replicate()])           # all-reduce over data
    c = p.redistribute(mesh, [Shard(0), Replicate()])              # reduce-scatter over data
    d = ring_permute(a.to_local(), mesh.get_group("model").group_name, 1)
    e = x.redistribute(mesh, [Shard(1), Replicate()])              # all-to-all over data
    return a, b, c, d, e
meta = torch.empty(8, 16, device="meta")
bundle = StepBundle(fn, (meta, meta), ((mesh, (Shard(0), Replicate())),
                                       (mesh, (Replicate(), Replicate()))), None, mesh)
gm, arg_bytes = D.trace_bundle(bundle)
text, _ = emit_graph(gm)
mod = parse_hlo_module(text)
ops = {op.opcode: op.raw for op, _, _ in mod.walk_entry()}
print(json.dumps({"summary": summarize_collectives(mod), "arg_bytes": arg_bytes,
                  "raw": {k: v for k, v in ops.items() if k in (
                      "all-gather", "all-reduce", "reduce-scatter", "collective-permute",
                      "all-to-all")}}))
torch.distributed.destroy_process_group()
"""


def _run(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, *args], capture_output=True, text=True,
                         timeout=timeout, cwd=ROOT, env=env)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    return res.stdout


def test_tiny_dtensor_program_captures_its_collective_payloads():
    out = json.loads(_run(["-c", TINY]).strip().splitlines()[-1])
    f32 = 4
    want = {"all-gather": 8 * 16 * f32,          # the gathered (8, 16) output
            "all-reduce": 8 * 16 * f32,          # the reduced (8, 16)
            "reduce-scatter": 4 * 16 * f32,      # rank 0's (4, 16) shard
            "collective-permute": 8 * 16 * f32,  # one hop of the (8, 16)
            "all-to-all": 8 * 8 * f32}           # rank 0's (8, 8) shard of dim 1
    by_kind = out["summary"]["by_kind"]
    assert {k: v["bytes"] for k, v in by_kind.items()} == want
    assert out["summary"]["total_bytes"] == sum(want.values())
    assert all(v["count"] == 1 and v["max_group"] == 2 for v in by_kind.values())
    # rank 0's groups on the (2, 2) mesh: data is {0, 2}, model is {0, 1}
    for kind in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all"):
        assert "replica_groups={{0,2}}" in out["raw"][kind], out["raw"][kind]
    assert "source_target_pairs={{0,1},{1,0}}" in out["raw"]["collective-permute"]
    assert out["arg_bytes"] == (4 * 16 + 8 * 16) * f32


def _analytic_param_bytes(arch):
    """Each parameter's bytes divided by the sizes of the mesh axes its spec
    names, under the reference's rules on the single-pod mesh."""
    model = ref_build_model(RC.get(arch).full)
    rules = logical_rules(RC.SINGLE_POD_MESH, RC.ShardingConfig())
    rules.update(model.logical_overrides(RC.SINGLE_POD_MESH))
    total = 0

    def walk(specs):
        nonlocal total
        if isinstance(specs, dict):
            for v in specs.values():
                walk(v)
            return
        div = 1
        for entry in axes_to_pspec(specs.axes, rules):
            for ax in ((entry,) if isinstance(entry, str) else (entry or ())):
                div *= RC.SINGLE_POD_MESH.axis_size(ax)
        total += int(np.prod(specs.shape)) * 2 // div       # bf16
    walk(model.param_specs())
    return total


WHOLE = r"""
import json, sys
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh
D.start_fake_group(256)
rec = D.measure(D.cell_config(sys.argv[1], sys.argv[2], False), make_production_mesh(device="cpu"))
print(json.dumps(rec))
"""

MICRO = r"""
import dataclasses, json
from repro_torch import config as C
from repro_torch.distributed.mesh import build_mesh
from repro_torch.launch import dryrun as D
D.start_fake_group(4)
mesh_cfg = C.MeshConfig((2, 2), ("data", "model"))
mesh = build_mesh(mesh_cfg, device="cpu")
rc = C.RunConfig(model=dataclasses.replace(C.get("llama3-8b").smoke, num_layers=4),
                 shape=C.ShapeConfig("t", 32, 8, "train"), mesh=mesh_cfg,
                 train=C.TrainConfig(accum_steps=4))
print(json.dumps({"whole": D.measure(rc, mesh), "fit": D.record(rc, mesh)}))
"""


def _same_sums(fit, whole):
    for key in ("mxu_flops", "hbm_bytes", "collective_bytes", "ops"):
        assert np.isclose(fit["ir_totals"][key], whole["ir_totals"][key], rtol=1e-9), key
    for key in ("argument_bytes", "output_bytes", "alias_bytes", "param_bytes"):
        assert fit["memory"][key] == whole["memory"][key], key
    assert fit["collectives"]["count"] == whole["collectives"]["count"]
    for kind, v in whole["collectives"]["by_kind"].items():
        assert np.isclose(fit["collectives"]["by_kind"][kind]["bytes"], v["bytes"],
                          rtol=1e-9), kind
    assert np.isclose(fit["engine"]["total_seconds"], whole["engine"]["total_seconds"],
                      rtol=0.05)


def test_dryrun_llama3_8b_decode_32k_on_256_ranks():
    out = _run(["-m", "repro_torch.launch.dryrun", "--arch", "llama3-8b", "--shape",
                "decode_32k"])
    assert "dry-run OK" in out
    d = json.loads((ART / "llama3-8b.decode_32k.16x16.json").read_text())
    assert d["num_devices"] == 256 and d["mesh"] == "16x16" and d["kind"] == "decode"
    assert d["memory"]["param_bytes"] == _analytic_param_bytes("llama3-8b")
    assert d["ir_totals"]["mxu_flops"] > 0
    assert d["collectives"]["total_bytes"] > 0
    assert d["engine"]["total_seconds"] > 0
    m = d["memory"]
    assert m["per_device_bytes"] == (m["argument_bytes"] + m["temp_bytes"]
                                     + m["output_bytes"] - m["alias_bytes"])
    # the cache is updated in place: the outputs alias it
    assert m["alias_bytes"] > 0 and m["argument_bytes"] > m["param_bytes"]

    # 32 layers: the record is extended from traces of 1 and 2, and equals
    # the whole trace's
    assert d["extrapolated_from"] == [[1, 1], [2, 1]]
    whole = json.loads(_run(["-c", WHOLE, "llama3-8b", "decode_32k"]).strip().splitlines()[-1])
    _same_sums(d, whole)
    assert d["memory"]["temp_bytes"] == whole["memory"]["temp_bytes"]


def test_dryrun_extends_a_train_step_over_layers_and_microbatches():
    got = json.loads(_run(["-c", MICRO]).strip().splitlines()[-1])
    fit, whole = got["fit"], got["whole"]
    assert fit["extrapolated_from"] == [[1, 2], [1, 3], [2, 2], [2, 3]]
    assert "extrapolated_from" not in whole
    assert whole["collectives"]["by_kind"]["all-to-all"]["bytes"] > 0
    _same_sums(fit, whole)
    # a peak, not a sum: each microbatch keeps a few scalars to the end, and
    # the small tensors' order differs a little between depths
    assert abs(fit["memory"]["temp_bytes"] / whole["memory"]["temp_bytes"] - 1) <= 1e-3


def test_cli_takes_the_references_skip_lenet_flag(capsys):
    """``--skip-lenet`` (a no-op ``store_true`` in the reference's CLI) is
    taken: the reference's command lines run unchanged.  Without a cell the
    parser stops at its own complaint, before any process group starts."""
    import pytest

    from repro_torch.launch import dryrun
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--skip-lenet"])
    err = capsys.readouterr().err
    assert exc.value.code == 2
    assert "give --arch" in err and "unrecognized" not in err
    with pytest.raises(SystemExit):
        dryrun.main(["--skip-lenet", "--no-such-flag"])
    assert "unrecognized arguments: --no-such-flag" in capsys.readouterr().err
