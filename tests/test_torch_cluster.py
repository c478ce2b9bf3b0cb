"""The port's cluster layer (``repro_torch.cluster``) against the reference's.

* the ``summary()`` of a 40-job run, for every policy of ``POLICIES``, on
  the ``synthetic`` and ``TableCostModel`` backends, with and without a
  topology: equal (``==``) to the reference's on the same seeded trace;
* the cluster CLI's ``--json`` report equal to the reference's (synthetic
  costs; all but its wall-clock stage seconds), and ``--cost capture`` without a GPU or ``--device cpu`` exiting
  1 with one line;
* ``captured_modules`` on the CPU: each default class's smoke train step
  captured on fake tensors, its product FLOPs equal to the live reference
  capture's, plus, for the attention classes, the attention products of
  the recomputes the reference's XLA program folds away (as
  ``tests/test_torch_train.py`` holds them);
* the reference's hand-computed scheduling properties, run over both
  packages as cases of one test each;
* ``repro_torch.cluster_quickstart`` printing what ``examples/cluster_quickstart.py``
  prints on the synthetic costs.
"""
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKGS = ["repro", "repro_torch"]
GB = 1e9


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _table(trace):
    return {c.name: (0.05 * c.cost_scale, 2 * GB * c.cost_scale) for c in trace.classes}


def _summary(pkg, backend, policy, topology, trace_spec="synthetic:bursty"):
    cl = _m(pkg, "cluster")
    trace = cl.synthetic_trace(trace_spec, n_jobs=40, rate_jobs_per_s=4.0, seed=3)
    cost = (cl.TableCostModel(_table(trace)) if backend == "table"
            else cl.cost_model_for(trace, "synthetic"))
    sim = cl.ClusterSim(cl.Fleet.from_spec("4", topology=topology), cost,
                        cl.make_policy(policy), cold_start_s=0.01)
    rep = sim.run(trace)
    return rep.summary(), rep.reconcile_busy()


def test_the_policies_are_the_reference_policies():
    from repro.cluster import POLICIES as REF
    from repro_torch.cluster import POLICIES
    assert sorted(POLICIES) == sorted(REF)


@pytest.mark.parametrize("topology", [None, "torus:2x2"])
@pytest.mark.parametrize("policy", sorted(_m("repro", "cluster").POLICIES))
@pytest.mark.parametrize("backend", ["synthetic", "table"])
def test_summary_equals_the_reference(backend, policy, topology):
    trace_spec = "synthetic:multislice" if topology else "synthetic:bursty"
    ref, ref_err = _summary("repro", backend, policy, topology, trace_spec)
    got, err = _summary("repro_torch", backend, policy, topology, trace_spec)
    assert got == ref
    assert err == ref_err and err <= 1e-9


def test_generated_traces_are_the_reference_traces(tmp_path):
    for name in ("synthetic:poisson", "synthetic:bursty", "synthetic:multislice"):
        paths = []
        for pkg in PKGS:
            trace = _m(pkg, "cluster").synthetic_trace(name, n_jobs=30, seed=11)
            paths.append(tmp_path / f"{pkg}.json")
            trace.save(str(paths[-1]))
        assert paths[0].read_text() == paths[1].read_text(), name


def test_cluster_cli_json_equals_the_reference(tmp_path):
    from repro.cluster.__main__ import main as ref_main
    from repro_torch.cluster.__main__ import main
    args = ["--cost", "synthetic", "--trace", "synthetic:bursty", "--policy", "sjf",
            "--failures", "mtbf:60,mttr:5", "--checkpoint", "every:10"]
    assert ref_main(args + ["--json", str(tmp_path / "ref.json")]) == 0
    assert main(args + ["--json", str(tmp_path / "port.json")]) == 0
    got, want = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("port", "ref"))
    # all but the wall-clock seconds of each stage
    assert set(got.pop("stage_seconds")) == set(want.pop("stage_seconds"))
    assert got == want


def test_capture_needs_a_gpu_or_the_cpu_asked_for(monkeypatch, capsys):
    from repro_torch.cluster.__main__ import main
    from repro_torch.cluster.devices import captured_modules
    from repro_torch.cluster_quickstart import main as quickstart
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--cost", "capture"]) == 1
    assert quickstart(["--capture"]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert err == [err[0]] * 2 and "no CUDA device" in err[0]
    trace = _m("repro_torch", "cluster").synthetic_trace("synthetic:poisson", n_jobs=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        captured_modules(trace)
    # the capture-free paths need no device
    assert main(["--cost", "synthetic", "--jobs", "6"]) == 0


def _mxu_flops(module):
    return sum(scale * module.op_flops(comp, op)["mxu"]
               for op, comp, scale in module.walk_entry())


@pytest.fixture(scope="module")
def captures():
    from repro.cluster.devices import captured_modules as ref_captured
    from repro_torch.cluster.devices import captured_modules
    out = {}
    for pkg, fn, kw in (("repro", ref_captured, {}), ("repro_torch", captured_modules,
                                                     {"device": "cpu"})):
        trace = _m(pkg, "cluster").synthetic_trace("synthetic:poisson", n_jobs=40, seed=0)
        build = fn(trace, **kw)
        out[pkg] = {c: build(c) for c in sorted({j.job_class for j in trace.jobs})}
    return out


@pytest.mark.parametrize("job_class", ["lenet", "llama3-8b", "qwen3-moe-30b"])
def test_captured_modules_dot_flops_match_the_reference(captures, job_class):
    """LeNet's AdamW step equal; an attention class's step 4 attention
    products a layer over the reference's, whose XLA program at this shape
    (one loss chunk) keeps neither the flash op's backward recompute nor
    the layer recompute's attention; llama3-8b's also equal to the analytic
    count of ``tests/test_torch_train.py``."""
    from repro_torch import config as C
    from repro_torch.cluster.workload import DEFAULT_CLASSES
    from repro_torch.models.layers import pad_vocab
    jc = {c.name: c for c in DEFAULT_CLASSES}[job_class]
    cfg = C.get(jc.arch).smoke
    got, ref = (_mxu_flops(captures[pkg][job_class]) for pkg in PKGS[::-1])
    assert got > 0
    if cfg.family == "conv":
        assert got == ref
        return
    b, s = jc.global_batch, jc.seq_len
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    n = b * s
    att = 2 * b * h * s * s * hd
    assert got == ref + cfg.num_layers * 4 * att
    if cfg.family == "dense":
        proj = 2 * n * d * (h + 2 * kv) * hd + 2 * n * h * hd * d + 3 * 2 * n * d * cfg.d_ff
        down = 2 * n * cfg.d_ff * d
        head = 2 * n * d * pad_vocab(cfg.vocab_size)
        assert got == cfg.num_layers * (4 * proj - down + 10 * att) + 4 * head


def test_captured_classes_price_and_run_on_the_cpu(captures):
    from repro_torch.cluster import ClusterSim, Fleet, make_policy, synthetic_trace
    from repro_torch.cluster.devices import CostModel
    trace = synthetic_trace("synthetic:poisson", n_jobs=40, seed=0)
    cost = CostModel(captures["repro_torch"].__getitem__)
    rep = ClusterSim(Fleet.from_spec("4xh100"), cost, make_policy("fifo")).run(trace)
    s = rep.summary()
    assert len(rep.jobs) == 40 and s["makespan_s"] > 0
    assert rep.reconcile_busy() <= 0.01
    hw = Fleet.from_spec("4xh100").slots[0].hw
    assert hw.name == "h100" and Fleet.from_spec("4").slots[0].hw.name == "tpu-v5e"


def test_quickstart_prints_what_the_reference_example_prints():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.run([sys.executable, str(ROOT / "examples" / "cluster_quickstart.py")],
                         capture_output=True, text=True, env=env, timeout=300)
    port = subprocess.run([sys.executable, "-m", "repro_torch.cluster_quickstart"],
                          capture_output=True, text=True, env=env, timeout=300)
    assert ref.returncode == 0 and port.returncode == 0, port.stderr
    assert port.stdout == ref.stdout


# -- the reference's hand scenarios, over both packages ----------------------

def _hand(pkg, policy, devices="2", **kw):
    cl = _m(pkg, "cluster")
    classes = (cl.JobClass("short", "lenet"), cl.JobClass("long", "lenet"))
    jobs = [cl.Job("j0-long", "long", 0.0, 1), cl.Job("j1-short", "short", 0.0, 1),
            cl.Job("j2-short", "short", 0.0, 1), cl.Job("j3-short", "short", 0.0, 1)]
    table = {"short": (1.0, 1 * GB), "long": (4.0, 1 * GB)}
    sim = cl.ClusterSim(cl.Fleet.from_spec(devices), cl.TableCostModel(table),
                        cl.make_policy(policy), **kw)
    return sim.run(cl.Trace("hand", jobs, classes))


@pytest.mark.parametrize("pkg", PKGS)
def test_hand_scenario_queueing_delays(pkg):
    fifo, sjf = _hand(pkg, "fifo"), _hand(pkg, "sjf")
    assert {j.job_id: j.queue_delay_s for j in fifo.jobs} == {
        "j0-long": 0.0, "j1-short": 0.0, "j2-short": 1.0, "j3-short": 2.0}
    assert fifo.makespan_s == 4.0
    assert {j.job_id: j.queue_delay_s for j in sjf.jobs} == {
        "j0-long": 1.0, "j1-short": 0.0, "j2-short": 0.0, "j3-short": 1.0}
    assert sjf.makespan_s == 5.0 and sjf.hol_bypasses >= 1


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("policy", ["fifo", "sjf", "best-fit-hbm", "locality"])
def test_hand_scenario_conserves_service(pkg, policy):
    rep = _hand(pkg, policy)
    total = sum(j.service_s for j in rep.jobs)
    assert rep.fleet_busy_seconds == pytest.approx(total, rel=1e-12)
    assert total == pytest.approx(7.0) and rep.reconcile_busy() <= 1e-9
    assert sum(rep.per_device_busy.values()) == pytest.approx(rep.fleet_busy_seconds)


@pytest.mark.parametrize("pkg", PKGS)
def test_quantum_round_robin(pkg):
    cl = _m(pkg, "cluster")
    jobs = [cl.Job("j0", "c", 0.0, 2), cl.Job("j1", "c", 0.0, 2)]
    sim = cl.ClusterSim(cl.Fleet.from_spec("1"), cl.TableCostModel({"c": (1.0, GB)}),
                        cl.make_policy("fifo"), quantum_s=1.0)
    rep = sim.run(cl.Trace("rr", jobs, (cl.JobClass("c", "lenet"),)))
    by_id = {j.job_id: j for j in rep.jobs}
    # slices interleave: j0(0-1) j1(1-2) j0(2-3) j1(3-4)
    assert by_id["j0"].finish_s == pytest.approx(3.0)
    assert by_id["j1"].finish_s == pytest.approx(4.0)
    assert by_id["j0"].preemptions == 1 and by_id["j1"].preemptions == 1
    assert rep.fleet_busy_seconds == pytest.approx(4.0) and rep.reconcile_busy() <= 1e-9


@pytest.mark.parametrize("pkg", PKGS)
def test_fleet_from_spec_and_percentile(pkg):
    cl = _m(pkg, "cluster")
    assert [d.hw.name for d in cl.Fleet.from_spec("2xtpu-v5e+1xtpu-v5p").slots] == \
        ["tpu-v5e", "tpu-v5e", "tpu-v5p"]
    assert len(cl.Fleet.from_spec("4")) == 4
    with pytest.raises((KeyError, ValueError)):
        cl.Fleet.from_spec("2xnot-a-chip")
    assert cl.percentile([1.0, 2.0, 3.0, 4.0], 0.5) == pytest.approx(2.5)


@pytest.mark.parametrize("pkg", PKGS)
def test_trace_round_trip_runs_identically(pkg, tmp_path):
    cl = _m(pkg, "cluster")
    trace = cl.bursty_trace(n_jobs=12, rate_jobs_per_s=4.0, seed=2)
    trace.save(str(tmp_path / "t.json"))
    loaded = cl.Trace.load(str(tmp_path / "t.json"))
    assert loaded.jobs == trace.jobs and loaded.classes == trace.classes
    runs = [cl.ClusterSim(cl.Fleet.from_spec("2"), cl.TableCostModel(_table(t)),
                          cl.make_policy("sjf")).run(t).summary() for t in (trace, loaded)]
    assert runs[0] == runs[1]


@pytest.mark.parametrize("pkg", PKGS)
def test_fleet_exporters(pkg):
    cl = _m(pkg, "cluster")
    trace = cl.bursty_trace(n_jobs=10, seed=1)
    rep = cl.ClusterSim(cl.Fleet.from_spec("2"), cl.TableCostModel(_table(trace)),
                        cl.make_policy("fifo")).run(trace)
    doc = json.loads(cl.fleet_chrome_trace(rep))
    assert doc["traceEvents"]
    assert "queue" in cl.fleet_ascii(rep, width=40)
    assert json.loads(cl.to_json(rep))["summary"] == json.loads(json.dumps(rep.summary()))
