"""The port's fault layer (``repro_torch.faults``) against the reference's.

* ``tests/golden/cluster_faults.json`` (read only) reproduced by the port
  through the scenario of ``tests/test_golden.py::_cluster_faults_summary``,
  at the reference test's rel 1e-6, and the port's summary equal (``==``)
  to the reference's live one;
* ``tree_nbytes`` of a llama3-8b smoke state carried across
  (``state_from_jax``) equal to the reference's on the same state; a
  sharded state's whole-leaf bytes are held in ``tests/test_torch_distributed.py``;
* ``gang_dilation`` equal on the same broken ring;
* the reference's hand-computed scenarios (failure processes, spec
  grammars, hardware-priced checkpoints, Young-Daly, single and repeated
  failures, the goodput ladder), run over both packages as cases of one
  test each.
"""
import importlib
import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
PKGS = ["repro", "repro_torch"]
GB = 1e9


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _golden_scenario(pkg):
    """The scenario of ``tests/test_golden.py::_cluster_faults_summary``."""
    cl, fa = _m(pkg, "cluster"), _m(pkg, "faults")
    trace = _m(pkg, "cluster.workload").synthetic_trace("synthetic:multislice", n_jobs=40,
                                                        seed=7)
    table = {c.name: (0.05 * c.cost_scale, 2e9) for c in trace.classes}
    sim = cl.ClusterSim(
        cl.Fleet.from_spec("4", topology="torus:2x2"),
        cl.TableCostModel(table), cl.make_policy("locality"),
        faults=fa.StochasticFailures(mtbf_s=300.0, mttr_s=20.0, dist="weibull",
                                     weibull_k=0.7, link_mtbf_s=600.0,
                                     link_mttr_s=15.0, seed=3),
        checkpoint=fa.CheckpointModel(interval_s=10.0, base_s=0.1))
    return sim.run(trace).summary()


def test_port_reproduces_the_cluster_faults_golden():
    got = _golden_scenario("repro_torch")
    want = json.loads((ROOT / "tests" / "golden" / "cluster_faults.json").read_text())
    assert set(got) == set(want)
    drift = {k: (want[k], got[k]) for k in want
             if got[k] != pytest.approx(want[k], rel=1e-6, abs=1e-18)}
    assert not drift
    assert got["device_failures"] > 0 and got["link_failures"] > 0 and got["gang_reshapes"] > 0


def test_golden_scenario_summary_equals_the_reference():
    assert _golden_scenario("repro_torch") == _golden_scenario("repro")


@pytest.mark.parametrize("policy", ["fifo", "sjf", "best-fit-hbm", "locality"])
def test_faulted_runs_equal_the_reference(policy):
    """Device and link outages, hardware-priced checkpoints, elastic gangs,
    under every policy: the port's summary and time accounting equal the
    reference's."""
    out = []
    for pkg in PKGS:
        cl, fa = _m(pkg, "cluster"), _m(pkg, "faults")
        trace = cl.synthetic_trace("synthetic:multislice", n_jobs=30, seed=2)
        table = {c.name: (0.2 * c.cost_scale, 1 * GB) for c in trace.classes}
        rep = cl.ClusterSim(cl.Fleet.from_spec("4", topology="ring"), cl.TableCostModel(table),
                            cl.make_policy(policy),
                            faults=fa.parse_failure_spec("mtbf:200,mttr:20,links:400,seed:5"),
                            checkpoint=fa.parse_checkpoint_spec("every:15")).run(trace)
        out.append((rep.summary(), rep.time_accounting()))
    assert out[0] == out[1]


def test_tree_nbytes_equals_the_reference_on_a_carried_state():
    from repro import config as RC
    from repro.faults.pricing import tree_nbytes as ref_tree_nbytes
    from repro.runtime.steps import init_train_state as ref_init
    from repro_torch import config as C
    from repro_torch.faults.pricing import tree_nbytes
    from repro_torch.models.transformer import state_from_jax
    shape = dict(seq_len=32, global_batch=2, kind="train")
    ref_rc = RC.RunConfig(model=RC.get("llama3-8b").smoke, shape=RC.ShapeConfig("t", **shape),
                          mesh=RC.SMOKE_MESH)
    ref_state = ref_init(ref_rc, jax.random.key(0))
    state = state_from_jax(jax.tree.map(np.asarray, tuple(ref_state)),
                           C.get("llama3-8b").smoke)
    want = ref_tree_nbytes(ref_state)
    assert want > 0 and tree_nbytes(state) == want
    # and the abstract (meta) state: no storage, the same bytes
    from repro_torch.models import build_model
    from repro_torch.optim import abstract_state
    assert tree_nbytes(abstract_state(build_model(C.get("llama3-8b").smoke).abstract())) \
        == want - np.asarray(ref_state.step).nbytes + 4


def test_gang_dilation_equals_the_reference():
    got = []
    for pkg in PKGS:
        fa, topo = _m(pkg, "faults"), _m(pkg, "topology.graph")
        ring = topo.Topology.from_spec("ring:4")
        dead = {topo.undirected_pair(0, 1)}
        hw = _m(pkg, "core.hw").V5E
        got.append([fa.gang_dilation(ring, nodes, dead, hw) for nodes in
                    ((0, 1), (1, 2), (0, 1, 2, 3))])
    assert got[0] == got[1]
    assert got[1][0] > 1.0 and got[1][1] == 1.0


# -- the reference's hand scenarios, over both packages ----------------------

def _conserved(rep, tol=1e-9):
    for dev, a in rep.time_accounting().items():
        total = sum(a[k] for k in ("busy", "setup", "checkpoint", "restore", "lost", "down",
                                   "idle"))
        assert total == pytest.approx(a["horizon"], abs=tol), (dev, a)
        assert a["idle"] >= -tol
    assert rep.reconcile_busy() < 1e-9


@pytest.mark.parametrize("pkg", PKGS)
def test_planned_failures_and_stochastic_streams(pkg):
    fa = _m(pkg, "faults")
    pf = fa.PlannedFailures([fa.Outage(fa.DEVICE, "d0", 5.0, 1.0),
                             fa.Outage(fa.DEVICE, "d0", 1.0, 1.0)])
    assert list(pf.device_schedule("d0")) == [(1.0, 2.0), (5.0, 6.0)]
    with pytest.raises(ValueError):
        fa.Outage("gpu", "d0", 1.0, 1.0)
    a = fa.StochasticFailures(mtbf_s=100.0, mttr_s=10.0, seed=1)
    b = fa.StochasticFailures(mtbf_s=100.0, mttr_s=10.0, seed=1, link_mtbf_s=500.0)
    take = lambda it, n: [next(it) for _ in range(n)]
    assert take(a.device_schedule("d0"), 5) == take(b.device_schedule("d0"), 5)
    prev = 0.0
    for fail, repair in take(a.device_schedule("d0"), 50):
        assert fail > prev and repair >= fail
        prev = repair


def test_stochastic_streams_equal_the_reference():
    streams = []
    for pkg in PKGS:
        fa = _m(pkg, "faults")
        sf = fa.StochasticFailures(mtbf_s=200.0, mttr_s=5.0, dist="weibull", weibull_k=0.7,
                                   link_mtbf_s=300.0, seed=4)
        dev, link = sf.device_schedule("dev0"), sf.link_schedule(fa.link_key(1, 0))
        streams.append(([next(dev) for _ in range(50)], [next(link) for _ in range(50)]))
    assert streams[0] == streams[1]


@pytest.mark.parametrize("pkg", PKGS)
def test_spec_grammars(pkg):
    fa = _m(pkg, "faults")
    sf = fa.parse_failure_spec("mtbf:1h,mttr:2m,links:30m,link-mttr:30,dist:weibull:0.5,seed:9")
    assert (sf.mtbf_s, sf.mttr_s, sf.link_mtbf_s, sf.link_mttr_s) == (3600.0, 120.0, 1800.0,
                                                                        30.0)
    assert sf.dist == "weibull" and sf.weibull_k == 0.5 and sf.seed == 9
    assert fa.parse_seconds("1.5h") == 5400.0
    for bad in ("mtbf:600,bogus:1", "mttr:60", "mtbf:xyz", "mtbf:600,dist:gamma"):
        with pytest.raises(KeyError):
            fa.parse_failure_spec(bad)
    assert fa.parse_checkpoint_spec("every:10m,write:2,restore:5,base:0.5") == \
        fa.CheckpointModel(interval_s=600.0, write_s=2.0, restore_s=5.0, base_s=0.5)
    with pytest.raises(KeyError):
        fa.parse_checkpoint_spec("cadence:600")


@pytest.mark.parametrize("pkg", PKGS)
def test_checkpoint_pricing_from_hardware_and_young_daly(pkg):
    fa, hw = _m(pkg, "faults"), _m(pkg, "core.hw")
    cm = fa.CheckpointModel(interval_s=100.0, base_s=0.5)
    S, V5E = 8 * GB, hw.V5E
    assert cm.save_seconds(S, V5E) == pytest.approx(0.5 + S / V5E.hbm_bw + S / V5E.dcn_bw)
    g = 4
    ici_bw = V5E.ici_links_per_axis * V5E.ici_link_bw
    assert cm.restore_seconds(S, V5E, gang=g) == pytest.approx(
        0.5 + S / g / V5E.dcn_bw + S / V5E.hbm_bw + (g - 1) / g * S / ici_bw
        + (g - 1) * V5E.ici_latency_s)
    assert cm.restore_seconds(S, hw.V5P) < cm.restore_seconds(S, V5E)
    assert cm.steps_per_checkpoint(3.0) == 33 and cm.steps_per_checkpoint(1000.0) == 1
    assert fa.daly_interval(2.0, 250.0) == pytest.approx(math.sqrt(1000.0))
    assert fa.daly_interval(0.0, 250.0) == math.inf


def _single(pkg, outages, checkpoint=True):
    cl, fa = _m(pkg, "cluster"), _m(pkg, "faults")
    trace = cl.Trace("hand", [cl.Job("j0", "train", 0.0, 4)], (cl.JobClass("train", "lenet"),))
    fleet = cl.Fleet.from_spec("1")
    dev = fleet.slots[0].device_id
    ckpt = fa.CheckpointModel(interval_s=2.0, write_s=0.5, restore_s=1.0) if checkpoint else None
    sim = cl.ClusterSim(fleet, cl.TableCostModel({"train": (1.0, 1 * GB)}),
                        cl.make_policy("fifo"),
                        faults=fa.PlannedFailures([fa.Outage(fa.DEVICE, dev, t, d)
                                                   for t, d in outages]),
                        checkpoint=ckpt)
    return sim.run(trace)


@pytest.mark.parametrize("pkg", PKGS)
def test_single_failure_mid_run(pkg):
    """4 steps at 1 s, a checkpoint every 2 (write 0.5, restore 1.0), the
    device down at 3.2 for 1 s: one cycle committed, 0.7 s lost, down,
    restore, 2 steps: makespan 7.2, goodput 4 / 6.2."""
    rep = _single(pkg, [(3.2, 1.0)])
    assert rep.makespan_s == pytest.approx(7.2)
    assert rep.lost_work_seconds == pytest.approx(0.7)
    assert rep.goodput_fraction == pytest.approx(4.0 / 6.2)
    assert rep.device_failures == 1 and rep.recoveries == 1
    _conserved(rep)


@pytest.mark.parametrize("pkg", PKGS)
def test_failure_during_restore_pays_again_and_no_checkpoint_loses_the_slice(pkg):
    rep = _single(pkg, [(3.2, 1.0), (4.7, 0.5)])
    assert rep.makespan_s == pytest.approx(8.2)
    assert rep.restore_seconds == pytest.approx(1.5)
    assert rep.goodput_fraction == pytest.approx(4.0 / 6.7)
    _conserved(rep)
    rep = _single(pkg, [(3.2, 1.0)], checkpoint=False)
    assert rep.makespan_s == pytest.approx(8.2) and rep.lost_work_seconds == pytest.approx(3.2)
    _conserved(rep)


@pytest.mark.parametrize("pkg", PKGS)
def test_goodput_non_increasing_in_failure_rate(pkg):
    cl, fa = _m(pkg, "cluster"), _m(pkg, "faults")
    trace = cl.synthetic_trace("synthetic:poisson", n_jobs=30, seed=5)
    table = {c.name: (0.2 * c.cost_scale, 1 * GB) for c in trace.classes}
    goodputs = []
    for mtbf in (math.inf, 400.0, 200.0, 100.0, 50.0):
        faults = None if math.isinf(mtbf) else fa.StochasticFailures(mtbf_s=mtbf, mttr_s=20.0,
                                                                     seed=11)
        rep = cl.ClusterSim(cl.Fleet.from_spec("4"), cl.TableCostModel(table),
                            cl.make_policy("fifo"), faults=faults,
                            checkpoint=fa.CheckpointModel(interval_s=30.0, write_s=0.5,
                                                          restore_s=1.0)).run(trace)
        _conserved(rep, tol=1e-6)
        goodputs.append(rep.goodput_fraction)
    for hi, lo in zip(goodputs, goodputs[1:]):
        assert lo <= hi + 1e-9, goodputs
