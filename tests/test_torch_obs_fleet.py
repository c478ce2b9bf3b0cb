"""The port's time-lapse, manifest, diff, detectors, what-if, doctor and
sentinel (``repro_torch.obs``) and its CLIs against the reference's.

* the doctor's report (verdicts, ``recoverable_seconds``, localization) on
  every ``demo_module_src`` pathology equal to the reference's, and on a
  faulted fleet run (``diagnose_cluster``);
* ``TimeLapse.from_report`` equal on one ``SimReport`` per package built
  from shared HLO text (``tests/test_scheduler.py``'s modules and the
  doctor's demos), never from the stale capture goldens;
* ``python -m repro_torch.obs diff`` and ``sentinel`` exit codes (and
  ``diff --json``) equal to the reference's on the same manifests; the
  doctor CLI's gates likewise;
* the analysis CLI's ``--timelapse``, ``--lapse-intervals``, ``--manifest``,
  ``--doctor`` and ``--spans`` on the CPU, composing into
  ``--chrome-trace``; ``obs doctor <arch> --device cpu``; without a GPU
  and without ``--device cpu`` both exit 1.
"""
import importlib
import json

import pytest
import torch

from test_scheduler import _CALL_ROOT_COLLECTIVE, _DIAMOND, _WHILE_THEN_COLLECTIVE

PKGS = ["repro", "repro_torch"]
DEMOS = ("camping", "clean", "no-overlap")


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.mark.parametrize("n_ops", [4, 8])
@pytest.mark.parametrize("hw", ["tpu-v5e", "tpu-v5p"])
@pytest.mark.parametrize("pathology", DEMOS)
def test_doctor_demo_verdicts_equal_the_reference(pathology, hw, n_ops):
    docs = []
    for pkg in PKGS:
        chip = _m(pkg, "core.hw").CHIPS[hw]
        doc, rep = _m(pkg, "obs.doctor").diagnose_demo(pathology, hw=chip, n_ops=n_ops)
        docs.append((doc.to_doc(), rep.summary()))
    assert docs[1] == docs[0]
    slugs = [f["slug"] for f in docs[1][0]["findings"]]
    want = {"camping": "hbm-channel-camping", "no-overlap": "exposed-communication"}
    if pathology in want:
        assert slugs[0] == want[pathology]


def _report(pkg, src, overlap=True):
    core = _m(pkg, "core")
    return core.Engine(hw=core.V5E, overlap_collectives=overlap).simulate(
        core.parse_hlo_module(src))


def _sources():
    from repro.obs.doctor import demo_module_src
    return {"diamond": _DIAMOND, "while_then_collective": _WHILE_THEN_COLLECTIVE,
            "call_root_collective": _CALL_ROOT_COLLECTIVE,
            **{f"demo_{p}": demo_module_src(p) for p in DEMOS}}


@pytest.mark.parametrize("n", [8, 64])
@pytest.mark.parametrize("name", sorted(_sources()))
def test_timelapse_from_report_equals_the_reference(name, n):
    src = _sources()[name]
    lapses = []
    for pkg in PKGS:
        tl = _m(pkg, "obs.timelapse").TimeLapse.from_report(_report(pkg, src),
                                                            num_intervals=n, label=name)
        lapses.append((tl.to_json(), tl.heat_strips(width=40), tl.to_chrome_events()))
    assert lapses[1] == lapses[0]
    assert json.loads(lapses[1][0])["reconcile_max_rel_error"] < 1e-9


@pytest.mark.parametrize("name", sorted(_sources()))
def test_whatif_and_detectors_equal_the_reference(name):
    src = _sources()[name]
    out = []
    for pkg in PKGS:
        core = _m(pkg, "core")
        engine = core.Engine(hw=core.V5E)
        mod = core.parse_hlo_module(src)
        rep = engine.simulate(mod)
        whatifs = _m(pkg, "obs.whatif").whatif_all(rep, engine=engine, module=mod)
        findings = _m(pkg, "obs.detectors").run_engine_detectors(rep, rep.summary())
        out.append(({k: vars(w) for k, w in whatifs.items()}, [f.to_doc() for f in findings]))
    assert out[1] == out[0]


def _faulted_cluster(pkg):
    cl, fa = _m(pkg, "cluster"), _m(pkg, "faults")
    trace = cl.synthetic_trace("synthetic:bursty", n_jobs=40, rate_jobs_per_s=4.0, seed=3)
    table = {c.name: (0.3 * c.cost_scale, 1e9) for c in trace.classes}
    ckpt = fa.CheckpointModel(interval_s=2.0, write_s=0.2, restore_s=0.5)
    rep = cl.ClusterSim(cl.Fleet.from_spec("4"), cl.TableCostModel(table), cl.make_policy("fifo"),
                        faults=fa.StochasticFailures(mtbf_s=30.0, mttr_s=3.0, seed=2),
                        checkpoint=ckpt).run(trace)
    return rep, ckpt


def test_cluster_doctor_timelapse_and_manifest_equal_the_reference():
    out = []
    for pkg in PKGS:
        rep, ckpt = _faulted_cluster(pkg)
        lapse = _m(pkg, "obs.timelapse").TimeLapse.from_cluster(rep, num_intervals=32,
                                                                label="fleet")
        doc = _m(pkg, "obs.doctor").diagnose_cluster(
            rep, lapse=lapse, context={"checkpoint": ckpt, "mtbf_s": 30.0})
        man = _m(pkg, "obs.manifest").cluster_manifest(
            rep, config={"policy": "fifo"}, seeds={"seed": 3}, timelapse=lapse)
        out.append((lapse.to_json(), doc.to_doc(), man.to_doc()))
    assert out[1] == out[0]


def _manifests(tmp_path):
    """Manifests written by the reference: two equal, one of another demo,
    a cluster one (a kind mismatch), and a missing path."""
    from repro.obs.doctor import demo_module_src
    from repro.obs.manifest import RunManifest, engine_manifest
    from repro.obs.timelapse import TimeLapse
    paths = {}
    for name, demo in (("a", "camping"), ("b", "camping"), ("c", "clean")):
        rep = _report("repro", demo_module_src(demo))
        lapse = TimeLapse.from_report(rep, num_intervals=16, label=demo)
        paths[name] = tmp_path / f"{name}.json"
        engine_manifest(rep, config={"demo": demo}, label=demo,
                        timelapse=lapse).save(str(paths[name]))
    paths["k"] = tmp_path / "k.json"
    RunManifest("cluster", "k").save(str(paths["k"]))
    paths["missing"] = tmp_path / "missing.json"
    return {k: str(v) for k, v in paths.items()}


def test_obs_diff_and_sentinel_exit_codes_equal_the_reference(tmp_path, capsys):
    from repro.obs.__main__ import main as ref_main
    from repro_torch.obs.__main__ import main
    p = _manifests(tmp_path)
    cases = [["diff", p["a"], p["b"]], ["diff", p["a"], p["c"]],
             ["diff", p["a"], p["c"], "--json"], ["diff", p["a"], p["missing"]],
             ["diff", p["a"], p["k"]], ["diff", p["a"], p["c"], "--rel-tol", "10"],
             ["sentinel", p["a"], p["b"]], ["sentinel", p["a"], p["c"]],
             ["sentinel", p["a"], p["missing"]], ["sentinel", p["a"], p["b"], "--tol", "bad"],
             ["sentinel", p["k"], p["b"]], ["sentinel", p["a"], p["c"], "--json"],
             ["sentinel", p["a"], p["c"], "--default-tol", "10"],
             ["doctor", "camping", "--expect-top", "hbm-channel-camping"],
             ["doctor", "clean", "--expect-clean"], ["doctor", "camping", "--expect-clean"],
             ["doctor", "clean", "--expect-top", "hbm-channel-camping"],
             ["doctor", "no-overlap", "--json", "-"], ["doctor", "not-a-workload"]]
    codes = []
    for args in cases:
        got = []
        for fn in (ref_main, main):
            got.append(fn(list(args)))
            got.append(capsys.readouterr().out)
        assert got[0] == got[2] and got[1] == got[3], args
        codes.append(got[0])
    assert codes == [0, 3, 3, 2, 2, 3, 0, 3, 2, 2, 2, 3, 3, 0, 0, 3, 3, 0, 2]


def test_analysis_cli_obs_flags_on_the_cpu(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    from repro_torch.obs.__main__ import main as obs_main
    a, tl, ct, sp = (str(tmp_path / n) for n in ("a.json", "tl.json", "ct.json", "sp.json"))
    assert main(["lenet", "--device", "cpu", "--timelapse", tl, "--lapse-intervals", "16",
                 "--doctor", "--manifest", a, "--spans", sp, "--chrome-trace", ct]) == 0
    out = capsys.readouterr().out
    assert "doctor: lenet" in out
    lapse = json.loads(open(tl).read())
    assert lapse["num_intervals"] == 16 and lapse["reconcile_max_rel_error"] < 1e-9
    man = json.loads(open(a).read())
    assert man["kind"] == "engine" and man["config"]["arch"] == "lenet"
    assert man["config"]["hw"] == "h100" and man["timelapse"]
    trace = json.loads(open(ct).read())["traceEvents"]
    names = {e.get("args", {}).get("name") for e in trace if e.get("ph") == "M"}
    assert "doctor" in names
    spans = json.loads(open(sp).read())["traceEvents"]
    assert spans and all(e["pid"] == spans[0]["pid"] for e in spans)
    assert obs_main(["diff", a, a]) == 0
    capsys.readouterr()


def test_obs_doctor_captures_an_arch_on_the_asked_device(monkeypatch, capsys):
    from repro_torch.analysis.__main__ import main as analysis_main
    from repro_torch.obs.__main__ import main
    assert main(["doctor", "lenet", "--device", "cpu", "--hw", "h100"]) == 0
    assert "doctor: lenet" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["doctor", "lenet"]) == 1
    assert analysis_main(["lenet", "--doctor"]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 2 and all("no CUDA device" in e for e in err)
    # the demos and the diff need no device
    assert main(["doctor", "camping", "--expect-top", "hbm-channel-camping"]) == 0
    capsys.readouterr()


@pytest.mark.parametrize("pkg", PKGS)
def test_demo_module_src_rejects_an_unknown_pathology(pkg):
    with pytest.raises(KeyError):
        _m(pkg, "obs.doctor").demo_module_src("no-such-pathology")
