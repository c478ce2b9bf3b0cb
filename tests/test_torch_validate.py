"""The port's validation layer (``repro_torch.validate``) against the reference's.

* the committed Alibaba fixture (``tests/data/alibaba_fixture``, read where
  it is): the ingest statistics, the ingested trace, and the validation
  report of its replay under every policy equal to the reference's; under
  SJF it passes what the reference's ``test_fixture_passes_under_sjf``
  holds;
* ``python -m repro_torch.validate``'s JSON equal to the reference CLI's,
  and its exit codes (2 bad arguments, 1 a capture without a GPU);
* the fitted distributions, the alibaba-like generator and its refit equal
  to the reference's on the same samples;
* the reference's property tests of the fitting, the analytic queueing
  formulas and the shared quantile, run over both packages as cases of one
  test each.
"""
import importlib
import json
import math
import random
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = str(ROOT / "tests" / "data" / "alibaba_fixture")
PKGS = ["repro", "repro_torch"]


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _replay(pkg, policy):
    cl, va = _m(pkg, "cluster"), _m(pkg, "validate")
    trace, stats = va.load_alibaba(FIXTURE)
    rep = cl.ClusterSim(cl.Fleet.from_spec("4"), va.table_cost_model(trace),
                        cl.make_policy(policy)).run(trace)
    return trace, stats, rep, va.validate_cluster(rep)


def test_fixture_ingests_as_the_reference_does(tmp_path):
    (rt, rs, _, _), (pt, ps, _, _) = (_replay(pkg, "fifo") for pkg in PKGS)
    assert vars(ps) == vars(rs) and ps.render() == rs.render()
    assert ps.jobs_kept == 180
    rt.save(str(tmp_path / "ref.json"))
    pt.save(str(tmp_path / "port.json"))
    assert (tmp_path / "port.json").read_text() == (tmp_path / "ref.json").read_text()


@pytest.mark.parametrize("policy", ["fifo", "sjf", "best-fit-hbm", "locality"])
def test_fixture_validation_equals_the_reference(policy):
    _, _, rrep, rv = _replay("repro", policy)
    _, _, prep, pv = _replay("repro_torch", policy)
    assert prep.summary() == rrep.summary()
    assert pv.to_doc() == rv.to_doc() and pv.metrics() == rv.metrics()


def test_fixture_passes_under_sjf():
    _, _, rep, vrep = _replay("repro_torch", "sjf")
    assert rep.utilization <= 0.7
    by = {c.name: c for c in vrep.checks}
    assert by["littles-law-system"].residual < 0.01
    assert by["littles-law-queue"].residual < 0.01
    mgk = by["mgk-queueing-delay"]
    assert not mgk.gated and mgk.residual < 0.25
    assert vrep.passed


@pytest.mark.parametrize("extra", [[], ["--refit", "120", "--seed", "2"],
                                   ["--trace", "synthetic:alibaba-like", "--jobs", "60"]])
def test_validate_cli_json_equals_the_reference(tmp_path, extra, capsys):
    from repro.validate.__main__ import main as ref_main
    from repro_torch.validate.__main__ import main
    args = ["--trace", FIXTURE, "--policy", "sjf"] + extra
    codes, outs = [], []
    for fn, n in ((ref_main, "ref"), (main, "port")):
        codes.append(fn(args + ["--json", str(tmp_path / f"{n}.json")]))
        outs.append(capsys.readouterr().out)
    assert codes[0] == codes[1] and outs[0] == outs[1]
    got, want = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("port", "ref"))
    assert got == want


def test_validate_cli_exit_codes(monkeypatch, capsys):
    from repro_torch.validate.__main__ import main
    assert main(["--trace", "/no/such/trace.json"]) == 2
    assert main(["--policy", "no-such-policy"]) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--trace", "synthetic:poisson", "--cost", "capture"]) == 1
    assert "no CUDA device" in capsys.readouterr().err.strip().splitlines()[-1]


def test_fits_and_generator_equal_the_reference():
    rng = random.Random(3)
    xs = [rng.lognormvariate(0.0, 1.0) for _ in range(300)]
    fits = [{k: vars(f) for k, f in _m(pkg, "validate").fit_all(list(xs)).items()}
            for pkg in PKGS]
    assert fits[0] == fits[1]
    traces = []
    for pkg in PKGS:
        va = _m(pkg, "validate")
        trace, _ = va.load_alibaba(FIXTURE)
        prof = va.profile_from_trace(trace)
        gen = va.alibaba_like_trace(n_jobs=80, rate_jobs_per_s=prof.rate_jobs_per_s, seed=4,
                                    profile=prof)
        traces.append((prof.rate_jobs_per_s, gen.to_json()))
    assert traces[0] == traces[1]


# -- the reference's property tests, over both packages ----------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_fitting_recovers_the_generator(pkg):
    va = _m(pkg, "validate")
    rng = random.Random(0)
    f = va.fit([rng.expovariate(0.5) for _ in range(600)], "exponential")
    assert f.params[0] == pytest.approx(0.5, rel=0.1) and f.ks_pvalue > 0.01
    rng = random.Random(2)
    best = va.best_fit([rng.weibullvariate(2.0, 0.7) for _ in range(800)])
    assert best.dist == "weibull" and best.params[0] == pytest.approx(0.7, rel=0.15)
    with pytest.raises(ValueError):
        va.fit([1.0, 2.0], "exponential")


@pytest.mark.parametrize("pkg", PKGS)
def test_chi_square_merges_low_expected_bins(pkg):
    va = _m(pkg, "validate")
    f = va.fit(sorted([1.0] * 120 + [2.0] * 60 + [4.0] * 20), "exponential")
    assert math.isfinite(f.chi2_stat) and f.chi2_stat < 1e4 and f.chi2_pvalue >= 0.0
    assert 0 < f.chi2_dof <= 14
    for k in (0.6, 1.0, 1.7, 3.0):
        scv = (math.gamma(1 + 2 / k) / math.gamma(1 + 1 / k) ** 2) - 1
        assert va.weibull_shape_for_scv(scv) == pytest.approx(k, rel=1e-3)


@pytest.mark.parametrize("pkg", PKGS)
def test_from_fit_maps_onto_a_failure_process(pkg):
    va, fa = _m(pkg, "validate"), _m(pkg, "faults")
    rng = random.Random(4)
    p = fa.StochasticFailures.from_fit(
        va.fit([rng.expovariate(1 / 600) for _ in range(300)], "exponential"), mttr_s=30.0)
    assert p.dist == "exp" and p.mtbf_s == pytest.approx(600, rel=0.2)
    with pytest.raises(ValueError):
        fa.StochasticFailures.from_fit(
            va.fit([rng.paretovariate(0.8) for _ in range(300)], "pareto"))


@pytest.mark.parametrize("pkg", PKGS)
def test_analytic_queueing_formulas(pkg):
    va = _m(pkg, "validate")
    assert va.erlang_c(1, 0.5) == pytest.approx(0.5)
    assert va.mmk_wq(0.5, 1.0, 1) == pytest.approx(1.0)
    rho = 0.6
    assert va.erlang_c(2, 1.2) == pytest.approx(2 * rho * rho / (1 + rho))
    assert va.allen_cunneen_wq(0.8, 1.0, 1.0, 2, 1.0) == pytest.approx(va.mmk_wq(0.8, 1.0, 2))
    assert va.mmk_wq(3.0, 1.0, 2) == math.inf


@pytest.mark.parametrize("pkg", PKGS)
def test_shared_quantile(pkg):
    st = _m(pkg, "obs.stats")
    xs = [10.0, 20.0, 30.0, 40.0]
    assert st.quantile(xs, 0.5) == 25.0 and st.quantile(xs, 1.5) == 40.0
    assert st.quantile(xs, -0.2) == 10.0 and st.quantile([], 0.5) == 0.0
    assert st.quantile_sorted([1.0, 2.0, 3.0], 0.5) == 2.0
    with pytest.raises(ValueError):
        st.quantile([1.0, float("nan")], 0.5)
    assert _m(pkg, "cluster.events").percentile([5.0, 1.0, 3.0], 2.0) == 5.0


@pytest.mark.parametrize("pkg", PKGS)
def test_alibaba_like_generator_is_deterministic(pkg):
    va = _m(pkg, "validate")
    a, b, c = (va.alibaba_like_trace(n_jobs=50, seed=s) for s in (7, 7, 8))
    assert a.to_json() == b.to_json() != c.to_json()
    slow = va.alibaba_like_trace(n_jobs=30, rate_jobs_per_s=0.5, seed=3)
    fast = va.alibaba_like_trace(n_jobs=30, rate_jobs_per_s=5.0, seed=3)
    assert [(j.job_class, j.num_steps) for j in slow.jobs] == \
        [(j.job_class, j.num_steps) for j in fast.jobs]
