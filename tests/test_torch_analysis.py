"""The port's analysis path against the reference package's: phase analysis,
channel and link reports, exporters, the legacy vision view, the power
model and the roofline correlation, bit for bit on the same HLO text; the
reference's analysis tests, ported; and ``python -m repro_torch.analysis``.

Both engines simulate the same text (the hand-built scheduler modules, the
doctor's demo pathologies and a live capture of the reference LeNet smoke
training step, as ``test_torch_engine.py`` does), on the ``tpu-v5e`` spec
both packages carry verbatim.  The code under test is framework-free, so
the comparison is exact: the strings must be equal.
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from repro.analysis import analyze as ref_analyze
from repro.core.correlate import correlate as ref_correlate
from repro.core.engine import Engine as RefEngine
from repro.core.hlo_ir import parse_hlo_module as ref_parse
from repro.core.hw import V5E as REF_V5E
from repro.core.power import analyze_power as ref_analyze_power
from repro.core.trace import to_chrome_trace as ref_to_chrome_trace
from repro.core.trace import to_csv as ref_to_csv
from repro.core.vision import analyze as ref_vision
from repro_torch import config as C
from repro_torch.analysis import (AnalysisReport, analyze, channel_traffic,
                                  label_interval, phase_table, profile_intervals)
from repro_torch.analysis.__main__ import build_parser, main
from repro_torch.core import H100, V5E, Simulator, correlate
from repro_torch.core.engine import Engine, SimReport, TimelineEntry
from repro_torch.core.hlo_ir import parse_hlo_module
from repro_torch.core.power import analyze_power
from repro_torch.core.trace import to_chrome_trace, to_csv
from repro_torch.core.vision import analyze as vision_analyze
from repro_torch.models.lenet import LeNet, sgd_step
from test_torch_engine import SOURCES, _text, lenet_hlo  # noqa: F401  (a fixture)

ROOT = Path(__file__).resolve().parents[1]
BUCKETS = 48

# ---------------------------------------------------------------------------
# bit-exact parity with the reference on shared HLO text
# ---------------------------------------------------------------------------


def _views(ar, rep, captured, hw, *, power, vision, correlate_fn, chrome, csv):
    return {
        "analysis_json": ar.to_json(indent=1),
        "phase_table": ar.phase_table(),
        "ascii_timeline": ar.ascii_timeline(width=60),
        "channels_table": ar.channels.table(),
        "links_table": ar.links.table() if ar.links is not None else None,
        "analysis_chrome_trace": ar.to_chrome_trace(),
        "op_chrome_trace": chrome(rep) + csv(rep),
        "vision_csv": vision(rep, hw, 64).to_csv(),
        "power_table": power(rep, hw).table(),
        "correlate_table": correlate_fn(captured, hw).table(),
    }


VIEWS = ("analysis_json", "phase_table", "ascii_timeline", "channels_table",
         "links_table", "analysis_chrome_trace", "op_chrome_trace", "vision_csv",
         "power_table", "correlate_table")


@pytest.fixture(scope="module")
def both_views(lenet_hlo):
    """Every view of every source, from each package."""
    out = {}
    for source in SOURCES:
        text = _text(source, lenet_hlo)
        ref_mod, mod = ref_parse(text), parse_hlo_module(text)
        ref_rep = RefEngine(REF_V5E).simulate(ref_mod)
        rep = Engine(V5E).simulate(mod)
        ref = _views(ref_analyze(ref_rep, num_buckets=BUCKETS, hw=REF_V5E), ref_rep,
                     types.SimpleNamespace(module=ref_mod), REF_V5E,
                     power=ref_analyze_power, vision=ref_vision,
                     correlate_fn=ref_correlate, chrome=ref_to_chrome_trace,
                     csv=ref_to_csv)
        port = _views(analyze(rep, num_buckets=BUCKETS, hw=V5E), rep,
                      types.SimpleNamespace(module=mod), V5E,
                      power=analyze_power, vision=vision_analyze,
                      correlate_fn=correlate, chrome=to_chrome_trace, csv=to_csv)
        out[source] = (ref, port)
    return out


@pytest.mark.parametrize("view", VIEWS)
@pytest.mark.parametrize("source", SOURCES)
def test_view_matches_reference_bit_for_bit(both_views, source, view):
    ref, port = both_views[source]
    assert port[view] == ref[view]


# ---------------------------------------------------------------------------
# the reference's analysis tests, ported
# ---------------------------------------------------------------------------

def _entry(name, opcode, unit, start, dur, *, scale=1.0, flops=0.0,
           hbm=0.0, ici=0.0, overhead=0.0):
    return TimelineEntry(name, opcode, unit, start, dur, scale, flops, hbm,
                         ici, "entry", overhead_s=overhead)


def _synth_report(entries, hw=V5E):
    """A SimReport whose totals are consistent with its timeline."""
    unit_seconds = {}
    for e in entries:
        unit_seconds[e.unit] = unit_seconds.get(e.unit, 0.0) \
            + e.duration * e.scale
    compute = sum(v for u, v in unit_seconds.items() if u != "ici")
    ici = unit_seconds.get("ici", 0.0)
    end = max(e.start + e.duration * e.scale for e in entries)
    return SimReport(
        total_seconds=end, compute_seconds=compute, ici_seconds=ici,
        exposed_ici_seconds=max(0.0, ici - compute),
        unit_seconds=unit_seconds,
        total_flops=sum(e.flops * e.scale for e in entries),
        total_hbm_bytes=sum(e.hbm_bytes * e.scale for e in entries),
        total_ici_bytes=sum(e.ici_bytes * e.scale for e in entries),
        timeline=entries, hw=hw)


#: compute -> collective -> bandwidth, 100us each — the canonical 3-phase run
_THREE_PHASE = [
    _entry("dot.1", "dot", "mxu", 0e-6, 25e-6, flops=1e9, hbm=1e6, overhead=0.5e-6),
    _entry("dot.2", "dot", "mxu", 25e-6, 25e-6, flops=1e9, hbm=1e6, overhead=0.5e-6),
    _entry("dot.3", "dot", "mxu", 50e-6, 50e-6, flops=2e9, hbm=2e6, overhead=0.5e-6),
    _entry("all-reduce.1", "all-reduce", "ici", 100e-6, 100e-6, ici=8e6, overhead=0.5e-6),
    _entry("copy.1", "copy", "hbm", 200e-6, 60e-6, hbm=50e6, overhead=0.5e-6),
    _entry("fusion.1", "fusion", "hbm", 260e-6, 40e-6, flops=1e7, hbm=30e6, overhead=0.5e-6),
]


@pytest.fixture(scope="module")
def lenet_capture():
    """The port's capture of the LeNet smoke training step (gemm convs)."""
    cfg = C.get("lenet").smoke
    model = LeNet(cfg, conv_algo="gemm", device="cpu")
    x = torch.zeros(8, cfg.image_hw, cfg.image_hw, cfg.image_c)
    y = torch.zeros(8, dtype=torch.long)
    return Simulator(hw=H100).capture(
        lambda p, a, b: sgd_step(model, p, a, b, 0.05), model.param_dict(), x, y)


@pytest.mark.parametrize("buckets", [1, 7, 50, 200])
def test_bucket_sums_match_synthetic_totals(buckets):
    rep = _synth_report(list(_THREE_PHASE))
    prof = profile_intervals(rep, buckets)
    assert len(prof.intervals) == buckets
    assert prof.reconcile() < 1e-9
    got = prof.totals()
    assert got["total_flops"] == pytest.approx(rep.total_flops)
    assert got["total_hbm_bytes"] == pytest.approx(rep.total_hbm_bytes)
    assert got["unit_mxu_seconds"] == pytest.approx(100e-6)
    assert got["unit_ici_seconds"] == pytest.approx(100e-6)


@pytest.mark.parametrize("buckets", [10, 120])
def test_bucket_sums_match_real_capture(lenet_capture, buckets):
    """The acceptance bar: bucketed totals reconcile with summary() < 1%."""
    rep = Simulator(hw=H100).performance(lenet_capture)
    assert profile_intervals(rep, buckets).reconcile() < 0.01


def test_trip_count_scaled_entries_conserved():
    """A while-body entry with scale=k must contribute k iterations' worth."""
    rep = _synth_report([
        _entry("body_dot", "dot", "mxu", 0.0, 10e-6, scale=5.0, flops=1e9,
               hbm=1e6, overhead=0.5e-6)])
    got = profile_intervals(rep, 25).totals()
    assert got["total_flops"] == pytest.approx(5e9)
    assert got["unit_mxu_seconds"] == pytest.approx(50e-6)
    assert got["launch_overhead_seconds"] == pytest.approx(2.5e-6)


def test_interval_occupancy_bounded():
    rep = _synth_report(list(_THREE_PHASE))
    for iv in profile_intervals(rep, 30).intervals:
        for u in ("mxu", "vpu", "hbm", "ici"):
            assert 0.0 <= iv.occupancy(u) <= 1.0
        assert iv.ops_per_s >= 0.0


def test_phase_segmentation_compute_collective_bandwidth():
    rep = _synth_report(list(_THREE_PHASE))
    ar = analyze(rep, num_buckets=60)
    labels = [p.label for p in ar.phases]
    assert labels == ["compute-bound", "ici-exposed", "bandwidth-bound"]
    width = rep.total_seconds / 60
    assert abs(ar.phases[0].t1 - 100e-6) <= width
    assert abs(ar.phases[1].t1 - 200e-6) <= width
    assert ar.phases[0].occupancy["mxu"] > 0.9
    assert ar.phases[2].occupancy["hbm"] > 0.9
    table = phase_table(ar.phases)
    for lab in labels:
        assert lab in table
    assert label_interval(ar.profile.intervals[0]) == "compute-bound"


def test_launch_overhead_phase_detection():
    tiny = [_entry(f"small.{i}", "fusion", "vpu", i * 0.6e-6, 0.6e-6,
                   flops=1e3, overhead=0.5e-6) for i in range(50)]
    ar = analyze(_synth_report(tiny), num_buckets=25)
    assert {p.label for p in ar.phases} == {"launch-overhead-bound"}


def test_short_phase_debounce():
    """A one-bucket blip between long phases is absorbed, not a phase."""
    entries = [
        _entry("dot.1", "dot", "mxu", 0.0, 100e-6, flops=1e9),
        _entry("copy.blip", "copy", "hbm", 100e-6, 2e-6, hbm=1e6),
        _entry("dot.2", "dot", "mxu", 102e-6, 100e-6, flops=1e9),
    ]
    ar = analyze(_synth_report(entries), num_buckets=50)
    assert [p.label for p in ar.phases] == ["compute-bound"]


def test_channels_balanced_for_contiguous_traffic():
    rep = _synth_report([
        _entry("fusion.1", "fusion", "hbm", 0.0, 10e-6, hbm=64e6),
        _entry("copy.1", "copy", "hbm", 10e-6, 10e-6, hbm=32e6)])
    ch = channel_traffic(rep)
    assert ch.imbalance == pytest.approx(1.0)
    assert ch.camping_bytes == 0.0
    assert sum(ch.channel_bytes) == pytest.approx(96e6)


@pytest.mark.parametrize("hw", [V5E, H100], ids=["tpu-v5e", "h100"])
def test_channels_detect_camping_on_skewed_traffic(hw):
    """Gather-dominated traffic concentrates on a channel subset: the
    imbalance index flags it, on the TPU spec and on the H100's 10 channels."""
    rep = _synth_report([
        _entry("gather.1", "gather", "hbm", 0.0, 10e-6, hbm=64e6),
        _entry("fusion.1", "fusion", "hbm", 10e-6, 10e-6, hbm=8e6)], hw=hw)
    ch = channel_traffic(rep, hw)
    assert len(ch.channel_bytes) == hw.hbm_channels
    assert ch.imbalance > 1.5
    assert ch.camping_fraction_of_traffic > 0.5
    assert sum(ch.channel_bytes) == pytest.approx(72e6)
    assert ch.hot_contributors[0][0] == "gather.1"
    assert "hot" in ch.table()


def test_channel_hash_deterministic():
    rep = _synth_report([_entry("gather.7", "gather", "hbm", 0.0, 1e-6, hbm=1e6)])
    assert channel_traffic(rep).channel_bytes == channel_traffic(rep).channel_bytes


def test_chrome_trace_schema():
    ar = analyze(_synth_report(list(_THREE_PHASE)), num_buckets=40)
    doc = json.loads(ar.to_chrome_trace())
    assert isinstance(doc["traceEvents"], list) and doc["traceEvents"]
    phases_seen = 0
    for ev in doc["traceEvents"]:
        assert {"name", "ph", "pid"} <= set(ev)
        if ev["ph"] == "X":
            assert {"ts", "dur", "tid"} <= set(ev)
            assert ev["dur"] > 0
        elif ev["ph"] == "C":
            assert "ts" in ev and "args" in ev
        if ev.get("cat") == "phase":
            phases_seen += 1
    assert phases_seen == len(ar.phases) >= 3


def test_json_export_roundtrip():
    ar = analyze(_synth_report(list(_THREE_PHASE)), num_buckets=20)
    doc = json.loads(ar.to_json())
    assert doc["num_buckets"] == 20
    assert doc["reconcile_max_rel_error"] < 1e-9
    assert len(doc["intervals"]) == 20
    assert [p["label"] for p in doc["phases"]] == [p.label for p in ar.phases]
    assert len(doc["channels"]["channel_bytes"]) == V5E.hbm_channels


def test_ascii_timeline_renders():
    ar = analyze(_synth_report(list(_THREE_PHASE)), num_buckets=60)
    art = ar.ascii_timeline(width=60)
    assert "phase |" in art and "mxu |" in art and "ici |" in art
    for glyph in ("C", "I", "B"):
        assert glyph in art.split("\n")[0]


def test_simulator_facade_and_report_shortcut(lenet_capture):
    sim = Simulator(hw=H100)
    rep = sim.performance(lenet_capture)
    ar = sim.analysis(rep, num_buckets=30)
    assert isinstance(ar, AnalysisReport)
    assert len(ar.profile.intervals) == 30
    assert len(ar.channels.channel_bytes) == H100.hbm_channels
    ar2 = rep.analysis(num_buckets=30)
    assert len(ar2.profile.intervals) == 30
    assert ar2.reconcile() < 0.01
    vr = sim.vision(rep)
    assert vr.camping_index >= 1.0 - 1e-9 and vr.to_csv()


def test_cli_parser():
    args = build_parser().parse_args(
        ["lenet", "--buckets", "64", "--hw", "tpu-v5p", "--device", "cpu",
         "--chrome-trace", "/tmp/x.json"])
    assert args.arch == "lenet" and args.buckets == 64
    assert args.hw == "tpu-v5p" and args.chrome_trace == "/tmp/x.json"
    assert args.device == "cpu"
    assert build_parser().parse_args(["lenet"]).hw == "h100"


# ---------------------------------------------------------------------------
# python -m repro_torch.analysis
# ---------------------------------------------------------------------------

_BLOCKED_CLI = (
    "import runpy, sys\n"
    "sys.modules['jax'] = None\n"
    "sys.modules['repro'] = None\n"
    "sys.argv = ['python -m repro_torch.analysis'] + sys.argv[1:]\n"
    "runpy.run_module('repro_torch.analysis', run_name='__main__')\n")


def test_cli_runs_on_the_cpu_with_jax_blocked(lenet_hlo):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_CLI, "lenet", "--device", "cpu",
                          "--json", "-"], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout[out.stdout.rindex("\n{\n") + 1:])
    assert doc["reconcile_max_rel_error"] < 0.01 and doc["hw"] == "h100"
    # the reference CLI's top-level keys: its JSON is its analysis'
    # to_json with the stage timings, over its LeNet smoke capture
    ref = RefEngine(REF_V5E).simulate(ref_parse(lenet_hlo))
    ref_doc = json.loads(ref_analyze(ref, hw=REF_V5E).to_json(
        indent=2, stage_seconds={"capture": 0.0}))
    assert set(doc) == set(ref_doc)
    assert "== lenet: modeled step" in out.stdout


@pytest.mark.parametrize("argv", [
    ["nope", "--device", "cpu"],                    # unknown arch
    ["lenet", "--hw", "tpu-v9", "--device", "cpu"],  # unknown hw
    ["lenet", "--buckets", "0", "--device", "cpu"],  # bad bucket count
    ["llama3-8b", "--seq-len", "0", "--device", "cpu"],  # bad sequence length
], ids=["arch", "hw", "buckets", "seq-len"])
def test_cli_exits_2_on_bad_arguments(argv, capsys):
    assert main(argv) == 2
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0]


def test_cli_without_device_needs_a_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["lenet"]) != 0
    assert "no CUDA device" in capsys.readouterr().err
