"""The port's tracing on the CPU: spans and regions as profiler ranges, a
capture's region table, a replay's device events put down to its regions,
the MoE routing counts, and the benchmark's readers of all of these."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.obs import regions, routing
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.regions import RegionTable
from repro_torch.obs.trace import _NULL_SPAN, TRACER, SpanTracer

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "port_bench" / "tests"), str(ROOT / "port_bench")):
    if p not in sys.path:
        sys.path.insert(0, p)

import replays as RP  # noqa: E402  (the benchmark's, on the path just set)

M, OUTSIDE = RP.MARKER, RP.OUTSIDE


@pytest.fixture
def registry():
    """The process registry, emptied for the test and restored after."""
    saved = dict(REGISTRY._families)
    REGISTRY.clear()
    yield REGISTRY
    REGISTRY.clear()
    REGISTRY._families.update(saved)


@pytest.fixture
def tables(monkeypatch):
    """An empty table registry for the test."""
    monkeypatch.setattr(regions, "TABLES", [])
    return regions.TABLES


def _ranges(prof):
    """The ``repro.*`` host events of a profile: (name, start, end, kwargs)."""
    return [(e.name, e.time_range.start, e.time_range.end, dict(e.kwinputs or {}))
            for e in prof.events() if e.name.startswith("repro.")]


# ---------------------------------------------------------------------------
# spans and regions
# ---------------------------------------------------------------------------

def test_spans_and_regions_are_profiler_ranges_with_names_nesting_and_call():
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        for _ in range(2):
            with TRACER.request():
                with TRACER.span("test.outer", kind="a"):
                    with regions.region("test.inner"):
                        torch.ones(4).add_(1)
                with TRACER.span("test.after"):
                    pass
    got = _ranges(prof)
    outer = [r for r in got if r[0] == "repro.test.outer"]
    inner = [r for r in got if r[0] == "repro.test.inner"]
    after = [r for r in got if r[0] == "repro.test.after"]
    assert len(outer) == len(inner) == len(after) == 2
    for o, i in zip(outer, inner):
        assert o[1] <= i[1] and i[2] <= o[2]
        assert o[3]["kind"] == "a"
    calls = [o[3]["call"] for o in outer]
    assert calls[0] != calls[1]
    assert [a[3]["call"] for a in after] == calls


def test_with_nothing_recording_a_span_is_the_shared_no_op(monkeypatch):
    monkeypatch.setattr(TRACER, "enabled", False)
    assert TRACER.span("x", a=1) is _NULL_SPAN
    assert TRACER.request() is _NULL_SPAN
    assert regions.region("x") is _NULL_SPAN
    assert regions.step("prefill") is _NULL_SPAN


def test_an_enabled_tracer_records_into_its_ring_and_the_profiler():
    tr = SpanTracer().enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.request():
            with tr.span("test.ring", n=3):
                pass
    assert [r.name for r in tr.records] == ["test.ring"]
    assert tr.records[0].attrs["n"] == 3 and "call" in tr.records[0].attrs
    assert [r[0] for r in _ranges(prof)] == ["repro.test.ring"]
    with tr.span("test.quiet"):
        pass
    assert [r.name for r in tr.records] == ["test.ring", "test.quiet"]


def _moe_server():
    from repro_torch import config as C
    from repro_torch.models import build_model
    from repro_torch.runtime.server import Server
    cfg = C.get("qwen3-moe-30b-a3b").smoke
    rc = C.RunConfig(model=cfg, shape=C.ShapeConfig("p", 16, 2, "prefill"))
    params = build_model(cfg).init(seed=0, device="cpu")
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (2, 16))).long()}
    return cfg, Server(rc, params), batch


def test_a_generate_calls_spans_share_its_call_number(registry):
    """Each phase of ``Server.generate`` is a span carrying the call's
    number; the compiled step's dispatch lies inside its decode step, and
    the model's regions inside the prefill."""
    _, server, batch = _moe_server()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        for _ in range(2):
            server.generate(batch, max_new_tokens=3)
    got = _ranges(prof)
    names = {r[0][len("repro."):] for r in got}
    assert {"server.prefill", "server.cache_copy", "server.decode_step", "server.sample",
            "server.token_read", "jit.dispatch", "attn.flash_fwd", "attn.core", "moe.route",
            "moe.dispatch", "moe.experts", "moe.combine", "lm_head"} <= names
    server_spans = [r for r in got if r[0].startswith("repro.server.")]
    calls = sorted({r[3]["call"] for r in server_spans})
    assert len(calls) == 2
    for c in calls:
        mine = [r for r in server_spans if r[3]["call"] == c]
        assert [r[0] for r in mine].count("repro.server.decode_step") == 2
    steps = [r for r in got if r[0] == "repro.server.decode_step"]
    dispatches = [r for r in got if r[0] == "repro.jit.dispatch"]
    assert all(any(s[1] <= d[1] and d[2] <= s[2] for d in dispatches) for s in steps)
    prefills = [r for r in got if r[0] == "repro.server.prefill"]
    routes = [r for r in got if r[0] == "repro.moe.route"]
    assert all(any(p[1] <= r[1] and r[2] <= p[2] for p in prefills) for r in routes[:2])


def test_the_data_pipelines_wait_is_a_span():
    from repro_torch.data.pipeline import DataPipeline
    data = DataPipeline(({"x": np.full((2, 2), i, np.float32)} for i in range(4)), "cpu")
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                next(data)
    finally:
        data.close()
    assert [r[0] for r in _ranges(prof)] == ["repro.data.wait"] * 3


# ---------------------------------------------------------------------------
# region tables
# ---------------------------------------------------------------------------

class _FakeDriver:
    """A capture's graph as a growing list of node types (0 a kernel, 1 a
    memcpy, 2 a memset, 5 an empty node)."""

    def __init__(self):
        self.kinds = []

    def graph(self, stream):
        return 1

    def count(self, graph):
        return len(self.kinds)

    def nodes(self, graph, n):
        return list(range(n))

    def is_work(self, node):
        return self.kinds[node] in (0, 1, 2)


def test_a_capture_writes_each_regions_node_boundaries(monkeypatch, tables):
    drv = _FakeDriver()
    monkeypatch.setattr(regions, "_DRIVER", drv)
    cap = regions.Capture("prefill", 7)
    monkeypatch.setattr(regions, "_CAPTURES", {7: cap})
    monkeypatch.setattr(regions, "capturing", lambda: cap)
    drv.kinds += [0, 5]
    with regions.region("outer"):
        drv.kinds += [0, 1]
        with regions.region("inner"):
            drv.kinds += [2, 5, 0]
        drv.kinds += [0]
    drv.kinds += [0]
    assert cap.finish() == 0
    table = tables[0]
    assert table.step == "prefill" and table.nodes == 7
    assert set(table.regions) == {("inner", 3, 5, 1), ("outer", 1, 6, 0)}
    assert RP.owners(table) == [OUTSIDE, "outer", "outer", "inner", "inner", "outer", OUTSIDE]
    assert regions.table("prefill") is table and regions.table("decode") is None


class _Reordering(_FakeDriver):
    """A driver that hands the nodes back in another order."""

    def nodes(self, graph, n):
        return list(range(n))[::-1]


class _NoCapture(_FakeDriver):
    def graph(self, stream):
        raise RuntimeError("no capture")


@pytest.mark.parametrize("driver", [_NoCapture, _Reordering])
def test_a_capture_whose_driver_cannot_be_read_writes_no_table(monkeypatch, tables, driver):
    drv = driver()
    monkeypatch.setattr(regions, "_DRIVER", drv)
    cap = regions.Capture("decode", 7)
    monkeypatch.setattr(regions, "_CAPTURES", {7: cap})
    monkeypatch.setattr(regions, "capturing", lambda: cap)
    drv.kinds += [0, 0]
    with regions.region("x"):
        drv.kinds += [0]
    assert cap.finish() is None and not tables and cap.failed


# ---------------------------------------------------------------------------
# a replay's device events put down to its regions
# ---------------------------------------------------------------------------

TABLE = RegionTable("s", 5, (("b", 1, 2, 1), ("a", 0, 4, 0)))


def _replay(t, durations, copy_at=None, names=None):
    """A marker, the replay's events (1 us apart), two markers; a
    host-to-device copy after the ``copy_at``-th event.  The events are
    named ``names`` (default k0, k1, ...)."""
    evs = [(M, t, t + 1)]
    t += 10
    for i, d in enumerate(durations):
        evs.append((names[i] if names else f"k{i}", t, t + d))
        t += d + 1
        if copy_at == i:
            evs.append(("Memcpy HtoD (Pinned -> Device)", t, t + 50))
            t += 51
    return evs + [(M, t + 5, t + 6), (M, t + 7, t + 8)], t + 20


def _put_down(events, table=TABLE):
    return RP.put_down(RP.replays(events), table)


def test_put_down_puts_each_node_down_to_its_innermost_region():
    first, t = _replay(0, [10, 20, 30, 40, 50], copy_at=2)
    second, _ = _replay(t + 100, [1, 2, 3, 4, 5])
    between = [("sample", t + 30, t + 40)]
    secs = _put_down(first + between + second)
    assert secs == pytest.approx({"b": 22e-9, "a": 88e-9, OUTSIDE: 55e-9})
    found = RP.replays(first + between + second)
    assert [len(r.events) for r in found] == [5, 5]
    assert sum(secs.values()) == pytest.approx(sum(r.busy_s for r in found))
    assert found[0].elapsed_s > found[0].busy_s


def test_put_down_gives_nothing_on_a_count_mismatch_or_a_missing_marker():
    evs, _ = _replay(0, [10, 20, 30, 40, 50])
    assert _put_down(evs) is not None
    assert _put_down(evs[:3] + evs[4:]) is None                          # a node short
    assert RP.replays(evs[1:]) == [] and _put_down(evs[1:]) is None      # no begin
    assert RP.replays(evs[:-2]) == [] and _put_down(evs[:-2]) is None    # no end
    assert _put_down([e for e in evs if e[0] != M]) is None              # no markers
    assert RP.replays(evs[:-1]) == []                                    # half an end


MS = 1_000_000


def test_launched_pairs_each_whole_replay_with_the_host_range_that_launched_it():
    """In order, whatever the device's stamps' offset from the host's, so
    long as it drifts slowly: a long prefill-like replay, then two short."""
    first, t = _replay(0, [1, 2, 3, 4, 5])
    second, u = _replay(150 * MS, [1, 2, 3])
    third, _ = _replay(190 * MS, [1, 2, 3])
    # between replays the device runs other work: a sample, a copy
    first += [("argmax", t, t + 5)]
    second += [("argmax", u, u + 5)]
    # the device's stamps run 20 ms late, and 1% slow
    launches = [-20 * MS, 130 * MS, int(169.6 * MS)]
    host = [("repro.jit.replay", h, h + 1) for h in launches[::-1]] + [("aten::mm", 0, 1)]
    got = RP.launched(first + second + third, host)
    assert [(t, len(r.events)) for t, r in got] == list(zip(launches, [5, 3, 3]))
    assert RP.put_down([r for _, r in got], TABLE) is None               # 3 nodes, not 5
    assert RP.put_down([got[0][1]], TABLE) == _put_down(first)
    # the first replay cut at the trace's start: the others keep their launches
    cut = [e for e in first + second + third if e != first[0]]
    assert [t for t, _ in RP.launched(cut, host)] == launches[1:]
    assert [len(r.events) for r in RP.replays(cut)] == [3, 3]
    # the last replay's end markers stamped past the trace's end
    tail = (first + second + third)[:-2]
    assert [t for t, _ in RP.launched(tail, host)] == launches[:2]
    # a replay lost within the trace: the launches after it would pair with
    # the wrong replays, and the offset jumps by a whole gap
    lost = [e for e in first + second + third if e not in [e for e in second if e[0] == M][-1:]]
    assert [len(r.events) for r in RP.replays(lost)] == [5, 3]
    assert RP.launched(lost, host) is None
    assert RP.launched(first + second, host[2:3]) is None                 # one launch, two


def test_launched_gives_nothing_where_two_alignments_fit():
    """Four launches 40 ms apart and the replays of the middle two: paired
    with the first two launches they would run 40 ms behind them, as a busy
    device might, so the pairing is not told by the trace alone."""
    evs, launches = [], []
    for i in range(4):
        rp, _ = _replay(i * 40 * MS + 100, [1, 2, 3])
        launches.append(("repro.jit.replay", i * 40 * MS, i * 40 * MS + 50))
        evs += rp if i in (1, 2) else []
    assert RP.launched(evs, launches) is None
    assert [t for t, _ in RP.launched(evs, launches[1:3])] == [40 * MS, 80 * MS]


def test_a_single_launch_pairs_with_its_replay_stamped_before_it():
    """The profiler's conversion of the device's clock can stamp a replay
    some hundred microseconds before the host range that launched it (a
    traced training step on the H100); one launch has no other replay to
    pair with, so the skew does not refuse it."""
    evs, _ = _replay(10 * MS, [1, 2, 3])
    launch = 10 * MS + 150_000
    host = [("repro.jit.replay", launch, launch + 50)]
    assert [(t, len(r.events)) for t, r in RP.launched(evs, host)] == [(launch, 3)]
    more, _ = _replay(20 * MS, [1, 2, 3])
    assert RP.launched(evs + more, host) is None                         # one launch, two


def test_a_phases_seconds_pass_over_a_replay_the_profiler_cut(tables):
    """A phase's replays that hold their table's node count are put down;
    one whose begin marker the profiler dropped at the session's start is
    passed over, not guessed at; a step with no table gives nothing."""
    import devtrace as TR
    tables.append(RegionTable("prefill", TABLE.nodes, TABLE.regions))
    cut, _ = _replay(10 * MS, [7, 7, 7, 7, 7])
    whole, _ = _replay(100 * MS, [10, 20, 30, 40, 50])
    again, u = _replay(120 * MS, [1, 2, 3, 4, 5])
    host = [("repro.jit.replay", evs[0][1] - 2, evs[0][1] - 1) for evs in (cut, whole, again)]
    trace = TR.Trace((0, u), cut[1:] + whole + again, {"bench.prefill": [(0, u)]}, host)
    assert RP.phase_seconds(trace, "prefill", "prefill") == pytest.approx(
        _put_down(whole + again))
    assert RP.phase_seconds(trace, "decode", "decode") is None


def test_back_to_back_replays_are_told_apart():
    first, t = _replay(0, [1, 2, 3, 4, 5])
    second, _ = _replay(first[-1][2] + 1, [1, 2, 3, 4, 5])
    found = RP.replays(first + second)
    assert [len(r.events) for r in found] == [5, 5]


# ---------------------------------------------------------------------------
# the MoE routing counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factor", [1.25, 0.3, 0.0])
def test_the_routing_counts_match_a_direct_count(registry, factor):
    """At the smoke size, eagerly under the profiler: the counts of one
    moe_ffn call equal a count from ``route``'s own outputs (a forced
    small capacity drops choices; 0 drops none)."""
    from repro_torch import config as C
    from repro_torch.models import build_model
    from repro_torch.models import moe
    cfg = C.get("qwen3-moe-30b-a3b").smoke
    p = build_model(cfg).init(seed=0, device="cpu")
    layer = {k: v[0] for k, v in p["layers"]["moe"].items()}
    x = torch.randn(3, 24, cfg.d_model, generator=torch.Generator().manual_seed(1)).to(
        layer["w_gate"].dtype)
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = moe._capacity(24, cfg, factor)
    _, _, _, slot, _, filled = moe.route(layer, cfg, x, cap)
    with profile(activities=[ProfilerActivity.CPU]), regions.step("prefill"):
        moe.moe_ffn(layer, cfg, x, capacity_factor=factor)
    routing.flush()
    dropped = int((slot == e * cap).sum())
    assert dropped > 0 if factor == 0.3 else (factor != 0.0 or dropped == 0)
    assert REGISTRY.value("moe_choices_routed_total", step="prefill") == 3 * 24 * k
    assert REGISTRY.value("moe_choices_dropped_total", step="prefill") == dropped
    assert REGISTRY.value("moe_experts_filled_total", step="prefill") == int(
        filled.reshape(3, e, cap).any(2).any(0).sum())
    assert REGISTRY.value("moe_experts_read_total", step="prefill") == e
    assert not routing._PENDING


def test_nothing_is_counted_with_no_profiler(registry):
    from repro_torch import config as C
    from repro_torch.models import build_model
    from repro_torch.models import moe
    cfg = C.get("qwen3-moe-30b-a3b").smoke
    p = build_model(cfg).init(seed=0, device="cpu")
    layer = {k: v[0] for k, v in p["layers"]["moe"].items()}
    moe.moe_ffn(layer, cfg, torch.randn(2, 8, cfg.d_model).to(layer["w_gate"].dtype))
    routing.flush()
    assert REGISTRY.get("moe_choices_routed_total", step="eager") is None


def test_a_generates_counts_are_labelled_by_step(registry):
    cfg, server, batch = _moe_server()
    with profile(activities=[ProfilerActivity.CPU]):
        server.generate(batch, max_new_tokens=3)
    n, k, e = cfg.num_layers, cfg.experts_per_token, cfg.num_experts
    assert REGISTRY.value("moe_choices_routed_total", step="prefill") == n * 2 * 16 * k
    assert REGISTRY.value("moe_choices_routed_total", step="decode") == n * 2 * k * 2
    assert REGISTRY.value("moe_choices_dropped_total", step="decode") == 0
    assert REGISTRY.value("moe_experts_read_total", step="decode") == n * e * 2


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------

D, G, T = ("qwen3-moe-30b-a3b.serve.doc4k", "qwen3-moe-30b-a3b.serve.gen128",
           "qwen1.5-4b.train.seq4k")


class _Tracer:
    def __init__(self, trace):
        self.trace = trace


def _run(cell, trace=None):
    import harness
    run = harness.prepare(ROOT, ROOT / "port_bench", cell, 1, 1.0, True, "cpu", 0.0)
    run.tracer = None if trace is None else _Tracer(trace)
    return run


def _trace(skew=0):
    """A fabricated trace of one prefill replay, two decode replays and a
    training step replay, each phase in its ``bench.`` range, with the
    program's host spans; the device's stamps ``skew`` ns late against the
    host's."""
    import devtrace as TR
    pre, _ = _replay(10 * MS, [10, 20, 30, 40, 50])
    dec1, _ = _replay(20 * MS, [5, 5, 5])
    dec2, _ = _replay(30 * MS, [5, 5, 5])
    step, t = _replay(40 * MS, [100, 200, 300, 400, 500], copy_at=1, names=STEP_KERNELS)
    ranges = {"bench.prefill": [(10 * MS - 10, pre[-1][2] + 10)],
              "bench.decode": [(20 * MS - 10, dec2[-1][2] + 5)],
              "bench.step": [(40 * MS - 10, t)]}
    host = [("repro.jit.replay", evs[0][1] - 2, evs[0][1] - 1)
            for evs in (pre, dec1, dec2, step)]
    for evs in (dec1, dec2):
        s = evs[0][1] - 8
        host += [("repro.server.decode_step", s, s + 7), ("repro.jit.dispatch", s + 1, s + 3)]
    host += [("repro.jit.dispatch", 0, 500),                 # outside every decode step
             ("repro.data.wait", step[0][1] - 8, step[0][1] - 4)]
    device = [(n, s + skew, e + skew) for n, s, e in pre + dec1 + dec2 + step]
    return TR.Trace((0, t), sorted(device, key=lambda e: e[1]), ranges, host)


def _tables():
    regions.TABLES.extend([
        RegionTable("prefill", 5, (("moe.route", 0, 1, 0), ("moe.dispatch", 1, 2, 0),
                                   ("moe.experts", 2, 3, 0), ("moe.combine", 3, 4, 0))),
        RegionTable("decode", 3, (("attn.core", 0, 1, 0),)),
        RegionTable("train", 5, (("attn.bwd", 2, 4, 0),))])


def _counters():
    REGISTRY.counter("jit_captures_total").inc(2)
    for step, (routed, dropped, filled, read) in {"prefill": (1000, 4, 500, 600),
                                                  "decode": (64, 0, 96, 384)}.items():
        REGISTRY.counter("moe_choices_routed_total", step=step).inc(routed)
        REGISTRY.counter("moe_choices_dropped_total", step=step).inc(dropped)
        REGISTRY.counter("moe_experts_filled_total", step=step).inc(filled)
        REGISTRY.counter("moe_experts_read_total", step=step).inc(read)
    REGISTRY.counter("ssm_scan_chunks_total", step="prefill").inc(16)
    REGISTRY.counter("ssm_scan_kernel_chunks_total", step="prefill").inc(12)
    REGISTRY.counter("ssm_mixer_layers_total", step="prefill").inc(81)
    REGISTRY.counter("ssm_mixer_kernel_layers_total", step="prefill").inc(81)


#: the fabricated step replay's kernels: one flash backward call (its three
#: kernels, 300 + 400 + 500 ns) after two others
STEP_KERNELS = ("k0", "k1", "void flash_bwd_dot_kernel<__nv_bfloat16>",
                "void flash_bwd_dkdv_kernel<__nv_bfloat16, 128>",
                "void flash_bwd_dq_kernel<__nv_bfloat16, 128>")


def _flash_bwd_roofline():
    import yardstick as Y
    bound = Y.bound_s(2 * Y.attn_flops(6, 20, 4096, 4096, 128, True),
                      2 * Y.flash_fwd_bytes(6, 20, 20, 4096, 4096, 128))
    return 100.0 * bound / ((300 + 400 + 500) * 1e-9)


READERS = {
    # name: (cell, the number the fabricated run gives)
    "moe_overhead_share.prefill": (D, 100.0 * (10 + 20 + 40) / 150),
    "attn_bwd_share.train": (T, 100.0 * (300 + 400) / 1500),
    "decode_device_ms": (D, 1e-6 * 32),
    "decode_expert_use_pct": (G, 25.0),
    "moe_dropped_pct.prefill": (D, 0.4),
    "jit_dispatch_ms.decode": (D, 2e-6),
    "jit_captures": (T, 2.0),
    "data_wait_ms.span": (T, 4e-6),
    "flash_bwd_roofline.train": (T, _flash_bwd_roofline()),
    # reads the counters alone, whatever the cell
    "ssm_scan_kernel_pct.prefill": (D, 75.0),
    "ssm_mixer_kernel_pct.prefill": (D, 100.0),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_reads_what_the_program_recorded(name, registry, tables):
    """Also with the device's stamps late against the host's, past the
    ends of the phases (a replay belongs to the phase it was launched in)."""
    import harness
    cell, want = READERS[name]
    reader = harness.load_module(ROOT / "port_bench" / "metrics" / f"{name}.py",
                                 "reader_" + name.replace(".", "_"))
    _tables()
    _counters()
    assert reader.read(_run(cell, _trace())) == pytest.approx(want)
    assert reader.read(_run(cell, _trace(skew=60))) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_gives_nothing_where_the_program_recorded_nothing(name, registry, tables):
    import devtrace as TR
    import harness
    cell, _ = READERS[name]
    reader = harness.load_module(ROOT / "port_bench" / "metrics" / f"{name}.py",
                                 "reader_" + name.replace(".", "_"))
    bare = TR.Trace((0, 10), [("k", 1, 2)], {"bench.prefill": [(0, 10)],
                                             "bench.decode": [(0, 10)],
                                             "bench.step": [(0, 10)]}, [("aten::add", 1, 2)])
    assert reader.read(_run(cell, bare)) is None
    assert reader.read(_run(cell)) is None
