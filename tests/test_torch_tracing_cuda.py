"""The port's tracing on the card: each replay of a captured step found in
a device trace between its markers and put down to the regions of its
capture (by the benchmark's ``port_bench/replays.py``), the kernels put
down so against the regions the same step's kernels are launched in when
it runs eagerly, the routing counts of a replay against the same steps run
eagerly, and regions that add nothing to a graph.

Every test needs an NVIDIA GPU, is marked ``cuda`` and skips without one.
The file imports no ``jax``:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_tracing_cuda.py
"""
import collections
import dataclasses
import re
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.obs import regions
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import TRACER

BENCH = Path(__file__).resolve().parents[1] / "port_bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import replays as RP  # noqa: E402  (the benchmark's, on the path just set)

SERVE_REGIONS = {"prefill": {"attn.flash_fwd", "moe.route", "moe.dispatch", "moe.experts",
                             "moe.combine", "lm_head"},
                 "decode": {"attn.core", "moe.route", "moe.dispatch", "moe.experts",
                            "moe.combine", "lm_head"}}
TRAIN_REGIONS = {"attn.flash_fwd", "attn.bwd", "ffn", "loss", "optimizer"}
NEW_TOKENS = 4
#: the hand flash kernel's names, and the library's matrix products'
FLASH = re.compile(r"attn_(wgmma|f32)_kernel")
GEMM = re.compile(r"gemm|gemv|nvjet|xmma|cutlass", re.IGNORECASE)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and their device trace")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _profiled(fn):
    """The profiler's events of ``fn()``, after some milliseconds of other
    device work: a profiler drops what the device runs in the first few
    hundred microseconds of its session."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1 << 22, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            x.mul_(1.0)
        torch.cuda.synchronize()
        time.sleep(0.01)
        fn()
        torch.cuda.synchronize()
    return list(prof.profiler.kineto_results.events())


def _device_events(fn):
    """The device events of ``fn()`` under the profiler, as (name, start
    ns, end ns)."""
    return [(ev.name(), ev.start_ns(), ev.end_ns()) for ev in _profiled(fn)
            if ev.device_type() != torch.autograd.DeviceType.CPU]


def _held(replay, table, names):
    assert len(replay.events) == table.nodes
    secs = RP.put_down([replay], table)
    assert secs is not None and set(secs) >= names
    assert all(secs[n] > 0 for n in names), secs
    assert sum(secs.values()) == pytest.approx(replay.busy_s, rel=1e-9)


def _moe_server(cuda):
    from repro_torch import config as C
    from repro_torch.models import build_model
    from repro_torch.runtime.server import Server
    cfg = C.get("qwen3-moe-30b-a3b").smoke
    rc = C.RunConfig(model=cfg, shape=C.ShapeConfig("p", 32, 2, "prefill"))
    params = build_model(cfg).init(seed=0, device=cuda)
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (2, 32))).long().to(cuda)}
    return cfg, Server(rc, params), params, batch


def _counts(step):
    names = ("moe_choices_routed_total", "moe_choices_dropped_total",
             "moe_experts_filled_total", "moe_experts_read_total")
    return [REGISTRY.value(n, step=step) for n in names]


@pytest.mark.cuda
def test_serving_replays_are_put_down_to_their_regions(cuda):
    """A 2-layer MoE smoke prefill and decode, captured, then served once
    under the profiler: every replay between its markers holds its table's
    node count, every region of the step has device time, and the regions'
    times sum to the replay's."""
    cfg, server, _, batch = _moe_server(cuda)
    for _ in range(2):
        server.generate(batch, max_new_tokens=NEW_TOKENS)
    prefill, decode = regions.table("prefill"), regions.table("decode")
    assert prefill is not None and decode is not None
    found = RP.replays(_device_events(
        lambda: server.generate(batch, max_new_tokens=NEW_TOKENS)))
    assert len(found) == NEW_TOKENS
    _held(found[0], prefill, SERVE_REGIONS["prefill"])
    for rp in found[1:]:
        _held(rp, decode, SERVE_REGIONS["decode"])
        assert rp.elapsed_s >= rp.busy_s * 0.999


def _launched_in(events, span, names):
    """(region, kernel name) of each kernel an eager run launched inside
    the host range ``span``: the region is the innermost ``repro.<region>``
    range among ``names`` around the kernel's launch (its runtime call, or
    the operator that made it), :data:`RP.OUTSIDE` for none."""
    cpu = [ev for ev in events if ev.device_type() == torch.autograd.DeviceType.CPU]
    ranges = [(ev.name()[len("repro."):], ev.start_ns(), ev.end_ns()) for ev in cpu
              if ev.name().startswith("repro.") and ev.name()[len("repro."):] in names]
    outer = [(ev.start_ns(), ev.end_ns()) for ev in cpu if ev.name() == "repro." + span]
    runtime = {ev.correlation_id(): ev.start_ns() for ev in cpu if ev.linked_correlation_id() > 0}
    ops = {ev.correlation_id(): ev.start_ns() for ev in cpu if ev.linked_correlation_id() == 0}
    out = []
    for ev in events:
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            continue
        t = runtime.get(ev.correlation_id(), ops.get(ev.linked_correlation_id()))
        assert t is not None, f"no launch found for {ev.name()}"
        if not any(lo <= t < hi for lo, hi in outer):
            continue
        around = [r for r in ranges if r[1] <= t < r[2]]
        out.append((min(around, key=lambda r: r[2] - r[1])[0] if around else RP.OUTSIDE,
                    ev.name()))
    return out


@pytest.mark.cuda
def test_a_prefill_replays_kernels_lie_in_the_regions_they_were_launched_in(cuda):
    """Every flash kernel of a prefill replay is put down to ``attn.flash_fwd``
    (one a layer), and every matrix product to the region that the same
    prefill, run eagerly under the profiler, launches it in: the expert
    einsums' to ``moe.experts``, the router's to ``moe.route``, the
    projections' outside every region.  The eager side finds each kernel's
    region from the profiler's own link of a kernel to its launch, not from
    the order of a graph's nodes."""
    from repro_torch.runtime.jit import disable_jit
    cfg, server, _, batch = _moe_server(cuda)
    for _ in range(2):
        server.generate(batch, max_new_tokens=NEW_TOKENS)
    table = regions.table("prefill")
    found = RP.replays(_device_events(lambda: server.generate(batch, max_new_tokens=1)))
    assert len(found) == 1 and len(found[0].events) == table.nodes
    graphed = [(owner, name) for owner, (name, _, _) in zip(RP.owners(table), found[0].events)]

    def eager():
        with disable_jit():
            server.generate(batch, max_new_tokens=1)
    names = {r[0] for r in table.regions}
    launched = _launched_in(_profiled(eager), "server.prefill", names)

    def products(pairs):
        return collections.Counter(p for p in pairs if FLASH.search(p[1]) or GEMM.search(p[1]))
    flash = [owner for owner, name in graphed if FLASH.search(name)]
    assert flash == ["attn.flash_fwd"] * cfg.num_layers
    assert products(graphed) == products(launched)
    assert sum(owner == "moe.experts" for owner, name in graphed
               if GEMM.search(name)) >= cfg.num_layers


@pytest.mark.cuda
def test_a_replays_routing_counts_match_the_eager_steps(cuda):
    """The routing counts of the profiled replays equal those the same
    steps count inline when run eagerly (the same tokens, so the same
    routes); a decode step reads every layer's experts."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.jit import disable_jit
    cfg, server, _, batch = _moe_server(cuda)
    for _ in range(2):
        server.generate(batch, max_new_tokens=NEW_TOKENS)
    got = {}
    for mode in ("graphed", "eager"):
        before = {s: _counts(s) for s in ("prefill", "decode")}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            if mode == "eager":
                with disable_jit():
                    server.generate(batch, max_new_tokens=NEW_TOKENS)
            else:
                server.generate(batch, max_new_tokens=NEW_TOKENS)
        got[mode] = {s: [a - b for a, b in zip(_counts(s), before[s])] for s in before}
    assert got["graphed"] == got["eager"]
    b, s, k, e, n = 2, 32, cfg.experts_per_token, cfg.num_experts, cfg.num_layers
    assert got["graphed"]["prefill"][0] == n * b * s * k
    assert got["graphed"]["decode"][0] == n * b * k * (NEW_TOKENS - 1)
    assert got["graphed"]["decode"][1] == 0
    assert got["graphed"]["decode"][3] == n * e * (NEW_TOKENS - 1)
    assert 0 < got["graphed"]["decode"][2] <= got["graphed"]["decode"][3]


@pytest.mark.cuda
def test_a_train_replay_is_put_down_to_its_regions(cuda):
    """One graphed qwen1.5-4b smoke train step (fp32), replayed under the
    profiler: its table's node count between the markers, and the forward,
    backward, loss and optimizer regions each with device time."""
    from repro_torch import config as C
    from repro_torch.data.synthetic import batches_for
    from repro_torch.runtime.steps import init_train_state, train_bundle
    cfg = dataclasses.replace(C.get("qwen1.5-4b").smoke, dtype="float32")
    rc = C.RunConfig(model=cfg, shape=C.ShapeConfig("t", 64, 4, "train"), mesh=C.SMOKE_MESH)
    data = batches_for(cfg, rc.shape, 0)
    step = train_bundle(rc).jit()
    state = init_train_state(rc, 0, cuda)
    for _ in range(2):
        state, _ = step(state, {k: torch.from_numpy(v).to(cuda) for k, v in next(data).items()})
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in next(data).items()}
    found = RP.replays(_device_events(lambda: step(state, batch)))
    assert len(found) == 1
    _held(found[0], regions.table("train"), TRAIN_REGIONS)


@pytest.mark.cuda
def test_regions_add_nothing_to_a_graph(cuda, monkeypatch):
    """The MoE prefill and decode and the train step captured with the
    region hooks made no-ops hold as many nodes as with them."""
    from repro_torch import config as C
    from repro_torch.data.synthetic import batches_for
    from repro_torch.runtime.steps import init_train_state, train_bundle

    def capture_all():
        _, server, _, batch = _moe_server(cuda)
        for _ in range(2):
            server.generate(batch, max_new_tokens=NEW_TOKENS)
        cfg = dataclasses.replace(C.get("qwen1.5-4b").smoke, dtype="float32")
        rc = C.RunConfig(model=cfg, shape=C.ShapeConfig("t", 64, 4, "train"),
                         mesh=C.SMOKE_MESH)
        data = batches_for(cfg, rc.shape, 0)
        step, state = train_bundle(rc).jit(), init_train_state(rc, 0, cuda)
        for _ in range(2):
            state, _ = step(state, {k: torch.from_numpy(v).to(cuda)
                                    for k, v in next(data).items()})
        return {s: regions.table(s) for s in ("prefill", "decode", "train")}

    hooked = capture_all()
    monkeypatch.setattr(regions._Region, "__enter__", lambda self: self)
    monkeypatch.setattr(regions._Region, "__exit__", lambda self, *exc: False)
    bare = capture_all()
    for s in hooked:
        assert hooked[s].regions and not bare[s].regions
        assert hooked[s].nodes == bare[s].nodes > 0, s


@pytest.mark.cuda
def test_a_replay_launches_only_its_graph_without_a_profiler(cuda, monkeypatch):
    """With no profiler recording, a replay launches no marker and no
    counting kernel."""
    from repro_torch.obs import routing
    _, server, _, batch = _moe_server(cuda)
    for _ in range(2):
        server.generate(batch, max_new_tokens=NEW_TOKENS)
    calls = []
    monkeypatch.setattr(torch.cuda, "_sleep", lambda n: calls.append(n))
    monkeypatch.setattr(routing, "count", lambda *a: calls.append(a))
    server.generate(batch, max_new_tokens=NEW_TOKENS)
    assert server._decode.last.capture.kept and not calls


@pytest.mark.cuda
def test_a_span_puts_no_range_on_the_device_timeline(cuda):
    """A span's profiler range is a host event only: no copy of it lies
    among the device events, where it would count as device work."""
    x = torch.ones(1 << 20, device=cuda)

    def work():
        with TRACER.span("test.work"), regions.region("test.region"):
            for _ in range(4):
                x.mul_(1.0)
    events = _device_events(work)
    assert any("elementwise" in n or "mul" in n.lower() for n, _, _ in events)
    assert not [n for n, _, _ in events if n.startswith("repro.")]
