"""``card_reference`` on the CPU (the profiler's CPU time of each captured
node's operators in place of the card's kernel time, handed to the nodes by
the same attribution, ``_attribute``, as the card's kernels), the capture's
node-to-instruction map it reads, and the ``h100`` spec's energy constants
in the power model."""
import dataclasses
from collections import Counter

import pytest
import torch

from repro_torch import config as C
from repro_torch.core import (H100, V5E, CardReference, Simulator, analyze_power,
                              card_reference, correlate)
from repro_torch.core.correlate import _attribute, profile_runs
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import build_model
from repro_torch.models.lenet import LeNet, sgd_step
from repro_torch.runtime.steps import prefill_step


@pytest.fixture(scope="module")
def smoke_step():
    """The LeNet smoke training step (gemm convs, so its products are the
    hand-kernel op), captured, with real CPU inputs."""
    cfg = C.get("lenet").smoke
    model = LeNet(cfg, conv_algo="gemm", device="cpu")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, cfg.image_hw, cfg.image_hw, cfg.image_c, generator=gen)
    y = torch.randint(0, cfg.num_classes, (8,), generator=gen)
    params = model.param_dict()
    cap = Simulator(hw=H100).capture(
        lambda p, a, b: sgd_step(model, p, a, b, 0.05), params, x, y)
    return cap, (params, x, y)


@pytest.fixture(scope="module")
def smoke_ref(smoke_step):
    cap, args = smoke_step
    return card_reference(cap, *args, n=2)


def _op_nodes(gm):
    return [n for n in gm.graph.nodes if n.op == "call_function"
            and isinstance(n.target, torch._ops.OpOverload)]


def test_every_node_maps_to_instructions_of_the_module(smoke_step):
    cap, _ = smoke_step
    entry = {op.name for op in cap.module.comp(cap.module.entry).ops}
    nodes = _op_nodes(cap.graph)
    assert nodes
    for node in nodes:
        insts = cap.node_instructions.get(node.name)
        assert insts, node
        assert set(insts) <= entry, (node, insts)
    # the hand kernel's node is the module's product
    mm = [n for n in nodes if n.target == torch.ops.repro_torch.tiled_matmul.default]
    assert mm and all(
        [op.opcode for op in cap.module.comp(cap.module.entry).ops
         if op.name in cap.node_instructions[n.name]] == ["dot"] for n in mm)


def test_every_instruction_belongs_to_one_node(smoke_step):
    cap, _ = smoke_step
    owners = {}
    for node, insts in cap.node_instructions.items():
        for i in insts:
            assert i not in owners, (i, owners.get(i), node)
            owners[i] = node
    entry = cap.module.comp(cap.module.entry)
    assert {op.name for op in entry.ops if op.opcode != "tuple"} == set(owners)


def test_card_reference_on_the_cpu_clock(smoke_step, smoke_ref):
    cap, _ = smoke_step
    ref = smoke_ref
    assert isinstance(ref, CardReference) and ref.clock == "cpu" and ref.runs == 2
    assert not ref.unattributed
    nodes = {n.name for n in _op_nodes(cap.graph)}
    assert nodes <= set(ref.node_seconds)
    assert all(t > 0 for t in ref.node_seconds.values())
    assert ref["dot"] > 0


def test_class_sums_equal_the_node_total(smoke_ref):
    ref = smoke_ref
    assert sum(ref.values()) == pytest.approx(ref.attributed_seconds, rel=1e-9)
    assert ref.profile_seconds == pytest.approx(ref.attributed_seconds, rel=1e-9)
    # the LeNet step's nodes are each one opcode: no class of a node's own
    assert not ref.instruction_class and "::" not in "".join(ref)


def test_card_reference_counts_the_graphs_own_work(smoke_step, smoke_ref):
    """The operators attributed a run are those of the graph called as it is
    (no interpreter, no ranges), name by name, in a profile of its own."""
    cap, args = smoke_step
    with torch.no_grad():
        items, _ = profile_runs(lambda: cap.graph(*args), 2, cuda=False)
    assert smoke_ref.runs == 2
    assert smoke_ref.counts == {k: v / 2 for k, v in Counter(it[2] for it in items).items()}


@pytest.mark.parametrize("n", [1, 3])
def test_profile_runs_keeps_the_middle_calls(n):
    """The first and the last call are profiled but not measured: exactly
    the middle ``n`` calls' operators come back, and none from outside."""
    calls = []

    def run():
        calls.append(len(calls))
        torch.full((4,), float(len(calls))).sum()

    items, events = profile_runs(run, n, cuda=False)
    assert calls == list(range(n + 2))
    assert Counter(it[2] for it in items) == {"aten::full": n, "aten::sum": n}
    assert sum(e.name == "aten::full" for e in events) == n + 2


# ranges (start, end, node) as the profiler gives them, sorted, with a gap
RANGES = [(10.0, 20.0, "a"), (20.0, 25.0, "b"), (30.0, 40.0, "c")]


@pytest.mark.parametrize("at,node", [
    (10.0, "a"), (19.9, "a"), (20.0, "b"), (24.9, "b"), (30.0, "c"), (39.0, "c"),
    (5.0, None),        # before the first range
    (25.0, None),       # in the gap: a range's end is not in it
    (27.0, None),
    (40.0, None),       # after the last
    (None, None),       # the issuing call is unknown
])
def test_attribution_hands_work_to_the_range_it_was_issued_in(at, node):
    node_us, left = _attribute([(at, 3.0, "k"), (15.0, 1.0, "k1")], RANGES)
    if node is None:
        assert node_us == {"a": 1.0} and left == {"k": 3.0}
    else:
        assert not left
        assert node_us == ({"a": 4.0} if node == "a" else {"a": 1.0, node: 3.0})


@pytest.fixture(scope="module")
def smoke_prefill():
    """The llama3-8b smoke prefill, captured, and its ``card_reference`` on
    the CPU clock: each layer's attention is one flash-op node, emitted as
    the reference's unfused program."""
    cfg = C.get("llama3-8b").smoke
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    batch = {"tokens": torch.randint(0, 256, (2, 16), generator=torch.Generator().manual_seed(1))}
    cap = Simulator(hw=H100).capture(lambda p, bt: prefill_step(model, p, bt), params, batch,
                                     name="prefill")
    return cfg, cap, card_reference(cap, params, batch, n=1)


def test_a_node_of_several_opcodes_is_a_class_of_its_own(smoke_prefill):
    cfg, cap, ref = smoke_prefill
    cls = "repro_torch::flash_attention"
    flash = [n for n in cap.graph.graph.nodes
             if n.target == torch.ops.repro_torch.flash_attention.default]
    assert len(flash) == cfg.num_layers
    entry = {op.name: op.opcode for op in cap.module.comp(cap.module.entry).ops}
    insts = [i for n in flash for i in cap.node_instructions[n.name]]
    assert {"dot", "exponential"} <= {entry[i] for i in insts}
    # the card's time of the node is not split among its opcodes
    assert set(ref.instruction_class) == set(insts)
    assert set(ref.instruction_class.values()) == {cls}
    assert ref[cls] == pytest.approx(sum(ref.node_seconds[n.name] for n in flash))
    # and the simulated side sums the same instructions into the same class
    cr = correlate(cap, H100, ref)
    rows = {r.kernel: r for r in cr.rows}
    assert rows[cls].sim_seconds > 0 and rows[cls].ref_seconds == ref[cls]
    timeline = Simulator(hw=H100).performance(cap).timeline
    assert rows[cls].sim_seconds == pytest.approx(
        sum(e.duration * e.scale for e in timeline if e.name in ref.instruction_class))
    assert cr.sim_total == pytest.approx(sum(e.duration * e.scale for e in timeline))
    # the roofline stand-in keeps every instruction under its opcode
    assert cls not in {r.kernel for r in correlate(cap, H100).rows}


def test_the_flash_op_lays_its_cpu_output_out_like_q():
    """As the kernel and the op's fake do, so that the captured graph's views
    of the output replay on CPU tensors."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 5, 4, 8, generator=gen).transpose(1, 2)    # (b, h, s, d) view
    k, v = (torch.randn(2, 5, 2, 8, generator=gen).transpose(1, 2) for _ in range(2))
    out = flash_attention(q, k, v)
    assert out.stride() == q.stride()
    assert out.transpose(1, 2).view(2, 5, 32).shape == (2, 5, 32)


def test_correlate_against_the_card_reference(smoke_step, smoke_ref):
    cap, _ = smoke_step
    cr = correlate(cap, H100, smoke_ref)
    rows = {r.kernel: r for r in cr.rows}
    assert rows["dot"].ref_seconds == smoke_ref["dot"]
    assert cr.ref_total == pytest.approx(sum(smoke_ref.values()))
    assert -1.0 <= cr.correlation <= 1.0
    assert "TOTAL" in cr.table()
    # the default is the roofline stand-in, on the same classes
    stand_in = correlate(cap, H100)
    assert {r.kernel for r in stand_in.rows} >= {c for c, t in smoke_ref.items()
                                                  if c not in ("get-tuple-element",)}


def test_an_unmapped_node_raises(smoke_step):
    cap, args = smoke_step
    node = next(n for n in _op_nodes(cap.graph)
                if n.target == torch.ops.repro_torch.tiled_matmul.default)
    broken = dataclasses.replace(cap, node_instructions={
        k: v for k, v in cap.node_instructions.items() if k != node.name})
    with pytest.raises(RuntimeError, match=node.name):
        card_reference(broken, *args, n=1)


def test_card_reference_needs_a_run():
    with pytest.raises(ValueError):
        card_reference(None, n=0)


def test_h100_has_energy_constants_of_its_own():
    fields = ("pj_per_mxu_flop", "pj_per_vpu_flop", "pj_per_hbm_byte",
              "pj_per_vmem_byte", "pj_per_ici_byte", "static_watts")
    for f in fields:
        assert getattr(H100, f) > 0
        assert getattr(H100, f) != getattr(V5E, f), f


@pytest.mark.parametrize("hw", [H100, V5E], ids=["h100", "tpu-v5e"])
def test_power_shares_sum_to_one(smoke_step, hw):
    cap, _ = smoke_step
    rep = Simulator(hw=hw).performance(cap)
    pr = analyze_power(rep, hw)
    assert sum(pr.shares.values()) == pytest.approx(1.0)
    assert pr.total_j == pytest.approx(sum(pr.energy_j.values()))
    assert pr.avg_watts == pytest.approx(pr.total_j / rep.total_seconds)
    assert pr.energy_j["idle/static"] == pytest.approx(hw.static_watts * rep.total_seconds)
    assert Simulator(hw=hw).power(rep).table() == pr.table()
