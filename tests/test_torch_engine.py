"""The port's simulator core (engine, fastsched, timing, memory, topology)
against the reference package's: identical ``SimReport.summary()`` dicts on
the same HLO text, over scheduler x memory_model x topology_model.

The texts are the hand-built modules of the scheduler tests (copied here as
strings), the doctor's demo pathologies, and a live capture of the reference
LeNet smoke training step.  The copied code is framework-free, so the
comparison is exact: no tolerance.
"""
import dataclasses
import itertools
import math

import jax
import jax.numpy as jnp
import pytest

from repro import config as RC
from repro.core import Simulator as RefSimulator
from repro.core.engine import Engine as RefEngine
from repro.core.hlo_ir import parse_hlo_module as ref_parse
from repro.core.hw import CHIPS as REF_CHIPS
from repro.models import build_model
from repro.obs.doctor import demo_module_src
from repro_torch.core.engine import Engine
from repro_torch.core.hlo_ir import parse_hlo_module
from repro_torch.core.hw import CHIPS, H100

# ---------------------------------------------------------------------------
# hand-built HLO modules (copied from the scheduler tests)
# ---------------------------------------------------------------------------

_DIAMOND = """
ENTRY %main (p0: f32[1024,1024]) -> f32[1024,1024] {
  %p0 = f32[1024,1024]{1,0} parameter(0)
  %dot.a = f32[1024,1024]{1,0} dot(%p0, %p0), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %exp.b = f32[1024,1024]{1,0} exponential(%p0)
  ROOT %add.j = f32[1024,1024]{1,0} add(%dot.a, %exp.b)
}
"""

_WHILE_THEN_COLLECTIVE = """
%addc (x: f32[], y: f32[]) -> f32[] {
  %x = f32[] parameter(0)
  %y = f32[] parameter(1)
  ROOT %s = f32[] add(%x, %y)
}

%cond (c0: (s32[], f32[4096,4096])) -> pred[] {
  %c0 = (s32[], f32[4096,4096]) parameter(0)
  %it = s32[] get-tuple-element(%c0), index=0
  %lim = s32[] constant(3)
  ROOT %lt = pred[] compare(%it, %lim), direction=LT
}

%body (b0: (s32[], f32[4096,4096])) -> (s32[], f32[4096,4096]) {
  %b0 = (s32[], f32[4096,4096]) parameter(0)
  %bit = s32[] get-tuple-element(%b0), index=0
  %bone = s32[] constant(1)
  %binc = s32[] add(%bit, %bone)
  %bx = f32[4096,4096]{1,0} get-tuple-element(%b0), index=1
  ROOT %btup = (s32[], f32[4096,4096]) tuple(%binc, %bx)
}

ENTRY %main (p0: f32[4096,4096]) -> f32[4096,4096] {
  %p0 = f32[4096,4096]{1,0} parameter(0)
  %ar1 = f32[4096,4096]{1,0} all-reduce(%p0), replica_groups={{0,1,2,3}}, to_apply=%addc
  %zero = s32[] constant(0)
  %init = (s32[], f32[4096,4096]) tuple(%zero, %ar1)
  %w = (s32[], f32[4096,4096]) while(%init), condition=%cond, body=%body
  %res = f32[4096,4096]{1,0} get-tuple-element(%w), index=1
  ROOT %ar2 = f32[4096,4096]{1,0} all-reduce(%res), replica_groups={{0,1,2,3}}, to_apply=%addc
}
"""

_CALL_ROOT_COLLECTIVE = """
%addc (x: f32[], y: f32[]) -> f32[] {
  %x = f32[] parameter(0)
  %y = f32[] parameter(1)
  ROOT %s = f32[] add(%x, %y)
}

%coll (cp: f32[2048,2048]) -> f32[2048,2048] {
  %cp = f32[2048,2048]{1,0} parameter(0)
  ROOT %car = f32[2048,2048]{1,0} all-reduce(%cp), replica_groups={{0,1,2,3}}, to_apply=%addc
}

ENTRY %main (p0: f32[2048,2048]) -> f32[2048,2048] {
  %p0 = f32[2048,2048]{1,0} parameter(0)
  %cc = f32[2048,2048]{1,0} call(%p0), to_apply=%coll
  ROOT %dd = f32[2048,2048]{1,0} dot(%cc, %cc), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}
"""

_BUSY_ICI_THEN_WHILE = """
%addc (x: f32[], y: f32[]) -> f32[] {
  %x = f32[] parameter(0)
  %y = f32[] parameter(1)
  ROOT %s = f32[] add(%x, %y)
}

%cond (c0: (s32[], f32[1024,1024])) -> pred[] {
  %c0 = (s32[], f32[1024,1024]) parameter(0)
  %it = s32[] get-tuple-element(%c0), index=0
  %lim = s32[] constant(4)
  ROOT %lt = pred[] compare(%it, %lim), direction=LT
}

%body (b0: (s32[], f32[1024,1024])) -> (s32[], f32[1024,1024]) {
  %b0 = (s32[], f32[1024,1024]) parameter(0)
  %bit = s32[] get-tuple-element(%b0), index=0
  %bone = s32[] constant(1)
  %binc = s32[] add(%bit, %bone)
  %bx = f32[1024,1024]{1,0} get-tuple-element(%b0), index=1
  %bdot = f32[1024,1024]{1,0} dot(%bx, %bx), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %bar = f32[1024,1024]{1,0} all-reduce(%bdot), replica_groups={{0,1,2,3}}, to_apply=%addc
  ROOT %btup = (s32[], f32[1024,1024]) tuple(%binc, %bar)
}

ENTRY %main (p0: f32[4096,4096], p1: f32[1024,1024]) -> f32[1024,1024] {
  %p0 = f32[4096,4096]{1,0} parameter(0)
  %p1 = f32[1024,1024]{1,0} parameter(1)
  %big = f32[4096,4096]{1,0} all-reduce(%p0), replica_groups={{0,1,2,3}}, to_apply=%addc
  %zero = s32[] constant(0)
  %init = (s32[], f32[1024,1024]) tuple(%zero, %p1)
  %w = (s32[], f32[1024,1024]) while(%init), condition=%cond, body=%body
  %res = f32[1024,1024]{1,0} get-tuple-element(%w), index=1
  ROOT %out = f32[1024,1024]{1,0} add(%res, %res)
}
"""

_TWICE_CALLED = """
%f (fp: f32[1024,1024]) -> f32[1024,1024] {
  %fp = f32[1024,1024]{1,0} parameter(0)
  ROOT %fdot = f32[1024,1024]{1,0} dot(%fp, %fp), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}

ENTRY %main (p0: f32[1024,1024]) -> f32[1024,1024] {
  %p0 = f32[1024,1024]{1,0} parameter(0)
  %c1 = f32[1024,1024]{1,0} call(%p0), to_apply=%f
  %c2 = f32[1024,1024]{1,0} call(%p0), to_apply=%f
  ROOT %sum2 = f32[1024,1024]{1,0} add(%c1, %c2)
}
"""

_IND_COLLECTIVE = """
%addc (x: f32[], y: f32[]) -> f32[] {
  %x = f32[] parameter(0)
  %y = f32[] parameter(1)
  ROOT %s = f32[] add(%x, %y)
}

ENTRY %main (p0: f32[2048,2048]) -> f32[2048,2048] {
  %p0 = f32[2048,2048]{1,0} parameter(0)
  %ar = f32[2048,2048]{1,0} all-reduce(%p0), replica_groups={{0,1,2,3}}, to_apply=%addc
  %dt = f32[2048,2048]{1,0} dot(%p0, %p0), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  ROOT %jj = f32[2048,2048]{1,0} add(%ar, %dt)
}
"""

HAND_BUILT = {"diamond": _DIAMOND,
              "while_then_collective": _WHILE_THEN_COLLECTIVE,
              "call_root_collective": _CALL_ROOT_COLLECTIVE,
              "busy_ici_then_while": _BUSY_ICI_THEN_WHILE,
              "twice_called": _TWICE_CALLED,
              "ind_collective": _IND_COLLECTIVE}
SOURCES = (list(HAND_BUILT)
           + [f"doctor:{p}" for p in ("camping", "clean", "no-overlap")]
           + ["lenet_capture"])
KNOBS = list(itertools.product(("batched", "legacy"), (True, False),
                               (True, False)))


@pytest.fixture(scope="module")
def lenet_hlo():
    """HLO text of a live reference capture of the LeNet smoke train step."""
    cfg = RC.get("lenet").smoke
    model = build_model(cfg, conv_algo="gemm")
    params = model.init(jax.random.key(0))

    def step(params, batch):
        loss, grads = jax.value_and_grad(
            lambda p: model.loss(p, batch)[0])(params)
        return jax.tree.map(lambda p, g: p - 0.05 * g, params, grads), loss

    batch = {"images": jax.ShapeDtypeStruct((8, 12, 12, 1), jnp.float32),
             "labels": jax.ShapeDtypeStruct((8,), jnp.int32)}
    abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                            params)
    cap = RefSimulator().capture(step, abstract, batch, name="lenet")
    return cap.compiled.as_text()


def _text(source, lenet_hlo):
    if source in HAND_BUILT:
        return HAND_BUILT[source]
    if source.startswith("doctor:"):
        return demo_module_src(source.split(":", 1)[1])
    return lenet_hlo


def _same(a, b):
    """Exact equality, with NaN equal to NaN."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


@pytest.mark.parametrize("scheduler,memory,topology", KNOBS)
@pytest.mark.parametrize("source", SOURCES)
def test_summary_bit_exact(source, scheduler, memory, topology, lenet_hlo):
    text = _text(source, lenet_hlo)
    kw = dict(memory_model=memory, topology_model=topology,
              scheduler=scheduler)
    ref = RefEngine(REF_CHIPS["tpu-v5e"], **kw).simulate(ref_parse(text))
    port = Engine(CHIPS["tpu-v5e"], **kw).simulate(parse_hlo_module(text))
    assert _same(port.summary(), ref.summary())
    assert len(port.timeline) == len(ref.timeline)


@pytest.mark.parametrize("source", SOURCES)
def test_module_totals_bit_exact(source, lenet_hlo):
    text = _text(source, lenet_hlo)
    assert parse_hlo_module(text).totals() == ref_parse(text).totals()


@pytest.mark.parametrize("chip", ["tpu-v5e", "tpu-v5p"])
def test_tpu_specs_kept_verbatim(chip):
    assert (dataclasses.asdict(CHIPS[chip])
            == dataclasses.asdict(REF_CHIPS[chip]))


def test_h100_spec_is_the_data_sheet():
    assert CHIPS["h100"] is H100
    assert H100.peak_bf16_flops == 989e12
    assert H100.peak_f32_flops == 67e12      # fp32 outside the tensor cores
    assert H100.hbm_bw == 3.35e12
    assert H100.hbm_bytes == 80 * 10**9
    assert H100.ici_link_bw == 450e9


def test_h100_simulates_the_lenet_capture(lenet_hlo):
    rep = Engine(H100).simulate(parse_hlo_module(lenet_hlo))
    s = rep.summary()
    assert s["total_seconds"] > 0 and math.isfinite(s["total_seconds"])
    assert s["peak_hbm_bytes"] <= H100.hbm_bytes
