"""The Mamba2 mixer kernels' route, ops and counts on the CPU.

The kernels run only on the card (``tests/test_torch_cuda_ssm_mixer.py``);
here: which mixers the route gives them (16-bit CUDA tensors off a mesh at
the compiled shapes with no gradient needed) and which keep the plain code
(CPU, fp32, ``meta``, gradient-requiring and DTensor inputs, parameters in
another type than the activations, shapes they are not compiled for); the ops' fake implementations and plain versions, which
are the model's plain steps laid out as the kernels lay them out; a prefill
through the ops (CPU stand-ins for the kernels) against the plain prefill
and the scan inputs it hands over uncopied; the CPU prefill against the JAX
reference's mixer; the layer counters and the benchmark's reader of them; the
launchers' refusals and their counts in a captured graph; and a capture of
the ops.
"""
import dataclasses
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.profiler import ProfilerActivity, profile

from repro import config as RC
from repro.models import ssm as ref_ssm
from repro_torch import config as C
from repro_torch.core.capture import capture
from repro_torch.kernels.ssd_scan.kernel import readable
from repro_torch.kernels.ssd_scan.ops import positions_major
from repro_torch.kernels.ssm_mixer import (conv_in_ref, gated_norm_ref, mixer_route,
                                           scan_inputs, ssm_conv_in, ssm_conv_in_op,
                                           ssm_gated_norm, ssm_gated_norm_op)
from repro_torch.models import build_model, ssm
from repro_torch.obs.metrics import REGISTRY

ROOT = Path(__file__).resolve().parents[1]
#: (d_inner, groups, n): the published Zamba2, the reference's zamba2-7b at
#: full width (one group) and HybridLM's smoke config (d 64, one group of 16)
SHAPES = {"published": (7168, 2, 64), "zamba2-7b": (7168, 1, 64), "hybrid smoke": (128, 1, 16)}


def _fake(d_inner, groups, n, s=300, dtype=torch.bfloat16, device="cuda", tweak=None):
    """(zxbcdt, conv_w, conv_b, dt_bias, a_log, d_skip, norm) as fakes,
    changed by ``tweak(list)`` in the same fake mode."""
    heads, ch = d_inner // 64, d_inner + 2 * groups * n
    with FakeTensorMode():
        args = [torch.empty(2, s, d_inner + ch + heads, dtype=dtype, device=device),
                torch.empty(4, ch, dtype=dtype, device=device),
                torch.empty(ch, dtype=dtype, device=device),
                *(torch.empty(heads, dtype=dtype, device=device) for _ in range(3)),
                torch.empty(d_inner, dtype=dtype, device=device)]
        if tweak is not None:
            tweak(args)
    return args


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_the_route_gives_the_kernels_16_bit_cuda_mixers_at_the_compiled_shapes(shape, dtype):
    d_inner, groups, n = SHAPES[shape]
    args = _fake(d_inner, groups, n, dtype=dtype)
    assert mixer_route(*args, groups) == "kernels"
    args = _fake(d_inner, groups, n, dtype=dtype, tweak=lambda a: a[1].requires_grad_())
    with torch.no_grad():   # a gradient-requiring parameter that no gradient is taken of
        assert mixer_route(*args, groups) == "kernels"


@pytest.fixture
def cuda_mesh():
    """A one-rank mesh of "cuda" devices over a fake process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    mine = not dist.is_initialized()
    if mine:
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        yield DeviceMesh("cuda", [0], _init_backend=False)
    finally:
        if mine:
            dist.destroy_process_group()


@pytest.mark.parametrize("case", ["cpu", "fp32", "meta", "grad", "dtensor", "mixed params",
                                  "fp32 params", "fp16 params", "fp8 params", "head dim 32",
                                  "width 3", "odd channels", "16 groups", "d_inner 8256",
                                  "empty"])
def test_the_route_keeps_the_plain_code_elsewhere(case, request):
    d_inner, groups, n = SHAPES["published"]
    dtype, device, s = torch.bfloat16, "cuda", 300
    if case == "cpu":
        device = "cpu"
    elif case == "fp32":
        dtype = torch.float32
    elif case == "meta":
        device = "meta"
    elif case == "odd channels":      # c = d_inner + 2 g n off a multiple of 8
        n = 3
    elif case == "16 groups":
        groups = 16
    elif case == "d_inner 8256":      # past the norm's registers
        d_inner = 8256
    elif case == "empty":
        s = 0
    def tweak(args):
        if case == "grad":
            args[1].requires_grad_()
        elif case == "mixed params":
            args[3] = args[3].float()
        elif case == "fp32 params":       # parameters in another type than the activations
            args[1:] = [a.float() for a in args[1:]]
        elif case == "fp16 params":
            args[1:] = [a.half() for a in args[1:]]
        elif case == "fp8 params":
            args[1:] = [a.to(torch.float8_e4m3fn) for a in args[1:]]
        elif case == "head dim 32":       # heads of 32: dt_bias twice as long
            args[3:6] = [torch.empty(224, dtype=dtype, device=device) for _ in range(3)]
        elif case == "width 3":
            args[1] = torch.empty(3, args[1].shape[1], dtype=dtype, device=device)

    args = _fake(d_inner, groups, n, s, dtype, device, tweak)
    if case == "dtensor":
        from torch.distributed.tensor import DTensor, Replicate
        args[0] = DTensor.from_local(args[0], request.getfixturevalue("cuda_mesh"),
                                     [Replicate()], run_check=False)
        assert args[0].device.type == "cuda"
    assert mixer_route(*args, groups) == "plain"


def test_the_fakes_give_the_outputs_shapes_dtypes_and_layouts():
    d_inner, groups, n = SHAPES["published"]
    zxbcdt, w, b, dt_bias, a_log, d_skip, norm, y = _fake(
        d_inner, groups, n, s=4087,
        tweak=lambda a: a.append(torch.empty(2, 4087, 112, 64, dtype=torch.bfloat16,
                                             device="cuda")))
    xbc, dA, xh, tail = ssm_conv_in_op(zxbcdt, w, b, dt_bias, a_log, d_inner)
    assert [tuple(t.shape) for t in (xbc, dA, xh, tail)] == [
        (2, 7424, 4088), (2, 112, 4087), (2, 4087, 7168), (2, 3, 7424)]
    assert [t.dtype for t in (xbc, dA, xh, tail)] == [torch.bfloat16, torch.float32,
                                                      torch.bfloat16, torch.bfloat16]
    out = ssm_gated_norm_op(y, xh, zxbcdt, d_skip, norm, groups, 1e-5)
    assert (tuple(out.shape), out.dtype, out.device.type) == ((2, 4087, 7168), torch.bfloat16,
                                                               "cuda")


def _weights(d_inner, groups, n, s, dtype=torch.float32, seed=0):
    """A layer's mixer inputs on the CPU: the in_proj output at unit scale,
    Mamba2's decays and steps, random conv weights, D and gammas."""
    gen = torch.Generator().manual_seed(seed)
    heads, ch = d_inner // 64, d_inner + 2 * groups * n
    params = {"conv_w": 0.5 * torch.randn(4, ch, generator=gen),
              "conv_b": 0.1 * torch.randn(ch, generator=gen),
              "dt_bias": torch.log(torch.expm1(0.001 + 0.1 * torch.rand(heads, generator=gen))),
              "a_log": torch.log(1 + 15 * torch.rand(heads, generator=gen)),
              "d_skip": 1 + 0.1 * torch.randn(heads, generator=gen),
              "norm": 0.1 * torch.randn(d_inner, generator=gen)}
    zxbcdt = torch.randn(2, s, d_inner + ch + heads, generator=gen)
    return zxbcdt.to(dtype), {k: v.to(dtype) for k, v in params.items()}


def _cfg(d_inner, n):
    return dataclasses.replace(C.get("zamba2-7b").smoke, d_model=d_inner // 2, ssm_state=n,
                               norm_eps=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 2, 40, 37])
def test_the_plain_versions_are_the_models_plain_steps_in_the_kernels_layout(s, dtype):
    """conv_in_ref's xdt, B, C, dA and xh, read through :func:`scan_inputs`,
    and its raw tail are the model's plain conv and dt steps bit for bit;
    gated_norm_ref is its plain skip, gate and norm."""
    d_inner, groups, n = 128, 2, 16
    zxbcdt, params = _weights(d_inner, groups, n, s, dtype)
    cfg = _cfg(d_inner, n)
    z, xh, xdt, dA, B, C_, raw = ssm._mixer_inputs(params, cfg, zxbcdt, groups)
    xbc, dA2, xh2, tail = conv_in_ref(zxbcdt, *(params[k] for k in ssm._MIXER_PARAMS[:4]),
                                      d_inner)
    assert xbc.shape[-1] % 8 == 0 and torch.equal(xbc[..., s:], torch.zeros_like(xbc[..., s:]))
    got = scan_inputs(xbc, dA2, d_inner, groups)
    for mine, want in zip(got, (xdt, dA, B, C_)):
        assert mine.shape == want.shape and torch.equal(mine, want)
    assert torch.equal(xh2, xh.flatten(-2)) and torch.equal(tail, raw[:, -3:])
    y = torch.randn(xdt.shape).to(dtype)
    want = ssm._mixer_gate(params, cfg, y, xh, z, groups)
    assert torch.equal(gated_norm_ref(y, xh2, zxbcdt, params["d_skip"], params["norm"], groups,
                                      cfg.norm_eps), want)


@pytest.mark.parametrize("s", [4088, 4087, 300, 5])
def test_the_scan_inputs_are_read_as_they_lie_at_any_length(s):
    """The views of ssm_conv_in's outputs that the scan gets are readable
    by its kernel as they lie: no copy at any prompt length."""
    d_inner, groups, n = 128, 2, 16
    xbc = torch.empty(1, d_inner + 2 * groups * n, -(-s // 8) * 8, dtype=torch.bfloat16)
    xdt, dA, B, C_ = scan_inputs(xbc, torch.empty(1, 2, s), d_inner, groups)
    assert tuple(xdt.shape) == (1, s, 2, 64) and tuple(B.shape) == (1, s, 2, 16)
    assert tuple(dA.shape) == (1, s, 2)
    for t in (xdt, B, C_):
        assert readable(t) and positions_major(t) is t


def test_the_ops_on_the_cpu_are_the_plain_versions_and_check_out():
    d_inner, groups, n = 128, 2, 16
    zxbcdt, params = _weights(d_inner, groups, n, 21, torch.bfloat16)
    conv = (zxbcdt, *(params[k] for k in ssm._MIXER_PARAMS[:4]), d_inner)
    assert all(torch.equal(a, b) for a, b in zip(ssm_conv_in_op(*conv), conv_in_ref(*conv)))
    torch.library.opcheck(ssm_conv_in_op, conv, test_utils=("test_schema", "test_faketensor"))
    y = torch.randn(2, 21, 2, 64).to(torch.bfloat16)
    xh = torch.randn(2, 21, d_inner).to(torch.bfloat16)
    gate = (y, xh, zxbcdt, params["d_skip"], params["norm"], groups, 1e-5)
    assert torch.equal(ssm_gated_norm_op(*gate), gated_norm_ref(*gate))
    torch.library.opcheck(ssm_gated_norm_op, gate, test_utils=("test_schema",
                                                               "test_faketensor"))


def _prefill(arch, tokens):
    cfg = dataclasses.replace(C.get(arch).smoke, dtype="float32")
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    with torch.no_grad():
        return cfg, model.prefill(params, {"tokens": tokens})


def _counted(fn):
    REGISTRY.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    counts = (REGISTRY.value("ssm_mixer_layers_total", step="eager"),
              REGISTRY.value("ssm_mixer_kernel_layers_total", step="eager"))
    REGISTRY.clear()
    return out, counts


@pytest.mark.parametrize("s", [40, 37])
@pytest.mark.parametrize("arch", ["zamba2-7b", "zamba2-7b-instruct"])
def test_a_prefill_through_the_ops_is_the_plain_prefill(arch, s):
    """The kernel route with the ops' CPU versions standing in for the
    kernels: the plain prefill's logits and caches; every layer counted, on
    the kernels' counter too."""
    tokens = torch.randint(0, 256, (2, s), generator=torch.Generator().manual_seed(s))
    (cfg, (want, want_cache)), plain = _counted(lambda: _prefill(arch, tokens))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ssm, "mixer_route", lambda *a: "kernels")
        (_, (got, cache)), kernels = _counted(lambda: _prefill(arch, tokens))
    layers = cfg.num_layers
    assert plain == (layers, 0) and kernels == (layers, layers)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    flat = [(a, b) for a, b in zip(jax.tree.leaves(want_cache), jax.tree.leaves(cache))]
    assert len(flat) > 0
    for a, b in flat:
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)


def test_a_cpu_prefill_mixer_is_the_reference_mixer():
    """The port's plain mixer (the route's choice on the CPU) against
    ``repro.models.ssm.ssm_mixer`` on the same fp32 weights and input; the
    CPU counts the layer and not the kernels'."""
    ref_cfg = dataclasses.replace(RC.get("zamba2-7b").smoke, dtype="float32")
    cfg = dataclasses.replace(C.get("zamba2-7b").smoke, dtype="float32")
    rng = np.random.default_rng(3)
    specs = ref_ssm.ssm_param_specs(ref_cfg)
    # unit-scale activations, as tests/test_torch_hybrid.py draws them
    weights = {k: ((1.0 if v.init == "ones" else 0.0) + 0.1 * rng.standard_normal(v.shape)
                   if v.init in ("zeros", "ones")
                   else rng.standard_normal(v.shape) / np.sqrt(v.shape[-2])).astype(np.float32)
               for k, v in specs.items()}
    # Mamba2's decays and steps (tests/test_torch_hybrid.py says why)
    weights["a_log"] = np.log(rng.uniform(1, 16, weights["a_log"].shape)).astype(np.float32)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), weights["dt_bias"].shape))
    weights["dt_bias"] = (dt + np.log(-np.expm1(-dt))).astype(np.float32)
    x = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    want = ref_ssm.ssm_mixer({k: jnp.asarray(v) for k, v in weights.items()}, ref_cfg,
                             jnp.asarray(x))
    params = {k: torch.from_numpy(v) for k, v in weights.items()}
    (got, _), counts = _counted(lambda: ssm.ssm_prefill(params, cfg, torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    assert counts == (1, 0)


def _reader():
    """The benchmark's reader, ``port_bench/metrics/ssm_mixer_kernel_pct.prefill.py``."""
    import importlib.util
    path = ROOT / "port_bench" / "metrics" / "ssm_mixer_kernel_pct.prefill.py"
    spec = importlib.util.spec_from_file_location("reader_ssm_mixer_kernel_pct", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kernel,layers,want", [(None, 81, None), (0, 0, None), (81, 81, 100.0),
                                                (40, 81, 100.0 * 40 / 81)])
def test_the_reader_gives_the_kernels_share_of_the_prefill_layers(kernel, layers, want):
    REGISTRY.clear()
    try:
        if layers:
            REGISTRY.counter("ssm_mixer_layers_total", step="prefill").inc(layers)
        if kernel is not None:
            REGISTRY.counter("ssm_mixer_kernel_layers_total", step="prefill").inc(kernel)
        got = _reader().read(SimpleNamespace())
    finally:
        REGISTRY.clear()
    assert got == (None if want is None else pytest.approx(want))


def test_the_launchers_refuse_cpu_tensors_and_launch_nothing():
    zxbcdt, params = _weights(128, 1, 16, 8, torch.bfloat16)
    before = ssm_conv_in.launches, ssm_gated_norm.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssm_conv_in(zxbcdt, *(params[k] for k in ssm._MIXER_PARAMS[:4]), 128)
    with pytest.raises(ValueError, match="CUDA"):
        ssm_gated_norm(torch.zeros(2, 8, 2, 64, dtype=torch.bfloat16),
                       torch.zeros(2, 8, 128, dtype=torch.bfloat16), zxbcdt,
                       params["d_skip"], params["norm"], 1, 1e-5)
    assert (ssm_conv_in.launches, ssm_gated_norm.launches) == before


def test_graph_replays_count_both_launchers(monkeypatch):
    """Launches made while a compiled step is captured count in its
    capture, not on the launchers; each replay of its graph adds them."""
    from repro_torch.kernels.dispatch import launch
    from repro_torch.kernels.ssm_mixer import kernel
    from repro_torch.obs import regions
    from repro_torch.runtime import jit

    class _Stub:
        def replay(self):
            pass

    for entry in (kernel._CONV_IN, kernel._GATED_NORM):
        monkeypatch.setattr(entry, "fn", lambda *args: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=7))
    cap = regions.Capture("prefill", 7)
    monkeypatch.setattr(regions, "capturing", lambda: cap)
    before = ssm_conv_in.launches, ssm_gated_norm.launches
    for _ in range(81):
        launch(kernel._CONV_IN, ssm_conv_in, torch.device("cuda"), detail=lambda: "")
        launch(kernel._GATED_NORM, ssm_gated_norm, torch.device("cuda"), detail=lambda: "")
    assert (ssm_conv_in.launches, ssm_gated_norm.launches) == before
    assert cap.launches == {ssm_conv_in: 81, ssm_gated_norm: 81}
    graph = jit.Graph(_Stub(), [], None, cap)
    graph.replay()
    assert (ssm_conv_in.launches, ssm_gated_norm.launches) == (before[0] + 81, before[1] + 81)
    assert graph.launches["ssm_conv_in"] == graph.launches["ssm_gated_norm"] == 81


def test_a_capture_of_the_ops_holds_the_plain_mixers_work():
    """On the card a capture traces each op as one node a layer; its
    emitter inlines the plain version, so the module has the plain mixer's
    products.  (CPU fakes, with the ops as the kernels' stand-ins.)"""
    def dot_flops(m):
        return sum(sc * m.op_flops(c, op)["mxu"] for op, c, sc in m.walk_entry()
                   if op.opcode == "dot")

    cfg = dataclasses.replace(_cfg(128, 16), dtype="float32")
    zxbcdt, params = _weights(128, 2, 16, 40)
    params["in_proj"] = torch.randn(cfg.d_model, zxbcdt.shape[-1])
    params["out_proj"] = torch.randn(128, cfg.d_model)
    x = torch.randn(2, 40, cfg.d_model)

    def mixer(x, *leaves):
        p = dict(zip(sorted(params), leaves))
        return ssm.ssm_prefill(p, cfg, x, 2, 16)[0]

    leaves = [params[k] for k in sorted(params)]
    plain = capture(mixer, x, *leaves)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ssm, "mixer_route", lambda *a: "kernels")
        caps = [plain, capture(mixer, x, *leaves)]
    targets = [[str(n.target) for n in c.graph.graph.nodes if n.op == "call_function"]
               for c in caps]
    assert targets[1].count("repro_torch.ssm_conv_in.default") == 1
    assert targets[1].count("repro_torch.ssm_gated_norm.default") == 1
    assert len(targets[1]) < len(targets[0])
    assert dot_flops(caps[1].module) == dot_flops(caps[0].module) > 0
