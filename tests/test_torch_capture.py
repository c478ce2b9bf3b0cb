"""The port's capture frontend: a PyTorch training step traced with
``make_fx`` and emitted as HLO text for the copied parser.

Product FLOPs (``dot`` + ``convolution``) of the captured LeNet smoke step
must equal the analytic count of its products and the live reference
capture's, for the two algorithms whose products are the same in both
packages (``gemm``, ``implicit``).  ``winograd`` and ``fft`` differ by
design: the port's Winograd transforms run inside one kernel op (modeled as
elementwise work), where the reference's ``jnp.einsum`` transforms count as
``dot``s; the fft paths contract complex spectra in differently shaped
products.  HBM bytes are held to a band: the port's capture has one op per
eager launch and no fusion, while XLA's CPU capture fuses elementwise work
but adds layout copies of its own.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from repro import config as RC
from repro.core import Simulator as RefSimulator
from repro.models import build_model
from repro_torch import config as C
from repro_torch.core import H100, Simulator, capture
from repro_torch.kernels.winograd.ops import conv3x3_winograd_op, winograd_tiles_op
from repro_torch.models.conv_algos import CONV_FNS
from repro_torch.models.lenet import LeNet, sgd_step

BATCH = 8


def _analytic_product_flops(cfg, b, conv_grad_input_full):
    """2*M*N*K over every product of one SGD step of LeNet.

    Forward: conv1, conv2, fc1..fc3.  Backward: every filter/weight gradient
    (same FLOPs as its forward) and every input gradient except conv1's (the
    images need none).  An implicit conv's input gradient is a convolution
    over the whole padded input, as XLA and cuDNN lower it.
    """
    k, (c1, c2), hw = cfg.conv_kernel, cfg.conv_channels, cfg.image_hw
    f1, f2 = cfg.fc_dims
    h1 = hw // 2
    o2 = h1 - (k - 1)
    flat = (o2 // 2) ** 2 * c2
    conv1 = 2 * b * hw * hw * c1 * k * k * cfg.image_c
    conv2 = 2 * b * o2 * o2 * c2 * k * k * c1
    conv2_dx = 2 * b * h1 * h1 * c1 * k * k * c2 if conv_grad_input_full else conv2
    fcs = [2 * b * flat * f1, 2 * b * f1 * f2, 2 * b * f2 * cfg.num_classes]
    return 2 * (conv1 + conv2 + sum(fcs)) + conv2_dx + sum(fcs)


def _mxu_flops(module):
    return sum(scale * module.op_flops(comp, op)["mxu"]
               for op, comp, scale in module.walk_entry())


def _torch_step_capture(algo):
    cfg = C.get("lenet").smoke
    model = LeNet(cfg, conv_algo=algo, device="cpu")
    images = torch.zeros(BATCH, cfg.image_hw, cfg.image_hw, cfg.image_c)
    labels = torch.zeros(BATCH, dtype=torch.long)
    return capture(lambda p, x, y: sgd_step(model, p, x, y),
                   model.param_dict(), images, labels, name=algo)


@pytest.fixture(scope="module")
def ref_captures():
    """Live reference captures of the same smoke step (module-scoped)."""
    cfg = RC.get("lenet").smoke
    out = {}
    for algo in ("gemm", "implicit"):
        model = build_model(cfg, conv_algo=algo)
        params = model.init(jax.random.key(0))

        def step(params, batch, model=model):
            loss, grads = jax.value_and_grad(
                lambda p: model.loss(p, batch)[0])(params)
            return jax.tree.map(lambda p, g: p - 0.05 * g, params, grads), loss

        abstract = jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params)
        batch = {"images": jax.ShapeDtypeStruct((BATCH, 12, 12, 1), jnp.float32),
                 "labels": jax.ShapeDtypeStruct((BATCH,), jnp.int32)}
        out[algo] = RefSimulator().capture(step, abstract, batch, name=algo)
    return out


@pytest.mark.parametrize("algo", ["gemm", "implicit"])
def test_product_flops_match_analytic_and_reference(algo, ref_captures):
    cap = _torch_step_capture(algo)
    analytic = _analytic_product_flops(C.get("lenet").smoke, BATCH,
                                       conv_grad_input_full=(algo == "implicit"))
    assert _mxu_flops(cap.module) == analytic
    assert _mxu_flops(cap.module) == _mxu_flops(ref_captures[algo].module)


@pytest.mark.parametrize("algo", ["gemm", "implicit"])
def test_hbm_bytes_within_band_of_reference(algo, ref_captures):
    port = _torch_step_capture(algo).module.totals()["hbm_bytes"]
    ref = ref_captures[algo].module.totals()["hbm_bytes"]
    # measured at this size: 0.98x (gemm) and 0.60x (implicit)
    assert 0.5 * ref <= port <= 1.5 * ref, (port, ref)


def test_every_kernel_launch_is_one_node():
    """The gemm step's 14 products are 14 tiled_matmul nodes: 5 forward,
    5 weight gradients and 4 input gradients (the images need none)."""
    cap = _torch_step_capture("gemm")
    op = torch.ops.repro_torch.tiled_matmul.default
    nodes = [n for n in cap.graph.graph.nodes if n.target is op]
    assert len(nodes) == 14
    dots = [o for o in cap.module.comp(cap.module.entry).ops if o.opcode == "dot"]
    assert len(dots) == 14
    assert all("lhs_contracting_dims={1}" in o.raw for o in dots)


def test_winograd_node_is_three_instructions():
    x = torch.zeros(64, 28, 28, 16)
    w = torch.zeros(3, 3, 16, 32)
    cap = capture(lambda a, b: CONV_FNS["winograd"](a, b, "SAME"), x, w)
    comp = cap.module.comp(cap.module.entry)
    node = [o for o in comp.ops if o.opcode == "dot" and o.name.endswith(".m")]
    assert len(node) == 1
    tiles = 64 * 14 * 14
    assert cap.module.op_flops(comp, node[0])["mxu"] == 2 * 16 * tiles * 16 * 32
    for suffix in (".v", ""):
        name = node[0].name[:-2] + suffix
        assert comp.by_name[name].opcode == "multiply"


def test_convolution_filter_is_emitted_hwio():
    x = torch.zeros(2, 9, 9, 3)
    w = torch.zeros(5, 5, 3, 7)
    cap = capture(lambda a, b: CONV_FNS["implicit"](a, b, "SAME"), x, w)
    comp = cap.module.comp(cap.module.entry)
    conv = [o for o in comp.ops if o.opcode == "convolution"]
    assert len(conv) == 1
    rhs = comp.by_name[conv[0].operands[1]]
    assert rhs.outputs[0].dims == (5, 5, 3, 7)
    assert cap.module.op_flops(comp, conv[0])["mxu"] == 2 * 2 * 9 * 9 * 7 * 5 * 5 * 3


def test_unmapped_op_raises():
    with pytest.raises(NotImplementedError, match="cummax"):
        capture(lambda a: torch.cummax(a, 0)[0], torch.zeros(4))


@pytest.mark.parametrize("algo", sorted(CONV_FNS))
def test_step_simulates_on_h100(algo):
    rep = Simulator(hw=H100).performance(_torch_step_capture(algo))
    s = rep.summary()
    assert s["total_seconds"] > 0
    assert s["total_flops"] > 0
    assert s["launch_overhead_seconds"] > 0


def _unfused_winograd(x, u, padding):
    """The parent's conv3x3_winograd around the tiles op, written out:
    F.pad, the stride-2 unfold and its copy, winograd_tiles_op, and the
    reassembly."""
    b, H, W, cin = x.shape
    cout = u.shape[-1]
    if padding == "SAME":
        x = F.pad(x, (0, 0, 1, 1, 1, 1))
        H, W = H + 2, W + 2
    oh, ow = H - 2, W - 2
    th, tw = (oh + 1) // 2, (ow + 1) // 2
    x = F.pad(x, (0, 0, 0, 2 * tw + 2 - W, 0, 2 * th + 2 - H))
    tiles = x.unfold(1, 4, 2).unfold(2, 4, 2).permute(0, 1, 2, 4, 5, 3).contiguous()
    y = winograd_tiles_op(tiles, u)
    out = y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * th, 2 * tw, cout)
    return out[:, :oh, :ow]


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_fused_winograd_capture_prices_the_unfused_program(padding):
    """At the section V case study the fused op's capture keeps the
    analytic dot FLOPs and is priced within 1% of the unfused program's:
    the simulator models the paper's nonfused Winograd either way."""
    x = torch.zeros(64, 28, 28, 16)
    u = torch.zeros(4, 4, 16, 32)
    fused = capture(lambda a, b: conv3x3_winograd_op(a, b, padding), x, u)
    unfused = capture(lambda a, b: _unfused_winograd(a, b, padding), x, u)
    oh = 28 if padding == "SAME" else 26
    tiles = 64 * ((oh + 1) // 2) ** 2
    assert _mxu_flops(fused.module) == _mxu_flops(unfused.module) == 2 * 16 * tiles * 16 * 32
    sim = Simulator(hw=H100)
    t_fused = sim.performance(fused).summary()["total_seconds"]
    t_unfused = sim.performance(unfused).summary()["total_seconds"]
    assert abs(t_fused - t_unfused) <= 0.01 * t_unfused
    assert fused.module.totals()["hbm_bytes"] == unfused.module.totals()["hbm_bytes"]
