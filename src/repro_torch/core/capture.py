"""Capture layer: any PyTorch callable -> aten graph -> HLO text -> SimOp IR.

The paper's section III-A adapted to eager PyTorch, and the port's
counterpart of ``repro.core.capture``.  Three steps:

1. ``make_fx(fn, tracing_mode="fake")`` traces ``fn`` on fake copies of the
   example arguments: forward, ``torch.autograd.grad`` and the optimizer
   update all land in one aten graph, and each hand-kernel op
   (``repro_torch::tiled_matmul``, ``repro_torch::conv3x3_winograd``,
   ``repro_torch::winograd_tiles``, ``repro_torch::flash_attention``,
   ``repro_torch::ssd_scan``, ``repro_torch::ssm_conv_in``,
   ``repro_torch::ssm_gated_norm``) is one node in it, forward and backward.
2. Every node is emitted as HLO text in the subset that
   :func:`~repro_torch.core.hlo_ir.parse_hlo_module` reads: one
   instruction per aten or custom-op node, ``parameter``s for the inputs,
   and a ``ROOT tuple`` of the outputs.
3. The text is parsed by that same parser, so the engine and timing model
   run unchanged on a PyTorch capture.

Mapping notes.  Products become ``dot`` with their contracting (and batch)
dimensions, which ``timing._dot_dims`` and ``SimModule.op_flops`` read.
Convolutions become ``convolution`` with the filter operand re-declared in
HWIO order (the FLOP count multiplies every filter dim but the last).  The
Winograd tiles op becomes an elementwise input transform, a ``dot`` over the
16 transform positions and an elementwise output transform; the fused
Winograd conv op the reference's unfused program around those three (pads,
tile gather, reassembly); the flash-attention
op a q.k^T ``dot`` batched over the kv heads, an ``exponential`` and a p.v
``dot``; the SSD scan op and the two Mamba2 mixer ops their plain
versions (the chunk loop; the conv, dt and gate chains), inlined.  A step traced on DTensors (one rank's program on a mesh) holds
functional collectives: ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_reduce`` and ``all_to_all_single`` (and DTensor's
``shard_dim_alltoall``) become ``all-gather``, ``reduce-scatter``,
``all-reduce`` and ``all-to-all`` with the
``replica_groups`` of their process group's ranks, the pipeline's
``ring_permute`` a ``collective-permute`` with its ``source_target_pairs``,
and ``wait_tensor`` nothing (it names its input).  Views become
``bitcast`` (free, as in eager PyTorch); materialized copies become
``copy``.  An aten op with no mapping raises ``NotImplementedError``.

No fusion: eager PyTorch launches one kernel per op, so the module has one
op per launch, and its HBM bytes are larger than those of XLA's fused
capture of the same step (every intermediate is written and read back).
"""
from __future__ import annotations

import operator
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch.core.hlo_ir import SimModule, parse_hlo_module

_HLO_DTYPES = {
    torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128",
}

_aten = torch.ops.aten

#: aten op -> HLO opcode, for ops emitted as one instruction over their
#: tensor operands
_SIMPLE: Dict[Any, str] = {}


def _map(opcode: str, *ops) -> None:
    for op in ops:
        _SIMPLE[op] = opcode


# views, and ``split``'s tuple of views, are free; so is an uninitialized
# allocation (``empty``), which writes nothing
_map("bitcast", _aten.view.default, _aten._unsafe_view.default,
     _aten.permute.default, _aten.t.default, _aten.transpose.int,
     _aten.expand.default, _aten.unsqueeze.default, _aten.squeeze.dim,
     _aten.squeeze.dims,
     _aten.alias.default, _aten.select.int, _aten.slice.Tensor,
     _aten.unfold.default, _aten.detach.default, _aten.view_as_real.default,
     _aten._conj.default, _aten.split.Tensor, _aten.split_with_sizes.default,
     _aten.as_strided.default, _aten.empty.memory_format, _aten.empty_like.default,
     _aten.empty_strided.default, _aten.new_empty.default,
     _aten.new_empty_strided.default)
_map("copy", _aten.clone.default, _aten.copy_.default,
     _aten.lift_fresh_copy.default)
# in-place forms (the optimizer update, autograd's accumulation into an
# existing gradient) read and write as many bytes as the out-of-place ones
_map("add", _aten.add.Tensor, _aten.add_.Tensor)
_map("subtract", _aten.sub.Tensor, _aten.sub_.Tensor, _aten.rsub.Scalar)
_map("multiply", _aten.mul.Tensor, _aten.mul_.Scalar, _aten.mul_.Tensor,
     _aten.mul.Scalar,
     _aten.pow.Tensor_Scalar,                       # x ** 2, as XLA lowers it
     _aten._softmax_backward_data.default,          # y * (g - sum(g * y))
     _aten.tanh_backward.default)                   # g * (1 - y * y)
_map("divide", _aten.div.Scalar, _aten.div.Tensor, _aten.div_.Tensor,
     _aten.div.Tensor_mode,
     _aten.reciprocal.default)
_map("sqrt", _aten.sqrt.default, _aten.sqrt_.default)
_map("clamp", _aten.clamp.default)
_map("negate", _aten.neg.default)
_map("maximum", _aten.relu.default)
_map("exponential", _aten.exp.default,
     _aten._softmax.default)                        # its exp dominates
_map("rsqrt", _aten.rsqrt.default)
_map("power", _aten.pow.Scalar)
_map("cosine", _aten.cos.default)
_map("sine", _aten.sin.default)
_map("tanh", _aten.tanh.default)
_map("logistic", _aten.silu.default,               # x * sigmoid(x)
     _aten.sigmoid.default, _aten.sigmoid_backward.default,
     _aten.silu_backward.default)
_map("compare", _aten.eq.Tensor, _aten.ge.Scalar, _aten.lt.Scalar, _aten.le.Tensor,
     _aten.lt.Tensor)
_map("and", _aten.bitwise_and_.Tensor, _aten.bitwise_and.Tensor)
_map("select", _aten.where.self, _aten.threshold_backward.default)
_map("reduce", _aten.sum.default, _aten.sum.dim_IntList, _aten.mean.default,
     _aten.mean.dim,
     _aten.argmax.default, _aten.logsumexp.default, _aten.amax.default)
_map("log", _aten.log.default)
_map("reduce-window", _aten.max_pool2d_with_indices.default)
_map("select-and-scatter", _aten.max_pool2d_with_indices_backward.default)
_map("gather", _aten.index.Tensor, _aten.index_select.default)
_map("scatter", _aten.index_put.default, _aten.unfold_backward.default)
_map("pad", _aten.constant_pad_nd.default, _aten.slice_backward.default,
     _aten.select_backward.default)
_map("concatenate", _aten.cat.default, _aten.stack.default)
_map("reverse", _aten.flip.default)
_map("iota", _aten.arange.default, _aten.arange.start_step)
_map("broadcast", _aten.zeros.default, _aten.zeros_like.default, _aten.zero_.default,
     _aten.ones_like.default, _aten.new_zeros.default,
     _aten.scalar_tensor.default, _aten.full.default, _aten.ones.default)
_map("fft", _aten._fft_r2c.default, _aten._fft_c2r.default,
     _aten._fft_c2c.default)
# the model families' routing and scans: top-k and the dispatch sort, the
# binary search of the expert segments, the gathers and scatters of the
# dispatch and their gradients, and the scans' cumulative sums
_map("sort", _aten.topk.default, _aten.sort.stable, _aten.sort.default)
_map("compare", _aten.searchsorted.Tensor)
_map("gather", _aten.gather.default)
_map("scatter", _aten.scatter.src, _aten.scatter_.src, _aten.scatter_add.default,
     _aten.scatter_add_.default)
_map("cumsum", _aten.cumsum.default)
_map("broadcast", _aten.repeat.default, _aten.eye.default, _aten.full_like.default)
_map("select", _aten.tril.default)
_map("log1p", _aten.softplus.default)               # log(1 + exp(x))
_map("logistic", _aten.softplus_backward.default)   # g * sigmoid(x)


def hlo_type(val: Any) -> str:
    """HLO type string of a tensor, or a tuple type of a tensor sequence."""
    if isinstance(val, (tuple, list)):
        return "(" + ", ".join(hlo_type(v) for v in val if v is not None) + ")"
    if val.dtype not in _HLO_DTYPES:
        raise NotImplementedError(f"no HLO type for {val.dtype}")
    dims = ",".join(str(int(d)) for d in val.shape)
    return f"{_HLO_DTYPES[val.dtype]}[{dims}]"


def _shape_type(dtype: torch.dtype, shape: Sequence[int]) -> str:
    return f"{_HLO_DTYPES[dtype]}[{','.join(str(int(d)) for d in shape)}]"


class _Emitter:
    """Walks an aten FX graph and writes one HLO instruction per node."""

    def __init__(self, gm: torch.fx.GraphModule):
        self.gm = gm
        self.lines: List[str] = []
        self.params: List[str] = []
        self.names: Dict[torch.fx.Node, str] = {}
        #: multi-output nodes emitted as separate instructions: index -> name
        self.parts: Dict[torch.fx.Node, Dict[int, str]] = {}
        #: the instructions each node was emitted as, by node name
        self.emitted: Dict[str, List[str]] = {}
        self._current: List[str] = []

    # -- helpers ----------------------------------------------------------
    def inst(self, name: str, type_str: str, opcode: str,
             operands: Sequence[str], attrs: str = "") -> str:
        ops = ", ".join(f"%{o}" for o in operands)
        tail = f", {attrs}" if attrs else ""
        self.lines.append(f"  %{name} = {type_str} {opcode}({ops}){tail}")
        self._current.append(name)
        return name

    def tensor_operands(self, node: torch.fx.Node) -> List[str]:
        out = []

        def visit(a):
            if isinstance(a, torch.fx.Node) and a in self.names:
                out.append(self.names[a])
            elif isinstance(a, (list, tuple)):
                for x in a:
                    visit(x)
        for a in list(node.args) + list(node.kwargs.values()):
            visit(a)
        return out

    @staticmethod
    def val(node: torch.fx.Node) -> Any:
        return node.meta.get("val")

    # -- node kinds -------------------------------------------------------
    def emit(self, node: torch.fx.Node) -> None:
        self._current = self.emitted.setdefault(node.name, [])
        self._emit(node)

    def _emit(self, node: torch.fx.Node) -> None:
        if node.op == "placeholder":
            v = self.val(node)
            if not isinstance(v, torch.Tensor):
                return
            self.lines.append(f"  %{node.name} = {hlo_type(v)} "
                              f"parameter({len(self.params)})")
            self._current.append(node.name)
            self.params.append(f"{node.name}: {hlo_type(v)}")
            self.names[node] = node.name
            return
        if node.op == "get_attr":
            v = getattr(self.gm, node.target)
            if isinstance(v, torch.Tensor):
                self.names[node] = self.inst(node.name, hlo_type(v),
                                             "constant", [])
            return
        if node.op == "output":
            return
        if node.op != "call_function":
            raise NotImplementedError(f"cannot capture FX node kind {node.op!r}")
        target = node.target
        if target is operator.getitem:
            src, idx = node.args
            if src in self.parts:
                if idx in self.parts[src]:
                    self.names[node] = self.parts[src][idx]
                return
            self.names[node] = self.inst(node.name, hlo_type(self.val(node)),
                                         "get-tuple-element",
                                         [self.names[src]], f"index={idx}")
            return
        handler = _SPECIAL.get(target)
        if handler is not None:
            handler(self, node)
            return
        opcode = _SIMPLE.get(target)
        if opcode is None:
            raise NotImplementedError(
                f"capture has no HLO mapping for op {target}")
        self.names[node] = self.inst(node.name, hlo_type(self.val(node)),
                                     opcode, self.tensor_operands(node))

    def finish(self, out_node: torch.fx.Node) -> str:
        leaves = []

        def visit(a):
            if isinstance(a, torch.fx.Node):
                if a in self.names:
                    leaves.append(a)
            elif isinstance(a, (list, tuple)):
                for x in a:
                    visit(x)
            elif isinstance(a, dict):
                for x in a.values():
                    visit(x)
        visit(out_node.args)
        types = ", ".join(hlo_type(self.val(n)) if n.op != "get_attr"
                          else hlo_type(getattr(self.gm, n.target))
                          for n in leaves)
        root = ", ".join(f"%{self.names[n]}" for n in leaves)
        body = "\n".join(self.lines)
        head = f"ENTRY %main ({', '.join(self.params)}) -> ({types}) {{"
        return f"{head}\n{body}\n  ROOT %tuple.out = ({types}) tuple({root})\n}}\n"


# -- special handlers ---------------------------------------------------

def _outer(em: _Emitter, node: torch.fx.Node, a: torch.fx.Node) -> bool:
    """Emit a product whose contracted dim has extent 1 (an outer product,
    as autograd runs the backward of a matrix-vector product) as a
    ``multiply``: it sums nothing, and XLA emits the same product so."""
    if int(em.val(a).shape[-1]) != 1:
        return False
    em.names[node] = em.inst(node.name, hlo_type(em.val(node)), "multiply",
                             em.tensor_operands(node))
    return True


def _dot(em: _Emitter, node: torch.fx.Node) -> None:
    a, b = node.args[0], node.args[1]
    if _outer(em, node, a):
        return
    em.names[node] = em.inst(
        node.name, hlo_type(em.val(node)), "dot",
        [em.names[a], em.names[b]],
        "lhs_contracting_dims={1}, rhs_contracting_dims={0}")


def _addmm(em: _Emitter, node: torch.fx.Node) -> None:
    bias, a, b = node.args[:3]
    if _outer(em, node, a):
        return
    em.names[node] = em.inst(
        node.name, hlo_type(em.val(node)), "dot",
        [em.names[a], em.names[b], em.names[bias]],
        "lhs_contracting_dims={1}, rhs_contracting_dims={0}")


def _bmm(em: _Emitter, node: torch.fx.Node) -> None:
    a, b = node.args[:2]
    if _outer(em, node, a):
        return
    em.names[node] = em.inst(
        node.name, hlo_type(em.val(node)), "dot",
        [em.names[a], em.names[b]],
        "lhs_batch_dims={0}, lhs_contracting_dims={2}, "
        "rhs_batch_dims={0}, rhs_contracting_dims={1}")


def _conv_attrs(window: Sequence[int], groups: int) -> str:
    attrs = f"window={{size={'x'.join(str(int(k)) for k in window)}}}"
    if groups != 1:
        attrs += f", feature_group_count={groups}"
    return attrs


def _convolution(em: _Emitter, node: torch.fx.Node) -> None:
    x, w, bias = node.args[:3]
    transposed, groups = node.args[6], node.args[8]
    if transposed:
        raise NotImplementedError("capture has no mapping for transposed "
                                  "convolution")
    wv = em.val(w)
    co, ci, *k = wv.shape
    w_hwio = em.inst(f"{node.name}.w", _shape_type(wv.dtype, (*k, ci, co)),
                     "bitcast", [em.names[w]])
    operands = [em.names[x], w_hwio] + ([em.names[bias]] if bias is not None else [])
    em.names[node] = em.inst(node.name, hlo_type(em.val(node)), "convolution",
                             operands, _conv_attrs(k, groups))


def _convolution_backward(em: _Emitter, node: torch.fx.Node) -> None:
    """Two convolutions (input and filter gradients) and a bias reduce, as
    XLA lowers the same gradient."""
    grad, x, w = node.args[:3]
    transposed, groups, mask = node.args[7], node.args[9], node.args[10]
    if transposed:
        raise NotImplementedError("capture has no mapping for transposed "
                                  "convolution")
    gv, xv, wv = em.val(grad), em.val(x), em.val(w)
    co, ci, *k = wv.shape
    parts: Dict[int, str] = {}
    if mask[0]:
        w_in = em.inst(f"{node.name}.wt", _shape_type(wv.dtype, (*k, co, ci)),
                       "bitcast", [em.names[w]])
        parts[0] = em.inst(f"{node.name}.dx", _shape_type(xv.dtype, xv.shape),
                           "convolution", [em.names[grad], w_in],
                           _conv_attrs(k, groups))
    if mask[1]:
        # filter gradient: the batch and output positions are contracted,
        # so the incoming gradient plays the filter, laid out (N, OH, OW, Co)
        n, _, *o = gv.shape
        g_rhs = em.inst(f"{node.name}.gt", _shape_type(gv.dtype, (n, *o, co)),
                        "bitcast", [em.names[grad]])
        parts[1] = em.inst(f"{node.name}.dw",
                           _shape_type(wv.dtype, (*k, ci, co)),
                           "convolution", [em.names[x], g_rhs],
                           _conv_attrs(o, groups))
    if mask[2]:
        parts[2] = em.inst(f"{node.name}.db", _shape_type(gv.dtype, (co,)),
                           "reduce", [em.names[grad]])
    em.parts[node] = parts


def _winograd_tiles(em: _Emitter, name: str, tiles: str, u: str,
                    dims: Sequence[int], cout: int, out_type: str) -> str:
    """Input transform, the 16-position contraction, output transform: the
    tiles kernel's work as three instructions."""
    b, th, tw, cin = dims
    n = b * th * tw
    v = em.inst(f"{name}.v", _shape_type(torch.float32, (16, n, cin)),
                "multiply", [tiles])
    u16 = em.inst(f"{name}.u", _shape_type(torch.float32, (16, cin, cout)),
                  "bitcast", [u])
    m = em.inst(f"{name}.m", _shape_type(torch.float32, (16, n, cout)),
                "dot", [v, u16],
                "lhs_batch_dims={0}, lhs_contracting_dims={2}, "
                "rhs_batch_dims={0}, rhs_contracting_dims={1}")
    return em.inst(name, out_type, "multiply", [m])


def _winograd(em: _Emitter, node: torch.fx.Node) -> None:
    tiles, u = node.args[:2]
    b, th, tw, _, _, cin = em.val(tiles).shape
    em.names[node] = _winograd_tiles(em, node.name, em.names[tiles], em.names[u],
                                     (b, th, tw, cin), em.val(u).shape[-1],
                                     hlo_type(em.val(node)))


def _conv3x3_winograd(em: _Emitter, node: torch.fx.Node) -> None:
    """The fused Winograd conv, emitted as the reference's unfused XLA
    program computes it, so the simulator models the paper's nonfused
    Winograd whatever the card runs: the SAME pad and the pad to whole
    tiles, the tile gather (a copy of the stride-2 window view), the three
    instructions of :func:`_winograd_tiles`, and the reassembly copy."""
    x, u, padding = node.args[:3]
    xv, uv = em.val(x), em.val(u)
    b, H, W, cin = xv.shape
    cout = uv.shape[-1]
    dt = xv.dtype
    src = em.names[x]
    if padding == "SAME":
        H, W = H + 2, W + 2
        src = em.inst(f"{node.name}.pad", _shape_type(dt, (b, H, W, cin)), "pad", [src])
    oh, ow = H - 2, W - 2
    th, tw = (oh + 1) // 2, (ow + 1) // 2
    src = em.inst(f"{node.name}.padr", _shape_type(dt, (b, 2 * th + 2, 2 * tw + 2, cin)),
                  "pad", [src])
    win = em.inst(f"{node.name}.win", _shape_type(dt, (b, th, tw, cin, 4, 4)),
                  "bitcast", [src])
    tiles = em.inst(f"{node.name}.tiles", _shape_type(dt, (b, th, tw, 4, 4, cin)),
                    "copy", [win])
    y = _winograd_tiles(em, f"{node.name}.t", tiles, em.names[u], (b, th, tw, cin),
                        cout, _shape_type(dt, (b, th, tw, 2, 2, cout)))
    y = em.inst(f"{node.name}.y", _shape_type(dt, (b, 2 * th, 2 * tw, cout)), "copy", [y])
    em.names[node] = em.inst(node.name, hlo_type(em.val(node)), "bitcast", [y])


_GROUPED = "lhs_batch_dims={0,1}, rhs_batch_dims={0,1}"


def _grouped_dot(em: _Emitter, name: str, dtype: torch.dtype, shape, lhs: str, rhs: str,
                 lc: int, rc: int) -> str:
    """A product batched over (b, kv): attention's products under GQA."""
    return em.inst(name, _shape_type(dtype, shape), "dot", [lhs, rhs],
                   f"{_GROUPED}, lhs_contracting_dims={{{lc}}}, "
                   f"rhs_contracting_dims={{{rc}}}")


def _flash_products(em: _Emitter, node: torch.fx.Node, out_dtype: torch.dtype):
    """q.k^T batched over (b, kv), the softmax's exp, p.v: the FLOPs of the
    reference's two grouped ``sdpa`` einsums (the full s x t score matrix:
    the reference computes the masked half too).

    Under GQA q's h = kv * g heads are viewed as (b, kv, g * s, d), so both
    products batch over the kv heads that k and v really have.  Returns the
    names of the probabilities and of the grouped output."""
    q, k, v = node.args[:3]
    qv, kv_ = em.val(q), em.val(k)
    b, h, s, d = qv.shape
    kvh, t = kv_.shape[1], kv_.shape[2]
    gs = h // kvh * s
    qg = em.inst(f"{node.name}.q", _shape_type(qv.dtype, (b, kvh, gs, d)),
                 "bitcast", [em.names[q]])
    scores = _grouped_dot(em, f"{node.name}.s", torch.float32, (b, kvh, gs, t), qg,
                          em.names[k], 3, 3)
    p = em.inst(f"{node.name}.p", _shape_type(torch.float32, (b, kvh, gs, t)),
                "exponential", [scores])
    out = _grouped_dot(em, f"{node.name}.o", out_dtype, (b, kvh, gs, d), p, em.names[v],
                       3, 2)
    return p, out


def _flash_attention(em: _Emitter, node: torch.fx.Node) -> None:
    """The flash op as :func:`_flash_products` emits it."""
    _, out = _flash_products(em, node, em.val(node).dtype)
    em.names[node] = em.inst(node.name, hlo_type(em.val(node)), "bitcast", [out])


def _flash_attention_lse(em: _Emitter, node: torch.fx.Node) -> None:
    """The forward as :func:`_flash_attention` emits it, and the rows'
    log-sum-exp as a reduce of the probabilities: two parts."""
    out_v, lse_v = em.val(node)
    p, out = _flash_products(em, node, out_v.dtype)
    em.parts[node] = {
        0: em.inst(f"{node.name}.out", hlo_type(out_v), "bitcast", [out]),
        1: em.inst(f"{node.name}.lse", hlo_type(lse_v), "reduce", [p])}


def _flash_attention_bwd(em: _Emitter, node: torch.fx.Node) -> None:
    """The gradients of the flash op as the reference's vjp of
    ``attention_ref`` takes them, over the full s x t score matrix: the
    scores recomputed and exponentiated, dP = dO V^T, dS (an elementwise
    product), dV = P^T dO, dQ = dS K and dK = dS^T Q, batched over the kv
    heads as in :func:`_flash_products`.  Three parts."""
    q, k, v, _, _, dout = node.args[:6]
    dq_v, dk_v, dv_v = em.val(node)
    b, h, s, d = em.val(q).shape
    kvh, t = em.val(k).shape[1], em.val(k).shape[2]
    gs = h // kvh * s
    f32, n = torch.float32, node.name
    qg, gg = (em.inst(f"{n}.{name}", _shape_type(em.val(x).dtype, (b, kvh, gs, d)),
                      "bitcast", [em.names[x]]) for name, x in (("q", q), ("g", dout)))
    scores = _grouped_dot(em, f"{n}.s", f32, (b, kvh, gs, t), qg, em.names[k], 3, 3)
    p = em.inst(f"{n}.p", _shape_type(f32, (b, kvh, gs, t)), "exponential", [scores])
    dp = _grouped_dot(em, f"{n}.dp", f32, (b, kvh, gs, t), gg, em.names[v], 3, 3)
    ds = em.inst(f"{n}.ds", _shape_type(f32, (b, kvh, gs, t)), "multiply", [p, dp])
    dv = _grouped_dot(em, f"{n}.dv", dv_v.dtype, (b, kvh, t, d), p, gg, 2, 2)
    dq = _grouped_dot(em, f"{n}.dqg", dq_v.dtype, (b, kvh, gs, d), ds, em.names[k], 3, 2)
    dk = _grouped_dot(em, f"{n}.dk", dk_v.dtype, (b, kvh, t, d), ds, qg, 2, 2)
    em.parts[node] = {0: em.inst(f"{n}.dq", hlo_type(dq_v), "bitcast", [dq]), 1: dk, 2: dv}


def _plain(fn: Callable) -> Callable[[_Emitter, torch.fx.Node], None]:
    """A handler emitting a hand-kernel op as its plain version's aten graph
    (``fn``, traced on the node's fake operands), inlined under the node's
    name: the same products and elementwise work a capture of the plain
    code holds.  One part per output of a tuple."""
    def emit(em: _Emitter, node: torch.fx.Node) -> None:
        from torch.fx.experimental.proxy_tensor import make_fx
        args = [em.val(a) if isinstance(a, torch.fx.Node) else a for a in node.args]
        sub = make_fx(fn, tracing_mode="fake")(*args)
        inputs = iter(node.args)
        outer, em.gm = em.gm, sub
        try:
            for n in sub.graph.nodes:
                if n.op == "placeholder":
                    arg = next(inputs)
                    if isinstance(arg, torch.fx.Node):
                        em.names[n] = em.names[arg]
                elif n.op == "output":
                    out = n.args[0]
                    if isinstance(out, (tuple, list)):
                        em.parts[node] = {i: em.names[o] for i, o in enumerate(out)}
                    else:
                        em.names[node] = em.names[out]
                else:
                    n.name = f"{node.name}.{n.name}"
                    em._emit(n)
        finally:
            em.gm = outer
    return emit


def _group_ranks(group: Any) -> List[int]:
    """The global ranks of a process group, or of the one named ``group``."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    if isinstance(group, str):
        group = _resolve_process_group(group)
    return dist.get_process_group_ranks(group)


def _collective(opcode: str, group_arg: int, attrs: str = ""):
    """A handler emitting a functional collective over the group named by
    its argument ``group_arg`` as ``opcode`` with that group's ranks."""
    def emit(em: _Emitter, node: torch.fx.Node) -> None:
        ranks = ",".join(str(r) for r in _group_ranks(node.args[group_arg]))
        extra = f"replica_groups={{{{{ranks}}}}}" + (f", {attrs}" if attrs else "")
        em.names[node] = em.inst(node.name, hlo_type(em.val(node)), opcode,
                                 [em.names[node.args[0]]], extra)
    return emit


def _wait(em: _Emitter, node: torch.fx.Node) -> None:
    """Waiting on a collective emits nothing: the result is its input's."""
    em.names[node] = em.names[node.args[0]]


def _ring_permute(em: _Emitter, node: torch.fx.Node) -> None:
    x, group_name, shift = node.args[:3]
    ranks = _group_ranks(group_name)
    n = len(ranks)
    pairs = ",".join(f"{{{ranks[i]},{ranks[(i + shift) % n]}}}" for i in range(n))
    em.names[node] = em.inst(node.name, hlo_type(em.val(node)), "collective-permute",
                             [em.names[x]], f"source_target_pairs={{{pairs}}}")


def _index_copy(em: _Emitter, node: torch.fx.Node) -> None:
    """``cache.index_copy_(dim, row, new)``, the decode step's write of one
    position, as the reference's ``dynamic-update-slice(cache, new, row)``:
    the engine prices the update's bytes, not the cache's."""
    cache, _, row, new = node.args[:4]
    em.names[node] = em.inst(node.name, hlo_type(em.val(node)), "dynamic-update-slice",
                             [em.names[cache], em.names[new], em.names[row]])


def _to_copy(em: _Emitter, node: torch.fx.Node) -> None:
    src = em.val(node.args[0])
    opcode = "convert" if src.dtype != em.val(node).dtype else "copy"
    em.names[node] = em.inst(node.name, hlo_type(em.val(node)), opcode,
                             em.tensor_operands(node))


_SPECIAL: Dict[Any, Callable[[_Emitter, torch.fx.Node], None]] = {
    _aten.mm.default: _dot,
    _aten.addmm.default: _addmm,
    _aten.bmm.default: _bmm,
    _aten.convolution.default: _convolution,
    _aten.convolution_backward.default: _convolution_backward,
    _aten._to_copy.default: _to_copy,
    _aten.index_copy_.default: _index_copy,
    _aten.index_copy.default: _index_copy,
}


def _register_kernel_ops() -> None:
    """The hand-kernel ops are registered when their modules import."""
    import repro_torch.kernels.flash_attention.ops  # noqa: F401
    import repro_torch.kernels.ssd_scan.ops  # noqa: F401
    import repro_torch.kernels.ssm_mixer.ops  # noqa: F401
    import repro_torch.kernels.tiled_matmul.ops  # noqa: F401
    import repro_torch.kernels.winograd.ops  # noqa: F401
    _SPECIAL[torch.ops.repro_torch.tiled_matmul.default] = _dot
    _SPECIAL[torch.ops.repro_torch.winograd_tiles.default] = _winograd
    _SPECIAL[torch.ops.repro_torch.conv3x3_winograd.default] = _conv3x3_winograd
    _SPECIAL[torch.ops.repro_torch.flash_attention.default] = _flash_attention
    _SPECIAL[torch.ops.repro_torch.flash_attention_lse.default] = _flash_attention_lse
    _SPECIAL[torch.ops.repro_torch.flash_attention_bwd.default] = _flash_attention_bwd
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.kernels.ssm_mixer.ref import conv_in_ref, gated_norm_ref
    _SPECIAL[torch.ops.repro_torch.ssd_scan.default] = _plain(ssd_scan_ref)
    _SPECIAL[torch.ops.repro_torch.ssm_conv_in.default] = _plain(conv_in_ref)
    _SPECIAL[torch.ops.repro_torch.ssm_gated_norm.default] = _plain(gated_norm_ref)
    import repro_torch.distributed.pipeline  # noqa: F401  (the ring permute op)
    _SPECIAL[torch.ops.repro_torch.ring_permute.default] = _ring_permute
    c10d = torch.ops._c10d_functional
    _SPECIAL[c10d.all_gather_into_tensor.default] = _collective("all-gather", 2,
                                                                "dimensions={0}")
    _SPECIAL[c10d.reduce_scatter_tensor.default] = _collective("reduce-scatter", 3,
                                                               "dimensions={0}")
    _SPECIAL[c10d.all_reduce.default] = _collective("all-reduce", 2)
    _SPECIAL[c10d.all_to_all_single.default] = _collective("all-to-all", 3)
    _SPECIAL[torch.ops._dtensor.shard_dim_alltoall.default] = _collective("all-to-all", 3)
    _SPECIAL[c10d.wait_tensor.default] = _wait


def emit_graph(gm: torch.fx.GraphModule) -> Tuple[str, Dict[str, Tuple[str, ...]]]:
    """HLO text of a traced aten graph (see the module docstring), and the
    names of the instructions each node was emitted as, by node name (none
    for a node that emits nothing, such as a ``getitem`` of a part)."""
    _register_kernel_ops()
    em = _Emitter(gm)
    out_node = None
    for node in gm.graph.nodes:
        if node.op == "output":
            out_node = node
        em.emit(node)
    if out_node is None:
        raise ValueError("traced graph has no output node")
    return em.finish(out_node), {k: tuple(v) for k, v in em.emitted.items()}


@dataclass
class Captured:
    """One captured workload: the aten graph, its HLO text and parsed IR.

    ``node_instructions`` maps each graph node's name to the names of the
    entry instructions it was emitted as, so a measurement taken per node
    (:func:`repro_torch.core.correlate.card_reference`) lands on the same
    instructions the engine simulates."""
    name: str
    graph: torch.fx.GraphModule
    hlo_text: str
    module: SimModule
    capture_seconds: float
    node_instructions: Dict[str, Tuple[str, ...]] = field(default_factory=dict)


def capture(fn: Callable, *example_args, name: str = "workload") -> Captured:
    """Trace ``fn`` on fake copies of ``example_args`` and parse it.

    The example arguments are only read for shapes, dtypes and devices;
    nothing runs on them.  They may be fake tensors already (as
    :func:`capture_bundle` makes them); the trace then runs in their mode.
    """
    from torch.fx.experimental.proxy_tensor import make_fx

    t0 = time.time()
    gm = make_fx(fn, tracing_mode="fake")(*example_args)
    text, emitted = emit_graph(gm)
    module = parse_hlo_module(text)
    return Captured(name=name, graph=gm, hlo_text=text, module=module,
                    capture_seconds=time.time() - t0, node_instructions=emitted)


def capture_bundle(bundle, name: str = "step", device=None) -> Captured:
    """Capture a :class:`repro_torch.runtime.steps.StepBundle`: its abstract
    (``meta``) inputs become fake tensors on ``device`` (default cuda), so
    no full-size state is ever allocated, and its step is traced whole —
    for a training step the forward, the backward with every recomputed
    layer, and the optimizer update."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_map_only

    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    with FakeTensorMode():
        args = tree_map_only(torch.Tensor, lambda t: torch.empty(
            t.shape, dtype=t.dtype, device=dev), bundle.abstract_inputs)
    return capture(bundle.fn, *args, name=name)
