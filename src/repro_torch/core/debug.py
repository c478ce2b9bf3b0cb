"""Differential functional-simulation debugger (paper §III-D, Figures 2-3).

The paper localizes functional bugs in three steps: failing cuDNN API call ->
failing kernel within it -> first incorrectly-executed instruction (by
instrumenting the PTX to log every register write and diffing sim vs GPU).

PyTorch adaptation — the "instruction with logged register writes" becomes
a node of the function's aten graph (``make_fx`` in real mode) with logged
outputs, and the oracle is the same node evaluated in float64 on the CPU:

  level 1  compare end outputs of two callables            (API-call level)
  level 2  walk the aten graph, interpret each node twice — in the test
           environment (the inputs' own device and dtypes, the hand kernels
           on the card) and in the oracle (float64 on the CPU, hand-kernel
           ops through their plain versions) — and flag the FIRST
           divergent node (kernel -> instruction level)
  level 3  a hand-kernel node that diverges is localized by walking the
           aten graph of its plain version the same way

The oracle computes every floating value in float64: floating inputs are
cast to it, a ``dtype=`` or ``device=`` argument of a floating dtype or of
another device becomes float64 or the CPU, and a hand-kernel op runs its
plain version's own aten graph under the same rules (so the plain version's
fp32 casts stay float64 too).  So a precision choice of the program (a cast
to bf16) diverges at the node that makes it.  Outputs are compared as the
reference does — the largest absolute error and that over the oracle's
largest magnitude — except that an integer output (pooling indices, an
argmax) is scored by the share of its elements that differ: a near-tie that
the two precisions break differently is one element in many, a wrong
operation is most of them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils._pytree import tree_leaves


@dataclass
class Divergence:
    path: Tuple[str, ...]            # hand-kernel nodes walked into
    eqn_index: int                   # the node's index among the graph's ops
    primitive: str                   # the node's operator
    max_abs_err: float
    max_rel_err: float
    out_shapes: List[Tuple]
    source: str = ""                 # the node's name in the graph
    out_dtypes: Tuple[str, ...] = ()

    def __str__(self):
        loc = " > ".join(self.path + (f"node[{self.eqn_index}] {self.primitive}",))
        return (f"first divergence at {loc}: max_abs={self.max_abs_err:.3e} "
                f"rel={self.max_rel_err:.3e} shapes={self.out_shapes} {self.source}")


def _as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.double().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


def _err(a, b, exact_ints: bool = True) -> Tuple[float, float]:
    """(max abs error, max abs error over max |b|) of ``a`` against the
    oracle's ``b``.  Integer outputs: infinite unless equal when
    ``exact_ints``, else the share of elements that differ (both numbers)."""
    try:
        an, bn = _as_np(a), _as_np(b)
        if an.shape != bn.shape:
            return float("inf"), float("inf")
        if not np.issubdtype(an.dtype, np.floating):
            if np.array_equal(an, bn):
                return 0.0, 0.0
            if exact_ints or not an.size:
                return float("inf"), float("inf")
            share = float(np.mean(an != bn))
            return share, share
        diff = np.abs(an - bn)
        amax = float(np.max(diff)) if diff.size else 0.0
        denom = float(np.max(np.abs(bn))) if bn.size else 1.0
        return amax, amax / max(denom, 1e-30)
    except Exception:
        return float("inf"), float("inf")


def _oracle_value(x: Any) -> Any:
    """The oracle's copy of a value: tensors on the CPU, floating ones in
    float64; a floating dtype becomes float64 and a device the CPU."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.double() if x.is_floating_point() else x
    if isinstance(x, torch.dtype):
        return torch.float64 if x.is_floating_point else x
    if isinstance(x, torch.device):
        return torch.device("cpu")
    if isinstance(x, dict):
        return {k: _oracle_value(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_oracle_value(v) for v in x)
    return x


def _plain_versions() -> Dict[Any, Callable]:
    """Each hand-kernel op and its plain version, called with the op's own
    positional arguments."""
    import repro_torch.kernels.flash_attention.ops  # noqa: F401  (registers the op)
    import repro_torch.kernels.tiled_matmul.ops  # noqa: F401
    import repro_torch.kernels.winograd.ops  # noqa: F401
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.tiled_matmul.ref import matmul_ref
    from repro_torch.kernels.winograd.ref import conv3x3_winograd_ref, winograd_tiles_ref
    rt = torch.ops.repro_torch
    return {
        rt.tiled_matmul.default: lambda a, b, *blocks: matmul_ref(a, b),
        rt.winograd_tiles.default: winograd_tiles_ref,
        rt.conv3x3_winograd.default: conv3x3_winograd_ref,
        rt.flash_attention.default: lambda q, k, v, causal, window, softcap: attention_ref(
            q, k, v, causal=causal, window=window, softcap=softcap),
    }


def _oracle_call(target, args, kwargs, plain: Dict[Any, Callable]):
    """``target`` in the oracle: float64 on the CPU, a hand-kernel op
    through its plain version's aten graph (the ops take no keywords)."""
    if target in plain:
        gm = make_fx(plain[target])(*args)
        return _run_oracle(gm, args, plain)
    return target(*args, **kwargs)


def _run_oracle(gm: torch.fx.GraphModule, args, plain):
    env: Dict[torch.fx.Node, Any] = {}
    flat = iter(tree_leaves(list(args)))
    out = None
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            env[node] = next(flat)
        elif node.op == "call_function":
            a = _oracle_value(torch.fx.map_arg(node.args, env.__getitem__))
            k = _oracle_value(torch.fx.map_arg(node.kwargs, env.__getitem__))
            env[node] = _oracle_call(node.target, a, k, plain)
        elif node.op == "get_attr":
            env[node] = _oracle_value(getattr(gm, node.target))
        elif node.op == "output":
            out = torch.fx.map_arg(node.args[0], env.__getitem__)
    return out


def first_divergence(fn: Callable, args: Sequence[Any], *,
                     oracle: Optional[Callable[[Any], Any]] = None,
                     rtol: float = 5e-2, atol: float = 1e-3,
                     max_depth: int = 3,
                     _path: Tuple[str, ...] = ()) -> Optional[Divergence]:
    """Find the first node of ``fn``'s aten graph whose test-env output
    diverges from the oracle-env output beyond (atol, rtol): both the
    absolute error and the error over the oracle's largest magnitude must
    exceed their bounds.

    ``args`` are real inputs, on the device the test runs on.  oracle:
    transforms the inputs for the reference evaluation (default: every
    floating tensor to float64 on the CPU — the rounding-aware compare the
    paper's FP16 FMA analysis calls for).
    """
    gm = make_fx(fn)(*args)
    return _walk(gm, tree_leaves(list(args)), oracle or _oracle_value, rtol=rtol,
                 atol=atol, depth=max_depth, path=_path)


def _walk(gm: torch.fx.GraphModule, flat_args: List[Any], oracle: Callable,
          *, rtol, atol, depth, path) -> Optional[Divergence]:
    plain = _plain_versions()
    last_use: Dict[torch.fx.Node, torch.fx.Node] = {}
    for node in gm.graph.nodes:
        for inp in node.all_input_nodes:
            last_use[inp] = node
    env_t: Dict[torch.fx.Node, Any] = {}    # test env: native device and dtypes
    env_o: Dict[torch.fx.Node, Any] = {}    # oracle env: float64 on the CPU
    it = iter(flat_args)
    index = -1
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            x = next(it)
            env_t[node], env_o[node] = x, oracle(x)
            continue
        if node.op == "get_attr":
            x = getattr(gm, node.target)
            env_t[node], env_o[node] = x, oracle(x)
            continue
        if node.op != "call_function":
            continue
        index += 1
        args_t = torch.fx.map_arg(node.args, env_t.__getitem__)
        kwargs_t = torch.fx.map_arg(node.kwargs, env_t.__getitem__)
        args_o = _oracle_value(torch.fx.map_arg(node.args, env_o.__getitem__))
        kwargs_o = _oracle_value(torch.fx.map_arg(node.kwargs, env_o.__getitem__))
        out_t = node.target(*args_t, **kwargs_t)
        try:
            out_o = _oracle_call(node.target, args_o, kwargs_o, plain)
        except Exception:
            out_o = _oracle_value(out_t)   # oracle can't run this op: skip comparison
        outs_t, outs_o = tree_leaves(out_t), tree_leaves(out_o)
        worst = (0.0, 0.0)
        for a, b in zip(outs_t, outs_o):
            ae, re_ = _err(a, b, exact_ints=False)
            if ae > worst[0]:
                worst = (ae, re_)
        if worst[0] > atol and worst[1] > rtol:
            tensors = [o for o in outs_t if isinstance(o, torch.Tensor)]
            div = Divergence(
                path=path, eqn_index=index, primitive=str(node.target),
                max_abs_err=worst[0], max_rel_err=worst[1],
                out_shapes=[tuple(o.shape) for o in tensors], source=node.name,
                out_dtypes=tuple(str(o.dtype).replace("torch.", "") for o in tensors))
            # level 3: a hand kernel's plain version, walked the same way
            if depth > 0 and node.target in plain:
                sub = make_fx(plain[node.target])(*args_t)
                inner = _walk(sub, tree_leaves(list(args_t)), oracle, rtol=rtol,
                              atol=atol, depth=depth - 1,
                              path=path + (f"node[{index}]:{node.target}",))
                if inner is not None:
                    return inner
            return div
        env_t[node], env_o[node] = out_t, out_o
        for inp in node.all_input_nodes:
            if last_use.get(inp) is node:
                env_t.pop(inp, None)
                env_o.pop(inp, None)
    return None


def compare_implementations(fn_a: Callable, fn_b: Callable, args: Sequence[Any],
                            rtol: float = 1e-3, atol: float = 1e-4
                            ) -> Tuple[bool, float]:
    """Level-1 check: two implementations of the same math (e.g. the conv
    algorithms of §V, or a hand kernel vs its plain version)."""
    out_a = tree_leaves(fn_a(*args))
    out_b = tree_leaves(fn_b(*args))
    worst = 0.0
    for a, b in zip(out_a, out_b):
        ae, _ = _err(a, b)
        worst = max(worst, ae)
    scale = max(float(np.max(np.abs(_as_np(out_b[0])))) if out_b else 1.0, 1e-30)
    ok = worst <= atol + rtol * scale
    return ok, worst
