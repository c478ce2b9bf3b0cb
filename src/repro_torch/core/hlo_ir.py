"""HLO-text -> simulator IR.

The capture layer of the paper adapted to TPU: where Lew et al. extract PTX
embedded in libcudnn.so and feed it to GPGPU-Sim's loader, we parse the
post-SPMD-partitioning HLO of a compiled XLA executable into :class:`SimOp`
dataflow graphs.  All shapes here are PER-DEVICE (the partitioner already
divided them), so per-op FLOPs/bytes are per-chip quantities.

Crucially this walker scales while-loop bodies by their trip count — XLA's own
``cost_analysis()`` does NOT (measured: scan-of-10-matmuls reports 1 matmul of
FLOPs), which would under-count every scanned-layer model by ~num_layers x.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8, "f8e4m3fn": 1, "f8e5m2": 1,
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8, "c64": 8, "c128": 16,
    "token": 0, "opaque": 0,
}

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute", "collective-broadcast", "ragged-all-to-all")

TRANSCENDENTALS = ("exponential", "log", "tanh", "rsqrt", "sqrt", "power",
                   "cosine", "sine", "logistic", "expm1", "log1p", "atan2",
                   "cbrt", "erf")

ELEMENTWISE = ("add", "subtract", "multiply", "divide", "maximum", "minimum",
               "and", "or", "xor", "not", "negate", "abs", "compare", "select",
               "clamp", "floor", "ceil", "round-nearest-afz", "sign",
               "convert", "remainder", "shift-left", "shift-right-logical",
               "shift-right-arithmetic", "is-finite", "round-nearest-even")


@dataclass
class Shape:
    dtype: str
    dims: Tuple[int, ...]

    @property
    def elems(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @property
    def bytes(self) -> int:
        return self.elems * DTYPE_BYTES.get(self.dtype, 4)


_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([\d,]*)\]")


def parse_shape(text: str) -> List[Shape]:
    """'f32[8,64]{1,0}' or '(s32[], f32[8,32]{1,0})' -> list of Shape."""
    out = []
    for m in _SHAPE_RE.finditer(text):
        dtype, dims = m.group(1), m.group(2)
        if dtype not in DTYPE_BYTES:
            continue
        dims_t = tuple(int(d) for d in dims.split(",") if d) if dims else ()
        out.append(Shape(dtype, dims_t))
    return out


@dataclass
class SimOp:
    name: str
    opcode: str
    outputs: List[Shape]
    operands: List[str]
    attrs: Dict[str, str] = field(default_factory=dict)
    raw: str = ""

    @property
    def out_bytes(self) -> int:
        return sum(s.bytes for s in self.outputs)

    @property
    def out_elems(self) -> int:
        return sum(s.elems for s in self.outputs)


@dataclass
class Computation:
    name: str
    ops: List[SimOp] = field(default_factory=list)
    by_name: Dict[str, SimOp] = field(default_factory=dict)
    root: Optional[str] = None

    def add(self, op: SimOp, is_root: bool):
        self.ops.append(op)
        self.by_name[op.name] = op
        if is_root:
            self.root = op.name

    # -- def-use structure (the scheduler's dependency graph) ---------------
    def deps(self, op: SimOp) -> List[SimOp]:
        """Producer ops of ``op``'s operands defined in this computation.

        Operand tokens that do not name an op here (cross-computation
        references, literals) are dropped — the caller decides what those
        mean (e.g. the engine treats a called computation's parameters as
        ready at the call site's dispatch time).
        """
        out = []
        for name in op.operands:
            p = self.by_name.get(name)
            if p is not None:
                out.append(p)
        return out

    def def_use_edges(self) -> Dict[str, List[str]]:
        """producer name -> consumer names, in program order.

        The forward view of :meth:`deps`; exposed so analyses (and tests)
        can reason about the dataflow graph without re-deriving it from
        operand lists.
        """
        uses: Dict[str, List[str]] = {op.name: [] for op in self.ops}
        for op in self.ops:
            for p in self.deps(op):
                uses[p.name].append(op.name)
        return uses

    def last_use(self) -> Dict[str, int]:
        """value name -> program index of its last consumer here.

        The live-range endpoint view of :meth:`def_use_edges` — a buffer
        defined at index *i* and last consumed at index *j* is live over
        ``[i, j]``.  Values absent from the map are never consumed in this
        computation (the allocator keeps them until the invocation closes).
        """
        lu: Dict[str, int] = {}
        for i, op in enumerate(self.ops):
            for operand in op.operands:
                lu[operand] = i
        return lu


# instruction line: [ROOT] %name = TYPE opcode(...operands...), attrs
_INST_RE = re.compile(
    r"^\s*(ROOT\s+)?%([\w\.\-]+)\s*=\s*(\(.*?\)|[a-z0-9]+\[[\d,]*\](?:\{[\d,]*\})?"
    r"(?:\s*)?)\s*([\w\-]+)\((.*)$")
_COMP_RE = re.compile(r"^(ENTRY\s+)?%?([\w\.\-]+)\s*\((.*?)\)\s*->\s*(.+?)\s*\{\s*$")
_OPERAND_RE = re.compile(r"%([\w\.\-]+)")
_CALLS_RE = re.compile(r"calls=%?([\w\.\-]+)")
_COND_RE = re.compile(r"condition=%?([\w\.\-]+)")
_BODY_RE = re.compile(r"body=%?([\w\.\-]+)")
_TO_APPLY_RE = re.compile(r"to_apply=%?([\w\.\-]+)")
_RG_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=\[")
_RG_LIST_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_CONST_INT_RE = re.compile(r"constant\((\d+)\)")
_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")
_LHS_BATCH_RE = re.compile(r"lhs_batch_dims=\{([\d,]*)\}")
_SOURCE_TARGET_RE = re.compile(r"source_target_pairs=\{")
_ST_PAIRS_RE = re.compile(r"source_target_pairs=\{((?:\{\d+,\d+\},?)+)\}")
_ST_PAIR_RE = re.compile(r"\{(\d+),(\d+)\}")


def _split_operands(argstr: str) -> Tuple[List[str], str]:
    """Split 'a, b, c), attr=1, ...' at the closing paren of the operand list."""
    depth = 1
    for i, ch in enumerate(argstr):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                return ([m.group(1) for m in _OPERAND_RE.finditer(argstr[:i])],
                        argstr[i + 1:])
    return [m.group(1) for m in _OPERAND_RE.finditer(argstr)], ""


class SimModule:
    def __init__(self):
        self.computations: Dict[str, Computation] = {}
        self.entry: Optional[str] = None
        # per-op cost memos, keyed by op identity (ops are parsed once and
        # never mutated, so every cost function below is pure in the op) —
        # the engine's recording walk and the cluster's re-simulations hit
        # the same ops thousands of times.  Callers treat the returned
        # dicts as read-only (they already did: one object was always
        # shared per call site via the engine's report cache).
        self._flops_memo: Dict[int, Dict[str, float]] = {}
        self._hbm_memo: Dict[int, int] = {}
        self._coll_memo: Dict[int, Optional[Dict[str, Any]]] = {}
        self._trip_memo: Dict[int, int] = {}

    # -- helpers --------------------------------------------------------------
    def comp(self, name: str) -> Computation:
        return self.computations[name]

    def op_shape(self, comp: Computation, operand: str) -> List[Shape]:
        op = comp.by_name.get(operand)
        return op.outputs if op else []

    def trip_count(self, while_op: SimOp) -> int:
        """Heuristic trip count: the largest integer constant in the while's
        condition computation (canonical scan bounds: i < N)."""
        got = self._trip_memo.get(id(while_op))
        if got is not None:
            return got
        best = 1
        m = _COND_RE.search(while_op.raw)
        if m and m.group(1) in self.computations:
            cond = self.computations[m.group(1)]
            for op in cond.ops:
                for c in _CONST_INT_RE.finditer(op.raw):
                    best = max(best, int(c.group(1)))
        self._trip_memo[id(while_op)] = best
        return best

    # -- per-op analytic cost --------------------------------------------------
    def op_flops(self, comp: Computation, op: SimOp) -> Dict[str, float]:
        """Returns {mxu: dot/conv FLOPs, vpu: elementwise, trans: transcendental}.

        Memoized per op (read-only result); fusion recursion memoizes the
        interior ops too.
        """
        got = self._flops_memo.get(id(op))
        if got is not None:
            return got
        out = self._op_flops(comp, op)
        self._flops_memo[id(op)] = out
        return out

    def _op_flops(self, comp: Computation, op: SimOp) -> Dict[str, float]:
        oc = op.opcode
        out = {"mxu": 0.0, "vpu": 0.0, "trans": 0.0}
        if oc == "dot":
            k = 1
            lhs_shapes = self.op_shape(comp, op.operands[0]) if op.operands else []
            cm = _CONTRACT_RE.search(op.raw)
            if lhs_shapes and cm:
                dims = [int(d) for d in cm.group(1).split(",") if d]
                for d in dims:
                    if d < len(lhs_shapes[0].dims):
                        k *= lhs_shapes[0].dims[d]
            out["mxu"] = 2.0 * op.out_elems * k
        elif oc == "convolution":
            # flops = 2 * out_elems * prod(kernel spatial) * cin/groups
            rhs_shapes = self.op_shape(comp, op.operands[1]) if len(op.operands) > 1 else []
            kernel = 1
            if rhs_shapes:
                # HWIO layout by default: all dims except last (O) contribute
                for d in rhs_shapes[0].dims[:-1]:
                    kernel *= d
            groups = 1
            g = re.search(r"feature_group_count=(\d+)", op.raw)
            if g:
                groups = int(g.group(1))
            out["mxu"] = 2.0 * op.out_elems * kernel / max(groups, 1)
        elif oc == "fusion":
            m = _CALLS_RE.search(op.raw)
            if m and m.group(1) in self.computations:
                inner = self.computations[m.group(1)]
                for iop in inner.ops:
                    sub = self.op_flops(inner, iop)
                    for key in out:
                        out[key] += sub[key]
        elif oc in ("reduce", "reduce-window"):
            in_shapes = self.op_shape(comp, op.operands[0]) if op.operands else []
            out["vpu"] = float(in_shapes[0].elems if in_shapes else op.out_elems)
        elif oc in TRANSCENDENTALS:
            out["trans"] = float(op.out_elems)
        elif oc in ELEMENTWISE or oc in ("map", "scatter", "gather", "sort",
                                         "dynamic-slice", "dynamic-update-slice",
                                         "select-and-scatter", "iota", "pad",
                                         "concatenate", "reverse", "cumsum"):
            mult = math.log2(max(op.out_elems, 2)) if oc == "sort" else 1.0
            out["vpu"] = float(op.out_elems) * mult
        return out

    def op_hbm_bytes(self, comp: Computation, op: SimOp) -> int:
        """HBM traffic model: operand reads + output writes.

        Fusions count only their boundary tensors (interiors live in
        VMEM/registers).  Slice-update ops (dynamic-update-slice et al.) touch
        only the updated region — XLA updates them in place, so counting the
        full carried buffer would inflate scan-carried gradients ~30x.

        Memoized per op.
        """
        got = self._hbm_memo.get(id(op))
        if got is not None:
            return got
        out = self._op_hbm_bytes(comp, op)
        self._hbm_memo[id(op)] = out
        return out

    def _op_hbm_bytes(self, comp: Computation, op: SimOp) -> int:
        if op.opcode in ("parameter", "constant", "tuple", "get-tuple-element",
                         "bitcast", "after-all"):
            return 0
        if op.opcode == "dynamic-update-slice":
            upd = self.op_shape(comp, op.operands[1]) if len(op.operands) > 1 else []
            upd_bytes = sum(s.bytes for s in upd)
            return 2 * upd_bytes                         # read-mod-write slice
        if op.opcode == "dynamic-slice":
            return 2 * op.out_bytes
        if op.opcode in ("gather", "scatter"):
            # indices + touched elements (~2x the smaller side)
            small = min(op.out_bytes,
                        sum(s.bytes for n in op.operands[:1]
                            for s in self.op_shape(comp, n)) or op.out_bytes)
            return op.out_bytes + small
        if op.opcode == "fusion":
            # in-place slice-update fusions: charge update-sized traffic
            m = _CALLS_RE.search(op.raw)
            if m and m.group(1) in self.computations:
                inner = self.computations[m.group(1)]
                root = inner.by_name.get(inner.root) if inner.root else None
                if root is not None and root.opcode == "dynamic-update-slice":
                    upd = inner.by_name.get(root.operands[1]) if len(root.operands) > 1 else None
                    upd_bytes = upd.out_bytes if upd is not None else op.out_bytes
                    extra = sum(s.bytes for n in op.operands
                                for s in self.op_shape(comp, n)
                                if s.bytes < op.out_bytes / 4)
                    return 2 * upd_bytes + extra
        total = op.out_bytes
        for name in op.operands:
            for s in self.op_shape(comp, name):
                total += s.bytes
        return total

    def collective_info(self, op: SimOp) -> Optional[Dict[str, Any]]:
        if op.opcode not in COLLECTIVE_OPS:
            return None
        key = id(op)
        if key in self._coll_memo:     # a cached result may be None
            return self._coll_memo[key]
        out = self._collective_info(op)
        self._coll_memo[key] = out
        return out

    def _collective_info(self, op: SimOp) -> Optional[Dict[str, Any]]:
        group = 1
        members: Optional[Tuple[int, ...]] = None
        m = _RG_IOTA_RE.search(op.raw)
        if m:
            group = int(m.group(2))
        else:
            m2 = _RG_LIST_RE.search(op.raw)
            if m2:
                # the FIRST replica group's device ids: which physical links
                # the collective lands on (repro_torch.topology).  Every group is
                # assumed congruent — true of SPMD-partitioned HLO.
                try:
                    members = tuple(int(d) for d in m2.group(1).split(","))
                except ValueError:
                    members = None
                group = len(m2.group(1).split(","))
        pairs: Optional[Tuple[Tuple[int, int], ...]] = None
        if op.opcode == "collective-permute":
            group = 2   # point-to-point per pair
            mp = _ST_PAIRS_RE.search(op.raw)
            if mp:
                # EVERY source->target pair: the fabric carries them all
                # concurrently, so the topology model must claim every
                # pair's links, not just the first's
                pairs = tuple((int(a), int(b)) for a, b in
                              _ST_PAIR_RE.findall(mp.group(1)))
                devices = sorted({d for p in pairs for d in p})
                members = tuple(devices)
                group = max(len(devices), 2)
        # payload: bytes that must traverse links (per device)
        payload = op.out_bytes
        if op.opcode == "all-gather":
            payload = op.out_bytes            # receives (g-1)/g of output
        elif op.opcode in ("all-reduce",):
            payload = op.out_bytes            # ring: 2(g-1)/g of size
        elif op.opcode == "reduce-scatter":
            payload = sum(s.bytes for s in
                          (op.outputs or []))  # input traverses once
        return {"kind": op.opcode, "group": group, "payload": payload,
                "members": members, "pairs": pairs}

    # -- module-level summaries -------------------------------------------------
    def walk_entry(self):
        """Yield (op, comp, scale) over the entry computation, descending into
        while bodies with multiplied scale. Fusions are NOT descended (they are
        single scheduling units)."""
        def rec(comp_name: str, scale: float):
            comp = self.computations[comp_name]
            for op in comp.ops:
                if op.opcode == "while":
                    trip = self.trip_count(op)
                    b = _BODY_RE.search(op.raw)
                    if b and b.group(1) in self.computations:
                        yield from rec(b.group(1), scale * trip)
                    continue
                if op.opcode in ("call", "async-start"):
                    c = _TO_APPLY_RE.search(op.raw) or _CALLS_RE.search(op.raw)
                    if c and c.group(1) in self.computations:
                        yield from rec(c.group(1), scale)
                        continue
                if op.opcode == "conditional":
                    # charge the most expensive branch
                    yield op, comp, scale
                    continue
                yield op, comp, scale
        if self.entry:
            yield from rec(self.entry, 1.0)

    def totals(self) -> Dict[str, float]:
        t = {"mxu_flops": 0.0, "vpu_flops": 0.0, "trans_flops": 0.0,
             "hbm_bytes": 0.0, "collective_bytes": 0.0, "ops": 0.0}
        for op, comp, scale in self.walk_entry():
            f = self.op_flops(comp, op)
            t["mxu_flops"] += scale * f["mxu"]
            t["vpu_flops"] += scale * f["vpu"]
            t["trans_flops"] += scale * f["trans"]
            t["hbm_bytes"] += scale * self.op_hbm_bytes(comp, op)
            ci = self.collective_info(op)
            if ci:
                t["collective_bytes"] += scale * ci["payload"]
            t["ops"] += scale
        return t

    def op_census(self) -> Dict[str, int]:
        census: Dict[str, int] = {}
        for op, _, scale in self.walk_entry():
            census[op.opcode] = census.get(op.opcode, 0) + int(scale)
        return census


def parse_hlo_module(text: str) -> SimModule:
    mod = SimModule()
    comp: Optional[Computation] = None
    is_entry = False
    for line in text.splitlines():
        stripped = line.strip()
        if not stripped:
            continue
        cm = _COMP_RE.match(line)
        if cm and ("%" in line.split("(")[0] or line.startswith("ENTRY")):
            comp = Computation(cm.group(2))
            is_entry = bool(cm.group(1))
            mod.computations[comp.name] = comp
            if is_entry:
                mod.entry = comp.name
            continue
        if stripped == "}":
            comp = None
            continue
        if comp is None:
            continue
        im = _INST_RE.match(line)
        if not im:
            continue
        is_root, name, type_str, opcode, rest = im.groups()
        operands, attr_str = _split_operands(rest)
        op = SimOp(name=name, opcode=opcode, outputs=parse_shape(type_str),
                   operands=operands, raw=stripped)
        comp.add(op, bool(is_root))
    return mod


def summarize_collectives(mod: SimModule) -> Dict[str, Any]:
    """Per-collective-kind byte census over the entry (trip-count scaled)."""
    summary: Dict[str, Any] = {"total_bytes": 0.0, "by_kind": {}, "count": 0}
    for op, comp, scale in mod.walk_entry():
        ci = mod.collective_info(op)
        if not ci:
            continue
        kind = ci["kind"]
        entry = summary["by_kind"].setdefault(
            kind, {"bytes": 0.0, "count": 0, "max_group": 0})
        entry["bytes"] += scale * ci["payload"]
        entry["count"] += int(scale)
        entry["max_group"] = max(entry["max_group"], ci["group"])
        summary["total_bytes"] += scale * ci["payload"]
        summary["count"] += int(scale)
    return summary
