"""The port's counterpart of ``jax.jit``: a step captured into a CUDA graph
and replayed.

``jit(fn, donate=())`` returns a compiled step.  On CUDA tensors it
captures ``fn`` into a ``torch.cuda.CUDAGraph`` once per input signature —
the tree structure, each tensor's shape, dtype and device, and the values
of the other leaves: the key ``jax.jit`` retraces on — and replays it.
The graph holds every kernel the eager step launches, in the same order,
so a replay computes what the eager step computes, bit for bit.

* The first call for a signature runs ``fn`` on a side stream first (the
  warm-up: the hand kernels are built and their one-time host set-up —
  ``cudaFuncSetAttribute``, the TMA encoder's entry point — runs outside
  the capture), on copies of the donated arguments, so that the warm-up
  changes nothing the caller holds; then captures, then replays.
* The graph reads its inputs where the first call's tensors lie, and keeps
  those tensors alive, at those addresses, as long as it lives: the flash
  kernel encodes its TMA descriptors on the host at every launch, so the
  captured launch holds the q/k/v addresses of the capture (a prefill's
  q/k/v are intermediates of the graph's own pool, which stay put).  A
  later call's tensor that lies elsewhere is copied there, over the first
  call's values; one that *is* the captured tensor (the weights, a cache
  handed back) is read in place.  So a caller passes a varying input (a
  batch) in a tensor it may lose, and keeps what it reuses at one address.
* ``donate`` names the arguments the caller gives up, as
  ``donate_argnums`` does: the output of a donated argument's structure
  (the whole output, or one of its top-level elements: the new state, the
  advanced cache) is written over that argument at the end of the graph,
  where it is not already there (an update in place), so the output *is*
  the input's storage and comes back as the next call's input with no
  copy.
* The outputs are the graph's own tensors: the next replay of the same
  graph overwrites them.

On CPU tensors the compiled step is ``fn`` itself: the port's CPU mode, as
the kernels' plain versions are, not a fallback.  A failed capture raises.
Under :func:`disable_jit` every compiled step runs ``fn`` eagerly; it is
the only way to run a compiled step eagerly on the card.

A replay runs no Python, so the kernel wrappers' ``launches`` counters
would not move: a graph keeps the launches its capture recorded (taken
back off the counters: a capture launches nothing) and adds them to the
counters at every replay.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

#: eager calls of ``fn`` before a capture
WARMUP_CALLS = 2

_EAGER = contextvars.ContextVar("repro_torch_disable_jit", default=False)


@contextlib.contextmanager
def disable_jit() -> Iterator[None]:
    """Run every compiled step as its plain function inside the block (the
    counterpart of ``jax.disable_jit``)."""
    token = _EAGER.set(True)
    try:
        yield
    finally:
        _EAGER.reset(token)


class GraphPool:
    """One memory pool for the graphs of several compiled steps that run one
    after another, never at once (a server's prefill and decode): their
    intermediates share the pool where two pools would each keep theirs.
    A graph's outputs stay valid until another graph of the pool replays."""

    def __init__(self) -> None:
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


def _counted() -> Tuple[Callable, ...]:
    """The kernel wrappers whose ``launches`` attribute counts launches."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.tiled_matmul.kernel import tiled_matmul
    from repro_torch.kernels.winograd.kernel import winograd_conv, winograd_tiles
    return flash_attention_fwd, tiled_matmul, winograd_conv, winograd_tiles


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True iff ``a`` and ``b`` are the same view of the same memory."""
    return (a is b or (a.data_ptr() == b.data_ptr() and a.dtype == b.dtype
                       and a.shape == b.shape and a.stride() == b.stride()))


def _signature(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    return (type(x), x)


@dataclass
class Graph:
    """One captured signature: the graph, the tensors it reads (``None``
    where the input leaf is no tensor), its outputs, and the kernel
    launches its capture recorded, by wrapper name."""
    graph: Any
    inputs: List[Optional[torch.Tensor]]
    out: Any
    launches: Dict[str, int]

    def replay(self) -> None:
        self.graph.replay()
        for f in _counted():
            f.launches += self.launches[f.__name__]


class Jitted:
    """A compiled step (see the module docstring); ``graphs`` maps each
    signature captured so far to its :class:`Graph`."""

    def __init__(self, fn: Callable, donate: Iterable[int] = (),
                 pool: Optional[GraphPool] = None):
        self.fn = fn
        self.donate = tuple(sorted(set(donate)))
        self.pool = pool
        self.graphs: Dict[Any, Graph] = {}
        self.last: Optional[Graph] = None

    def __call__(self, *args: Any) -> Any:
        leaves, spec = tree_flatten(args)
        devices = {x.device.type for x in leaves if isinstance(x, torch.Tensor)}
        if _EAGER.get() or "cuda" not in devices:
            return self.fn(*args)
        if devices != {"cuda"}:
            raise ValueError(f"a compiled step takes tensors all on cuda or all on "
                             f"the cpu; got {sorted(devices)}")
        key = (spec, tuple(_signature(x) for x in leaves))
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(args)
        else:
            with torch.no_grad():
                for mine, x in zip(g.inputs, leaves):
                    if mine is not None and not _same(mine, x):
                        mine.copy_(x)
        g.replay()
        self.last = g
        return g.out

    def _warm_args(self, args: Sequence[Any]) -> List[Any]:
        """``args`` with each donated argument's tensors copied."""
        out = list(args)
        for i in self.donate:
            leaves, spec = tree_flatten(args[i])
            out[i] = tree_unflatten([t.clone() if isinstance(t, torch.Tensor) else t
                                     for t in leaves], spec)
        return out

    def _capture(self, args: Sequence[Any]) -> Graph:
        leaves, _ = tree_flatten(args)
        dev = next(x.device for x in leaves if isinstance(x, torch.Tensor))
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                self.fn(*self._warm_args(args))
        torch.cuda.current_stream(dev).wait_stream(side)

        counters = _counted()
        before = [f.launches for f in counters]
        graph = torch.cuda.CUDAGraph()
        pool = None if self.pool is None else self.pool.handle()
        with torch.cuda.device(dev), torch.cuda.graph(graph, pool=pool):
            out = self._write_donated(args, self.fn(*args))
        launches = {}
        for f, n in zip(counters, before):
            launches[f.__name__] = f.launches - n
            f.launches = n
        return Graph(graph, [x if isinstance(x, torch.Tensor) else None for x in leaves],
                     out, launches)

    def _write_donated(self, args: Sequence[Any], out: Any) -> Any:
        """``out`` with the part of each donated argument's tree structure
        (the whole output, or one of its top-level elements) written over
        that argument, leaf by leaf, and its tensors in the part's place.  A
        leaf already in the argument's storage (an update in place) stays;
        a donated argument that no part matches is left alone."""
        parts = [out] + (list(out) if isinstance(out, (tuple, list)) else [])
        specs = [tree_flatten(p)[1] for p in parts]
        done: Dict[int, Any] = {}
        with torch.no_grad():
            for i in self.donate:
                given, spec = tree_flatten(args[i])
                j = next((j for j, s in enumerate(specs) if j not in done and s == spec),
                         None)
                if j is None:
                    continue
                merged = []
                for o, d in zip(tree_flatten(parts[j])[0], given):
                    if (isinstance(o, torch.Tensor) and isinstance(d, torch.Tensor)
                            and o.shape == d.shape and o.dtype == d.dtype
                            and not _same(o, d)):
                        d.copy_(o)
                        o = d
                    merged.append(o)
                done[j] = tree_unflatten(merged, spec)
        if 0 in done:
            return done[0]
        if not done:
            return out
        items = [done.get(j + 1, p) for j, p in enumerate(out)]
        return type(out)(*items) if hasattr(out, "_fields") else type(out)(items)


def jit(fn: Callable, donate: Iterable[int] = (), pool: Optional[GraphPool] = None
        ) -> Jitted:
    """``fn`` compiled: captured into a CUDA graph per input signature and
    replayed on CUDA tensors, ``fn`` itself on CPU tensors (see the module
    docstring).  ``donate``: the indices of the arguments the caller gives
    up; ``pool``: a :class:`GraphPool` shared with other compiled steps."""
    return Jitted(fn, donate, pool)
