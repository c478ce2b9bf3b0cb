"""The port's counterpart of ``jax.jit``: a step captured into a CUDA graph
and replayed.

``jit(fn, donate=())`` returns a compiled step.  On CUDA tensors it
captures ``fn`` into a ``torch.cuda.CUDAGraph`` once per input signature —
the tree structure, each tensor's shape, dtype and device, and the values
of the other leaves: the key ``jax.jit`` retraces on — and replays it.
The graph holds every kernel the eager step launches, in the same order,
so a replay computes what the eager step computes, bit for bit.

* The first call for a signature runs ``fn`` eagerly, on the caller's own
  arguments, and returns its result: it is a real step, and the warm-up
  the capture needs (the hand kernels are built and their one-time host
  set-up — ``cudaFuncSetAttribute``, the TMA encoder's entry point — runs,
  autograd and cuBLAS set themselves up).  Nothing is copied for it, so a
  step that donates a state of tens of GB holds one state, not two.  The
  second call captures (``torch.cuda.graph`` first frees the allocator's
  cached blocks, so the graph's pool does not sit beside the first call's
  cached activations), then replays.  Both run on one side stream of the
  device, the stream every capture of this module uses.
* A capture is ``thread_local``: another host thread may call the CUDA
  runtime meanwhile.  A thread that puts work on the device beside the
  steps (the data pipeline's prefetch) holds :data:`CAPTURE_LOCK` while it
  does, and a capture holds it throughout, so no such work interleaves
  with one.
* The graph reads its inputs where the capturing call's tensors lie, and
  keeps those tensors alive, at those addresses, as long as it lives: the
  flash kernel encodes its TMA descriptors on the host at every launch, so
  the captured launch holds the q/k/v addresses of the capture (a
  prefill's q/k/v are intermediates of the graph's own pool, which stay
  put).  A later call's tensor that lies elsewhere is copied there, over
  the capturing call's values; one that *is* the captured tensor (the
  weights, the state or a cache handed back) is read in place.  So a caller passes a varying input (a
  batch) in a tensor it may lose, and keeps what it reuses at one address.
* ``donate`` names the arguments the caller gives up, as
  ``donate_argnums`` does: the output of a donated argument's structure
  (the whole output, or one of its top-level elements: the new state, the
  advanced cache) is written over that argument at the end of the graph,
  where it is not already there (an update in place), so the output *is*
  the input's storage and comes back as the next call's input with no
  copy.
* From the second call on, the outputs are the graph's own tensors: the
  next replay of the same graph overwrites them.

On CPU tensors the compiled step is ``fn`` itself: the port's CPU mode, as
the kernels' plain versions are, not a fallback.  A failed capture raises.
Under :func:`disable_jit` every call of a compiled step runs ``fn``
eagerly; past a signature's first call it is the only way to run a
compiled step eagerly on the card.

A replay runs no Python, so the kernel wrappers' ``launches`` counters
would not move: a graph keeps the launches its capture recorded (taken
back off the counters: a capture launches nothing) and adds them to the
counters at every replay.

What a call does is traced (:mod:`repro_torch.obs`): the spans
``jit.dispatch`` (the flatten, the signature, the input checks and copies,
up to the launch) and ``jit.replay``, each with the step's name; the
registry's ``jit_captures_total``, always.  A capture writes the region
table of its graph (:func:`repro_torch.obs.regions.capture`), and launches
the marker and counting kernels once after it, so that they load in
set-up.  While a profiler records, a replay is bracketed by the markers
that find its kernels in the device trace, and followed by the counts of
the tensors its capture kept (:mod:`repro_torch.obs.routing`); with no
profiler it launches the graph alone.
"""
from __future__ import annotations

import contextlib
import contextvars
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _profiler
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.obs import regions, routing
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import TRACER

#: held by a capture, and by any host thread while it puts work on the
#: device beside the compiled steps
CAPTURE_LOCK = threading.Lock()

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


def _device(args: Sequence[Any]) -> torch.device:
    return next(x.device for x in tree_flatten(args)[0] if isinstance(x, torch.Tensor))


#: each device's capture stream, made at its first use
_STREAMS: Dict[torch.device, Any] = {}


def _capture_stream(dev: torch.device):
    """The one side stream of ``dev`` that every first call and capture
    runs on: graphs that share a :class:`GraphPool` reuse each other's
    freed blocks only when captured on one stream."""
    if dev not in _STREAMS:
        _STREAMS[dev] = torch.cuda.Stream(dev)
    return _STREAMS[dev]


@dataclass
class Graph:
    """One captured signature: the graph, the tensors it reads (``None``
    where the input leaf is no tensor), its outputs, the kernel launches
    its capture recorded, by wrapper name, the compiled step's name and the
    tensors its capture kept for the routing counts."""
    graph: Any
    inputs: List[Optional[torch.Tensor]]
    out: Any
    launches: Dict[str, int]
    step: str = "step"
    kept: List[Any] = field(default_factory=list)

    def replay(self) -> None:
        if _profiler._is_profiler_enabled:
            regions.mark_begin()
            self.graph.replay()
            regions.mark_end()
            if self.kept:
                routing.count(self.step, self.kept)
        else:
            self.graph.replay()
        for f in _counted():
            f.launches += self.launches[f.__name__]


class Jitted:
    """A compiled step (see the module docstring); ``graphs`` maps each
    signature captured so far to its :class:`Graph`, ``seen`` holds the
    signatures whose first (eager) call has run; ``name`` labels its
    spans, region tables and counts."""

    def __init__(self, fn: Callable, donate: Iterable[int] = (),
                 pool: Optional[GraphPool] = None, name: str = "step"):
        self.fn = fn
        self.name = name
        self.donate = tuple(sorted(set(donate)))
        self.pool = pool
        self.graphs: Dict[Any, Graph] = {}
        self.seen: set = set()
        self.last: Optional[Graph] = None

    def __call__(self, *args: Any) -> Any:
        g = key = None
        with TRACER.span("jit.dispatch", step=self.name):
            leaves, spec = tree_flatten(args)
            devices = {x.device.type for x in leaves if isinstance(x, torch.Tensor)}
            eager = _EAGER.get() or "cuda" not in devices
            if not eager:
                if devices != {"cuda"}:
                    raise ValueError(f"a compiled step takes tensors all on cuda or all "
                                     f"on the cpu; got {sorted(devices)}")
                key = (spec, tuple(_signature(x) for x in leaves))
                g = self.graphs.get(key)
                if g is not None:
                    with torch.no_grad():
                        for mine, x in zip(g.inputs, leaves):
                            if mine is not None and not _same(mine, x):
                                mine.copy_(x)
        if eager:
            with regions.step(self.name):
                return self.fn(*args)
        if g is None and key not in self.seen:
            out = self._first_call(args)
            self.seen.add(key)
            return out
        if g is None:
            REGISTRY.counter("jit_captures_total").inc()
            g = self.graphs[key] = self._capture(args)
        with TRACER.span("jit.replay", step=self.name):
            g.replay()
        self.last = g
        return g.out

    def _first_call(self, args: Sequence[Any]) -> Any:
        """``fn`` eagerly on ``args``, on the capture stream.  Its outputs
        are blocks of that stream, which only a later first call (after it
        waits for the caller's stream) or a capture (after the device
        synchronizes) reuses."""
        dev = _device(args)
        side = _capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), regions.step(self.name):
            out = self.fn(*args)
        torch.cuda.current_stream(dev).wait_stream(side)
        return out

    def _capture(self, args: Sequence[Any]) -> Graph:
        leaves, _ = tree_flatten(args)
        dev = _device(args)
        counters = _counted()
        before = [f.launches for f in counters]
        graph = torch.cuda.CUDAGraph()
        pool = None if self.pool is None else self.pool.handle()
        stream = _capture_stream(dev)
        with CAPTURE_LOCK, torch.cuda.device(dev), torch.cuda.graph(
                graph, pool=pool, stream=stream, capture_error_mode="thread_local"), \
                regions.capture(self.name, stream) as cap:
            out = self._write_donated(args, self.fn(*args))
            cap.finish()
        regions.warm()
        if cap.kept:
            routing.warm(cap.kept)
        launches = {}
        for f, n in zip(counters, before):
            launches[f.__name__] = f.launches - n
            f.launches = n
        return Graph(graph, [x if isinstance(x, torch.Tensor) else None for x in leaves],
                     out, launches, self.name, cap.kept)

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


def jit(fn: Callable, donate: Iterable[int] = (), pool: Optional[GraphPool] = None,
        name: str = "step") -> Jitted:
    """``fn`` compiled: captured into a CUDA graph per input signature and
    replayed on CUDA tensors, ``fn`` itself on CPU tensors (see the module
    docstring).  ``donate``: the indices of the arguments the caller gives
    up; ``pool``: a :class:`GraphPool` shared with other compiled steps;
    ``name``: the label of its spans, region tables and counts."""
    return Jitted(fn, donate, pool, name)
