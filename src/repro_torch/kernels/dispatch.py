"""Backend dispatch: the hand kernel on CUDA, its plain version on the CPU.

The port's counterpart of ``repro.kernels.dispatch`` (which switches to the
Pallas kernels on a TPU).  The decision is the tensors' device and nothing
else: there is no environment switch that forces the plain version on the
card, and a CUDA tensor never silently falls back — the kernel launches or
the call raises.

Every launcher calls its kernel through this module: an :class:`Entry`
declares a C entry point, and :func:`launch` calls it, raises on its error
code and counts the launch.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.obs import regions

#: the dtype codes every kernel's C entry point takes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True iff every tensor lies on CUDA, False iff every one lies on the CPU.

    Any other placement (mixed devices, ``meta``, another backend) raises.
    """
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError("kernel inputs must all lie on cuda or all on the cpu; "
                     f"got {sorted(kinds)}")


class Entry:
    """A C entry point of the library built from ``csrc/<lib>.cu``: its
    ``symbol`` and argument types, returning an ``int`` error code.  It is
    built, loaded and typed at its first call only (``fn`` holds the bound
    function from then on)."""
    def __init__(self, lib: str, symbol: str, argtypes: Sequence):
        self.lib, self.symbol, self.argtypes = lib, symbol, list(argtypes)
        self.fn: Optional[Callable[..., int]] = None

    def bind(self, lib: Optional[ctypes.CDLL] = None) -> Callable[..., int]:
        """The symbol of ``lib`` (default: the built library), typed."""
        fn = getattr(build.load(self.lib) if lib is None else lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        return fn

    def __call__(self, *args) -> int:
        if self.fn is None:
            self.fn = self.bind()
        return self.fn(*args)


def counted(launcher: Callable) -> Callable:
    """Give a public launcher its ``launches`` attribute: its successful
    launches since the last reset (the main path's proof of use), which
    :func:`launch` adds to and tests and readers reset by assignment."""
    launcher.launches = 0
    return launcher


def launch(entry: Entry, launcher: Callable, device: torch.device, *args,
           detail: Callable[[], str]) -> None:
    """Call ``entry(*args, stream)`` on ``device``'s current stream and count
    one launch of the public ``launcher``: in the capture of a compiled step
    in progress on that stream, which its graph's replays add
    (:class:`repro_torch.obs.regions.Capture`), else on ``launcher.launches``.
    A non-zero error code raises ``RuntimeError`` naming the launcher, the
    code and ``detail()`` (the call's shapes), and counts nothing.  The
    device is entered only when it is not the current one: the launch's
    host path stays short."""
    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return launch(entry, launcher, device, *args, detail=detail)
    rc = entry(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{launcher.__name__} launch failed with CUDA error {rc} "
                           f"at {detail()}")
    cap = regions.capturing()
    if cap is None:
        launcher.launches += 1
    else:
        cap.launches[launcher] += 1
