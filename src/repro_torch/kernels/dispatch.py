"""Backend dispatch: the hand kernel on CUDA, its plain version on the CPU.

The port's counterpart of ``repro.kernels.dispatch`` (which switches to the
Pallas kernels on a TPU).  The decision is the tensors' device and nothing
else: there is no environment switch that forces the plain version on the
card, and a CUDA tensor never silently falls back — the kernel launches or
the call raises.
"""
from __future__ import annotations

import torch


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
