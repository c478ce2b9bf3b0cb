"""repro_torch — the PyTorch/CUDA port of :mod:`repro` for an NVIDIA H100.

The package mirrors ``repro``'s layout module for module, imports ``torch``
and numpy but never ``jax`` or ``repro``, and keeps the JAX package's
public layouts (NHWC activations, HWIO filters) so weights transfer 1:1.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
