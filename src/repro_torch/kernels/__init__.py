"""Hand-written Hopper kernels for the compute hot spots the paper studies.

Each kernel ships the reference package's three layers:
  kernel.py — the ctypes launcher of a CUDA kernel in ``repro_torch/csrc``
  ops.py    — the public wrapper: layout, ``torch.library`` op with its
              fake and autograd rules, and device dispatch
  ref.py    — the plain PyTorch version, used on the CPU and as the
              yardstick the card's kernel is held to

Kernels: tiled_matmul (block-configurable GEMM — the section V GEMM case
study), winograd (F(2x2,3x3) conv — the paper's headline cuDNN algorithm),
flash_attention (online-softmax attention forward — the LMs' prefill — and
its 16-bit backward, which the training step runs), ssd_scan (Mamba2's
chunked scan of a prefill, which the reference runs as ``lax.scan``),
ssm_mixer (the pointwise work of a Mamba2 prefill mixer on each side of
that scan: the causal conv, SiLU and dt; the skip, gate and grouped norm).

A new kernel is its package, its ``csrc/<name>.cu`` (which
``build.KERNELS`` lists by itself) and an emitter for its op in
``core/capture.py``.  Its ``kernel.py`` declares each C entry point as a
:class:`~repro_torch.kernels.dispatch.Entry` and calls it through
:func:`~repro_torch.kernels.dispatch.launch`, which binds, launches, checks
the error code and counts, also inside a captured CUDA graph; no other
module names it.
"""
from repro_torch.kernels.dispatch import use_kernel

__all__ = ["use_kernel"]
