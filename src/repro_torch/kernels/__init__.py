"""Hand-written Hopper kernels for the compute hot spots the paper studies.

Each kernel ships the reference package's three layers:
  kernel.py — the ctypes launcher of a CUDA kernel in ``repro_torch/csrc``
  ops.py    — the public wrapper: layout, ``torch.library`` op with its
              fake and autograd rules, and device dispatch
  ref.py    — the plain PyTorch version, used on the CPU and as the
              yardstick the card's kernel is held to

Kernels: tiled_matmul (block-configurable GEMM — the section V GEMM case
study), winograd (F(2x2,3x3) conv — the paper's headline cuDNN algorithm).
"""
from repro_torch.kernels.dispatch import use_kernel

__all__ = ["use_kernel"]
