"""Public wrapper: the ``repro_torch::tiled_matmul`` op and its dispatch.

The op is a ``torch.library.custom_op`` with a fake implementation (so a
captured step shows every launch as one node) and an autograd formula whose
backward computes dA = dY @ B^T and dB = A^T @ dY with the same kernel: the
reference kernel has no VJP, so the port adds no backward kernel of its own.
On CUDA tensors the op launches the kernel; on CPU tensors it runs
:func:`matmul_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.tiled_matmul.kernel import check_block, tiled_matmul
from repro_torch.kernels.tiled_matmul.ref import matmul_ref

DEFAULT_BLOCK = (64, 64, 64)


@torch.library.custom_op("repro_torch::tiled_matmul", mutates_args=())
def tiled_matmul_op(a: torch.Tensor, b: torch.Tensor, block_m: int,
                    block_n: int, block_k: int) -> torch.Tensor:
    if use_kernel(a, b):
        return tiled_matmul(a, b, block_m=block_m, block_n=block_n,
                            block_k=block_k)
    return matmul_ref(a, b)


@tiled_matmul_op.register_fake
def _(a, b, block_m, block_n, block_k):
    return a.new_empty((a.shape[0], b.shape[1]))


def _setup_context(ctx, inputs, output):
    a, b, block_m, block_n, block_k = inputs
    ctx.save_for_backward(a, b)
    ctx.blocks = (block_m, block_n, block_k)


def _backward(ctx, grad):
    a, b = ctx.saved_tensors
    da = db = None
    if ctx.needs_input_grad[0]:
        da = tiled_matmul_op(grad, b.t(), *ctx.blocks)
    if ctx.needs_input_grad[1]:
        db = tiled_matmul_op(a.t(), grad, *ctx.blocks)
    return da, db, None, None, None


tiled_matmul_op.register_autograd(_backward, setup_context=_setup_context)


def matmul(a: torch.Tensor, b: torch.Tensor, *, block_m: int = DEFAULT_BLOCK[0],
           block_n: int = DEFAULT_BLOCK[1],
           block_k: int = DEFAULT_BLOCK[2]) -> torch.Tensor:
    """(M, K) @ (K, N) through the hand kernel on CUDA, the plain version on
    the CPU.  The default 64x64x64 block (the reference's is 128 for the
    TPU's 128x128 MXU) gives the skinny LeNet products more blocks."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul needs (M,K) @ (K,N); got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    check_block(block_m, block_n, block_k)
    return tiled_matmul_op(a, b, block_m, block_n, block_k)
