"""Public wrapper: the ``repro_torch::ssm_conv_in`` and
``repro_torch::ssm_gated_norm`` ops and the route to them.

Each is a ``torch.library.custom_op`` with a fake implementation, so that a
captured prefill shows each as one node a layer.  On CUDA tensors they
launch the kernels (``csrc/ssm_mixer.cu``); on CPU tensors they run the
plain versions (:mod:`~repro_torch.kernels.ssm_mixer.ref`).

Which the model's mixer takes is chosen from what its inputs show
(:func:`mixer_route`): the kernels where they are compiled for them and no
gradient is needed, else the model's plain code (CPU tensors, fp32, ``meta``
tensors, a training forward, a mesh's DTensors).  There is no fallback: a
call the route gives the kernels launches them or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.ssd_scan.kernel import padded
from repro_torch.kernels.ssm_mixer.kernel import (CONV_WIDTH, DTYPE_CODES, HEAD_DIM,
                                                  MAX_D_INNER, MAX_GROUPS, ssm_conv_in,
                                                  ssm_gated_norm)
from repro_torch.kernels.ssm_mixer.ref import conv_in_ref, gated_norm_ref


def mixer_route(zxbcdt: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                dt_bias: torch.Tensor, a_log: torch.Tensor, d_skip: torch.Tensor,
                norm: torch.Tensor, groups: int) -> str:
    """``"kernels"`` for plain CUDA tensors (not DTensors), the in_proj
    output zxbcdt (b, s, d + c + h) and the parameters in one of bfloat16
    and float16 (the model stores both in its dtype), at a shape the
    kernels are compiled for (heads of ``HEAD_DIM``, d = norm's width up to
    ``MAX_D_INNER`` in up to ``MAX_GROUPS`` groups of a multiple of 8
    channels, c a multiple of 8, a conv of width ``CONV_WIDTH``, a
    non-empty sequence) when no gradient is needed; ``"plain"``
    otherwise."""
    from torch.distributed.tensor import DTensor
    params = (conv_w, conv_b, dt_bias, a_log, d_skip, norm)
    tensors = (zxbcdt, *params)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    d_inner, heads = norm.shape[0], dt_bias.shape[0]
    width, ch = conv_w.shape
    if (not grad and not any(isinstance(t, DTensor) for t in tensors)
            and all(t.device.type == "cuda" for t in tensors)
            and zxbcdt.dtype in DTYPE_CODES and all(t.dtype == zxbcdt.dtype for t in params)
            and d_inner == HEAD_DIM * heads and d_inner <= MAX_D_INNER
            and 0 < groups <= MAX_GROUPS and d_inner % (8 * groups) == 0
            and ch % 8 == 0 and width == CONV_WIDTH and zxbcdt.dim() == 3
            and zxbcdt.shape[1] > 0 and zxbcdt.shape[2] == d_inner + ch + heads):
        return "kernels"
    return "plain"


@torch.library.custom_op("repro_torch::ssm_conv_in", mutates_args=())
def ssm_conv_in_op(zxbcdt: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                   dt_bias: torch.Tensor, a_log: torch.Tensor, d_inner: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """xbc (b, c, padded(s)), dA (b, h, s), xh (b, s, d_inner) and the
    conv's last raw inputs of the in_proj output zxbcdt (b, s, *)
    (:func:`~repro_torch.kernels.ssm_mixer.ref.conv_in_ref`)."""
    if use_kernel(zxbcdt, conv_w, conv_b, dt_bias, a_log):
        return ssm_conv_in(zxbcdt, conv_w, conv_b, dt_bias, a_log, d_inner)
    return conv_in_ref(zxbcdt, conv_w, conv_b, dt_bias, a_log, d_inner)


@ssm_conv_in_op.register_fake
def _(zxbcdt, conv_w, conv_b, dt_bias, a_log, d_inner):
    b, s, _ = zxbcdt.shape
    width, ch = conv_w.shape
    return (zxbcdt.new_empty((b, ch, padded(s))),
            zxbcdt.new_empty((b, dt_bias.shape[0], s), dtype=torch.float32),
            zxbcdt.new_empty((b, s, d_inner)),
            zxbcdt.new_empty((b, min(s, width - 1), ch)))


@torch.library.custom_op("repro_torch::ssm_gated_norm", mutates_args=())
def ssm_gated_norm_op(y: torch.Tensor, xh: torch.Tensor, zxbcdt: torch.Tensor,
                      d_skip: torch.Tensor, norm: torch.Tensor, groups: int, eps: float
                      ) -> torch.Tensor:
    """(y + D xh) silu(z), RMS-normed by group, (b, s, h p)
    (:func:`~repro_torch.kernels.ssm_mixer.ref.gated_norm_ref`)."""
    if use_kernel(y, xh, zxbcdt, d_skip, norm):
        return ssm_gated_norm(y.contiguous(), xh.contiguous(), zxbcdt, d_skip, norm, groups,
                              eps)
    return gated_norm_ref(y, xh, zxbcdt, d_skip, norm, groups, eps)


@ssm_gated_norm_op.register_fake
def _(y, xh, zxbcdt, d_skip, norm, groups, eps):
    return y.new_empty((*y.shape[:2], y.shape[2] * y.shape[3]))


def scan_inputs(xbc: torch.Tensor, dA: torch.Tensor, d_inner: int, groups: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The scan's xdt (b, s, h, 64), dA (b, s, h), B and C (b, s, g, n) as
    views of :func:`ssm_conv_in_op`'s xbc and dA: the positions at unit
    stride, which the scan kernel reads as they lie at any length."""
    s = dA.shape[2]
    rows = xbc[..., :s]
    gn = (xbc.shape[1] - d_inner) // 2
    x, B, C = rows[:, :d_inner], rows[:, d_inner:d_inner + gn], rows[:, d_inner + gn:]
    return (x.unflatten(1, (-1, HEAD_DIM)).permute(0, 3, 1, 2), dA.transpose(1, 2),
            B.unflatten(1, (groups, -1)).permute(0, 3, 1, 2),
            C.unflatten(1, (groups, -1)).permute(0, 3, 1, 2))
