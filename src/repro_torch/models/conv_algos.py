"""The paper's section V case-study axis: cuDNN convolution algorithms
re-implemented as selectable PyTorch lowerings.

The port of ``repro.models.conv_algos``, with the same four algorithmically
distinct forward paths:

* ``gemm``      — explicit im2col + one big matmul (cuDNN GEMM); the product
                  runs through the hand ``tiled_matmul`` kernel
* ``implicit``  — ``F.conv2d`` (the library's native convolution, as the
                  reference leaves ``lax.conv_general_dilated`` to XLA)
* ``winograd``  — F(2x2, 3x3) transform-domain conv through the hand
                  ``winograd_tiles`` kernel (3x3 kernels; others fall back
                  to ``gemm``, as in the reference)
* ``fft``       — rfft2 pointwise-product conv via ``torch.fft`` (the
                  paper's fft2d_r2c kernels)

All take/return NHWC activations and HWIO filters, so weights transfer 1:1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.tiled_matmul.ops import matmul
from repro_torch.kernels.winograd.ops import conv3x3_winograd

ALGOS = ("gemm", "implicit", "winograd", "fft")


def _same_pad(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    ph, pw = kh // 2, kw // 2
    return F.pad(x, (0, 0, pw, kw - 1 - pw, ph, kh - 1 - ph))


def conv_implicit(x: torch.Tensor, w: torch.Tensor,
                  padding: str = "SAME") -> torch.Tensor:
    """x: (b, h, w, cin); w: (kh, kw, cin, cout)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 padding=padding.lower())
    return y.permute(0, 2, 3, 1)


def conv_gemm(x: torch.Tensor, w: torch.Tensor,
              padding: str = "SAME") -> torch.Tensor:
    """Explicit im2col: materialize patches, then a single GEMM."""
    kh, kw, cin, cout = w.shape
    if padding == "SAME":
        x = _same_pad(x, kh, kw)
    b, H, W, _ = x.shape
    oh, ow = H - kh + 1, W - kw + 1
    idx_h = (torch.arange(oh, device=x.device)[:, None]
             + torch.arange(kh, device=x.device)[None, :])      # (oh, kh)
    idx_w = (torch.arange(ow, device=x.device)[:, None]
             + torch.arange(kw, device=x.device)[None, :])      # (ow, kw)
    patches = x[:, idx_h][:, :, :, idx_w]                       # (b, oh, kh, ow, kw, cin)
    patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(b * oh * ow, kh * kw * cin)
    out = matmul(patches, w.reshape(kh * kw * cin, cout).to(x.dtype))
    return out.reshape(b, oh, ow, cout)


def conv_winograd(x: torch.Tensor, w: torch.Tensor,
                  padding: str = "SAME") -> torch.Tensor:
    """F(2x2, 3x3) Winograd. Requires kh == kw == 3, else falls back to gemm."""
    if tuple(w.shape[:2]) != (3, 3):
        return conv_gemm(x, w, padding)
    return conv3x3_winograd(x, w, padding)


def conv_fft(x: torch.Tensor, w: torch.Tensor,
             padding: str = "SAME") -> torch.Tensor:
    """FFT conv (the paper's fft2d_r2c/c2r kernel pair)."""
    kh, kw, cin, cout = w.shape
    if padding == "SAME":
        x = _same_pad(x, kh, kw)
    b, H, W, _ = x.shape
    xf = torch.fft.rfft2(x.float(), dim=(1, 2))                  # (b,H,Wf,cin)
    wflip = w.flip(0, 1).float()                                 # correlation
    wpad = F.pad(wflip, (0, 0, 0, 0, 0, W - kw, 0, H - kh))
    wf = torch.fft.rfft2(wpad, dim=(0, 1))                       # (H,Wf,cin,cout)
    yf = torch.einsum("bhwc,hwcf->bhwf", xf, wf)
    y = torch.fft.irfft2(yf, s=(H, W), dim=(1, 2))
    return y[:, kh - 1:, kw - 1:, :].to(x.dtype)


CONV_FNS = {"gemm": conv_gemm, "implicit": conv_implicit,
            "winograd": conv_winograd, "fft": conv_fft}


def conv2d(x: torch.Tensor, w: torch.Tensor, algo: str = "implicit",
           padding: str = "SAME") -> torch.Tensor:
    if algo not in CONV_FNS:
        raise ValueError(f"unknown conv algo {algo!r}; options {ALGOS}")
    return CONV_FNS[algo](x, w, padding)
