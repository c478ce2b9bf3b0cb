"""Plain versions: the tile einsums of the Pallas kernel, the unfused
Winograd conv around them, and a direct conv.  The transform matrices are
device tensors built once per (device, dtype) (:func:`transform`)."""
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import _get_current_dispatch_mode

BT = np.array([[1, 0, -1, 0], [0, 1, 1, 0], [0, -1, 1, 0], [0, 1, 0, -1]],
              np.float32)
AT = np.array([[1, 1, 1, 0], [0, 1, -1, -1]], np.float32)
G = np.array([[1, 0, 0], [0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0, 0, 1]],
             np.float32)
_MATRICES = {"BT": BT, "AT": AT, "G": G}
_CACHE: Dict[Tuple[str, torch.device, torch.dtype], torch.Tensor] = {}


def transform(name: str, device: torch.device,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The matrix ``BT``, ``AT`` or ``G`` as a tensor on ``device``, made by
    the first call and kept: later calls copy nothing to the device.  Under
    a dispatch mode (a capture's tracing) it is made anew, as a constant of
    the traced graph, and not kept."""
    if _get_current_dispatch_mode() is not None:
        return torch.as_tensor(_MATRICES[name], dtype=dtype, device=device)
    key = (name, torch.device(device), dtype)
    mat = _CACHE.get(key)
    if mat is None:
        mat = _CACHE[key] = torch.as_tensor(_MATRICES[name], dtype=dtype, device=device)
    return mat


def winograd_tiles_ref(tiles: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """tiles (b, th, tw, 4, 4, cin), u (4, 4, cin, cout)
    -> (b, th, tw, 2, 2, cout), computed in fp32."""
    bt = transform("BT", tiles.device)
    at = transform("AT", tiles.device)
    d = tiles.float()
    v = torch.einsum("ij,btujkc,lk->btuilc", bt, d, bt)
    m = torch.einsum("btuilc,ilcf->btuilf", v, u.float())
    y = torch.einsum("ij,btujkf,lk->btuilf", at, m, at)
    return y.to(tiles.dtype)


def conv3x3_winograd_ref(x: torch.Tensor, u: torch.Tensor,
                         padding: str = "SAME") -> torch.Tensor:
    """x (b, H, W, cin) NHWC, u = G w G^T (4, 4, cin, cout) -> (b, oh, ow,
    cout): the reference wrapper's program, unfused — pad, extract the
    overlapping 4x4 tiles at stride 2, :func:`winograd_tiles_ref`, and
    reassemble the 2x2 output tiles."""
    b, H, W, cin = x.shape
    cout = u.shape[-1]
    if padding == "SAME":
        x = F.pad(x, (0, 0, 1, 1, 1, 1))
        H, W = H + 2, W + 2
    oh, ow = H - 2, W - 2
    th, tw = (oh + 1) // 2, (ow + 1) // 2
    x = F.pad(x, (0, 0, 0, 2 * tw + 2 - W, 0, 2 * th + 2 - H))
    # overlapping 4x4 windows at stride 2: a view, then one copy
    tiles = x.unfold(1, 4, 2).unfold(2, 4, 2)             # (b, th, tw, cin, 4, 4)
    tiles = tiles.permute(0, 1, 2, 4, 5, 3).contiguous()  # (b, th, tw, 4, 4, cin)
    y = winograd_tiles_ref(tiles, u)
    out = y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * th, 2 * tw, cout)
    return out[:, :oh, :ow]


def conv3x3_ref(x: torch.Tensor, w: torch.Tensor,
                padding: str = "SAME") -> torch.Tensor:
    """Direct conv. x: (b, h, w, cin) NHWC; w: (3, 3, cin, cout) HWIO."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 padding=padding.lower())
    return y.permute(0, 2, 3, 1)
