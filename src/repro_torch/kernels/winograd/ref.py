"""Plain versions: the tile einsums of the Pallas kernel, and a direct conv."""
import numpy as np
import torch
import torch.nn.functional as F

BT = np.array([[1, 0, -1, 0], [0, 1, 1, 0], [0, -1, 1, 0], [0, 1, 0, -1]],
              np.float32)
AT = np.array([[1, 1, 1, 0], [0, 1, -1, -1]], np.float32)
G = np.array([[1, 0, 0], [0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0, 0, 1]],
             np.float32)


def winograd_tiles_ref(tiles: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """tiles (b, th, tw, 4, 4, cin), u (4, 4, cin, cout)
    -> (b, th, tw, 2, 2, cout), computed in fp32."""
    bt = torch.as_tensor(BT, device=tiles.device)
    at = torch.as_tensor(AT, device=tiles.device)
    d = tiles.float()
    v = torch.einsum("ij,btujkc,lk->btuilc", bt, d, bt)
    m = torch.einsum("btuilc,ilcf->btuilf", v, u.float())
    y = torch.einsum("ij,btujkf,lk->btuilf", at, m, at)
    return y.to(tiles.dtype)


def conv3x3_ref(x: torch.Tensor, w: torch.Tensor,
                padding: str = "SAME") -> torch.Tensor:
    """Direct conv. x: (b, h, w, cin) NHWC; w: (3, 3, cin, cout) HWIO."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 padding=padding.lower())
    return y.permute(0, 2, 3, 1)
