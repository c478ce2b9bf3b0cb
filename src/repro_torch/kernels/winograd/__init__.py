from repro_torch.kernels.winograd.kernel import winograd_tiles
from repro_torch.kernels.winograd.ops import conv3x3_winograd
from repro_torch.kernels.winograd.ref import conv3x3_ref, winograd_tiles_ref

__all__ = ["winograd_tiles", "conv3x3_winograd", "conv3x3_ref",
           "winograd_tiles_ref"]
