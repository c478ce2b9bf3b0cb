from repro_torch.kernels.winograd.kernel import (winograd_conv, winograd_plan,
                                                 winograd_tiles)
from repro_torch.kernels.winograd.ops import conv3x3_winograd, filter_transform
from repro_torch.kernels.winograd.ref import (conv3x3_ref, conv3x3_winograd_ref,
                                              winograd_tiles_ref)

__all__ = ["winograd_conv", "winograd_plan", "winograd_tiles", "conv3x3_winograd",
           "filter_transform", "conv3x3_ref", "conv3x3_winograd_ref",
           "winograd_tiles_ref"]
