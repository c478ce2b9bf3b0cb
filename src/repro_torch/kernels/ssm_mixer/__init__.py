from repro_torch.kernels.ssm_mixer.kernel import ssm_conv_in, ssm_gated_norm
from repro_torch.kernels.ssm_mixer.ops import (mixer_route, scan_inputs, ssm_conv_in_op,
                                               ssm_gated_norm_op)
from repro_torch.kernels.ssm_mixer.ref import conv_in_ref, gated_norm_ref

__all__ = ["ssm_conv_in", "ssm_gated_norm", "mixer_route", "scan_inputs", "ssm_conv_in_op",
           "ssm_gated_norm_op", "conv_in_ref", "gated_norm_ref"]
