from repro_torch.kernels.flash_attention.kernel import (BWD_HEAD_DIMS, HEAD_DIMS,
                                                        flash_attention_bwd,
                                                        flash_attention_fwd)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_lse_ref, attention_ref

__all__ = ["BWD_HEAD_DIMS", "HEAD_DIMS", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention", "attention_ref", "attention_lse_ref"]
