from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS, flash_attention_fwd
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["HEAD_DIMS", "flash_attention_fwd", "flash_attention", "attention_ref"]
