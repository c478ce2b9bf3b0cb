from repro_torch.kernels.tiled_matmul.kernel import BLOCK_CONFIGS, tiled_matmul
from repro_torch.kernels.tiled_matmul.ops import matmul
from repro_torch.kernels.tiled_matmul.ref import matmul_ref

__all__ = ["BLOCK_CONFIGS", "tiled_matmul", "matmul", "matmul_ref"]
