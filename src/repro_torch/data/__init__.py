from repro_torch.data.pipeline import DataPipeline, shard_batch
from repro_torch.data.synthetic import (synthetic_lm_batches,
                                        synthetic_mnist_batches)

__all__ = ["DataPipeline", "shard_batch", "synthetic_lm_batches",
           "synthetic_mnist_batches"]
