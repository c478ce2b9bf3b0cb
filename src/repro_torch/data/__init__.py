from repro_torch.data.synthetic import (synthetic_lm_batches,
                                        synthetic_mnist_batches)

__all__ = ["synthetic_lm_batches", "synthetic_mnist_batches"]
