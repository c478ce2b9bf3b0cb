"""The serving comparison of the published Zamba2 (:mod:`check`'s, request
for request: the same sample, the same ``logit_gap``) against its own plain
reference, :mod:`zamba2_reference`."""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from check import gaps, sample_requests, serve_inputs  # noqa: F401  (the loop's)
import zamba2_reference


def serve_reference(cfg: Mapping, seed: int, prompts: torch.Tensor, served: np.ndarray,
                    device, lowp=None) -> torch.Tensor:
    ids, positions = serve_inputs(prompts, served)
    return zamba2_reference.serve_logits(cfg, seed, ids, prompts.shape[1], positions, device,
                                         lowp)
