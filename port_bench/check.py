"""The comparisons that decide ``correct``: what the timed path produced,
against the plain reference (:mod:`reference`).

Serving: a sample of the finished requests, drawn from the seed, holds the
longest; the reference runs once over each prompt and its served tokens,
and the number compared is the widest gap by which a served token's logit
lies below the reference's best at its position (``logit_gap``), in units
of the spread (standard deviation) of the reference's logits there, so that
the limit does not hang on the scale the weights give the logits.

Training: the program's first steps, read as they happened (the losses the
loop read, the first step's clipped gradient from the first moment, the
parameters' change after the last step read before the next one), against
the reference's same steps from the same weights and batches:
``loss_gap`` (relative, the worst step), ``grad_gap`` and ``change_gap``
(by the worst leaf: the gap between the two norms over the reference's
norm of that leaf or of the median leaf, whichever is larger; a leaf whose
reference gradient is under a thousandth of the median leaf's moves by
round-off alone and is left out of the change).
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

import reference
import weights as W

#: a leaf whose reference gradient norm is under this share of the median
#: leaf's is left out of the change
STILL_LEAF = 1e-3


def sample_requests(lengths: Sequence[int], k: int, seed: int) -> List[int]:
    """``k`` request indices drawn from the seed, the longest among them."""
    rng = np.random.default_rng(seed)
    k = min(k, len(lengths))
    pick = [int(i) for i in rng.choice(len(lengths), size=k, replace=False)]
    longest = int(np.argmax(lengths))
    if longest not in pick:
        pick[0] = longest
    return sorted(pick)


def serve_inputs(prompts: torch.Tensor, served: np.ndarray) -> Tuple[torch.Tensor, List[int]]:
    """(r, s + n - 1) ids (each prompt, then its served tokens but the
    last, as the decode steps were fed them) and the n positions whose
    logits chose the served tokens."""
    s, n = prompts.shape[1], served.shape[1]
    fed = torch.as_tensor(served[:, :-1], dtype=prompts.dtype, device=prompts.device)
    return torch.cat([prompts, fed], dim=1), list(range(s - 1, s + n - 1))


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """(r, n): how far each chosen token's logit lies below the best, over
    the spread of the logits at its position."""
    tokens = tokens.to(ref_logits.device).long()
    below = ref_logits.max(-1).values - ref_logits.gather(-1, tokens[..., None])[..., 0]
    return below / ref_logits.std(-1)


def serve_reference(cfg: Mapping, seed: int, prompts: torch.Tensor, served: np.ndarray,
                    device, lowp=None) -> torch.Tensor:
    ids, positions = serve_inputs(prompts, served)
    return reference.serve_logits(cfg, seed, ids, prompts.shape[1], positions, device, lowp)


def leaf_gap(prog: Mapping[str, float], ref: Mapping[str, float],
             leaves: Sequence[str]) -> float:
    """The worst leaf's |prog - ref| over max(ref's leaf, ref's median)."""
    med = statistics.median(ref[n] for n in leaves)
    gaps = [abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in leaves]
    return max(g if math.isfinite(g) else float("inf") for g in gaps)


def moving_leaves(ref_grad: Mapping[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g >= STILL_LEAF * med]


def train_numbers(prog: Mapping, ref: Mapping) -> Dict[str, float]:
    """``loss_gap``, ``grad_gap``, ``change_gap`` of the program's readings
    against the reference's (both: ``losses``, ``first_grad`` and
    ``change`` by leaf)."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]) or not all(
            math.isfinite(p) for p in prog["losses"]):
        loss = float("inf")
    names = sorted(ref["first_grad"])
    grad = leaf_gap(prog["first_grad"], ref["first_grad"], names)
    change = leaf_gap(prog["change"], ref["change"], moving_leaves(ref["first_grad"]))
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def program_change(cfg: Mapping, seed: int, master_leaf, device) -> Dict[str, float]:
    """Each leaf's change from the seed's weights: ``master_leaf(path,
    layer)`` gives the program's fp32 master of that leaf; the first
    weights are drawn again block by block."""
    out = {}
    for path, layer, shape, init in W.leaves(cfg):
        m = master_leaf(path, layer)
        sq = 0.0
        for i, r0, r1 in W.blocks(shape):
            w0 = W.draw_block(cfg, seed, path, layer, i, (r1 - r0,) + tuple(shape[1:]), init,
                              device)
            sq += _square_sum(m[r0:r1] - w0.float())
        out[W.leaf_name(path, layer)] = math.sqrt(sq)
    return out


def _square_sum(t: torch.Tensor) -> float:
    return float(t.float().square().sum(dtype=torch.float64))


def leaf_norms(cfg: Mapping, leaf, scale: float = 1.0) -> Dict[str, float]:
    """{leaf name: norm of ``leaf(path, layer)`` times ``scale``}, summed
    block by block (no whole copy of a large leaf)."""
    out = {}
    for path, layer, shape, _ in W.leaves(cfg):
        t = leaf(path, layer)
        sq = sum(_square_sum(t[r0:r1]) for _, r0, r1 in W.blocks(shape))
        out[W.leaf_name(path, layer)] = scale * math.sqrt(sq)
    return out
