"""Seeded weights of the published Zamba2 in the port's ``zamba2`` tree,
made by the benchmark, as :mod:`weights` makes the decoder LMs'.

The tree: ``embed`` (vocab, d), ``ln_f``; ``blocks`` stacked on the shared
blocks (``ln1`` over 2d, ``attn`` with ``wq``, ``wk``, ``wv`` (2d, heads x
224) and ``wo``, ``ln2``, ``mlp`` with ``w_gate_up`` (d, 2 x 14,336) and
``w_down``); ``points`` stacked on the 13 application points
(``adapter_a`` (d, 128), ``adapter_b`` (128, 2 x 14,336), ``linear`` (d,
d)); ``layers`` stacked on the 81 Mamba2 layers (``ln``, ``mixer`` with
``in_proj`` (d, z | x B C | dt), ``conv_w`` (4, channels), ``conv_b``,
``dt_bias``, ``a_log``, ``d_skip``, ``norm``, ``out_proj``).  Matrices are
laid out (in, out).  A norm's weight is stored as ``gamma`` in a ``(1 +
gamma)`` scale.  The head is the embedding's transpose.

Every matrix (the conv's taps too) is drawn from N(0, ``initializer_range``),
biases and norm gammas are zeros, and the Mamba2 layers' own parameters are
drawn as the published initialisation draws them: ``a_log`` = log(1..heads),
``d_skip`` ones, and ``dt_bias`` the inverse softplus of a dt drawn
log-uniform in [``time_step_min``, ``time_step_max``] and floored at
``time_step_floor``.  A leaf is drawn in :func:`weights.blocks` of its
leading rows, each from a generator of its own seeded from (seed, leaf,
stack index, block), so that any block can be drawn again alone.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Tuple

import torch

import weights as W

#: the stacks of the tree, in order
STACKS = ("blocks", "points", "layers")


def _widths(cfg: Mapping) -> Tuple[int, int, int, int, int]:
    """(d, heads x head dim of attention, d_inner, Mamba2 heads, groups x state)."""
    d = cfg["hidden_size"]
    d_inner = cfg["mamba_expand"] * d
    return (d, cfg["num_attention_heads"] * cfg["attention_head_dim"], d_inner,
            cfg["n_mamba_heads"], cfg["mamba_ngroups"] * cfg["mamba_d_state"])


def stack_shapes(cfg: Mapping) -> Dict[str, Dict[str, Tuple[Tuple[int, ...], str]]]:
    """Each stack's leaves by dotted path below it: (shape, init)."""
    d, hd, d_inner, heads, gn = _widths(cfg)
    a, f, r = cfg["attention_hidden_size"], cfg["intermediate_size"], cfg["adapter_rank"]
    conv = d_inner + 2 * gn
    return {
        "blocks": {"ln1": ((a,), "zeros"), "attn.wq": ((a, hd), "normal"),
                   "attn.wk": ((a, hd), "normal"), "attn.wv": ((a, hd), "normal"),
                   "attn.wo": ((hd, d), "normal"), "ln2": ((d,), "zeros"),
                   "mlp.w_gate_up": ((d, 2 * f), "normal"), "mlp.w_down": ((f, d), "normal")},
        "points": {"adapter_a": ((d, r), "normal"), "adapter_b": ((r, 2 * f), "normal"),
                   "linear": ((d, d), "normal")},
        "layers": {"ln": ((d,), "zeros"),
                   "mixer.in_proj": ((d, d_inner + conv + heads), "normal"),
                   "mixer.conv_w": ((cfg["mamba_d_conv"], conv), "normal"),
                   "mixer.conv_b": ((conv,), "zeros"), "mixer.dt_bias": ((heads,), "dt_bias"),
                   "mixer.a_log": ((heads,), "a_log"), "mixer.d_skip": ((heads,), "ones"),
                   "mixer.norm": ((d_inner,), "zeros"),
                   "mixer.out_proj": ((d_inner, d), "normal")},
    }


def stack_sizes(cfg: Mapping) -> Dict[str, int]:
    return {"blocks": cfg["num_mem_blocks"], "points": len(cfg["hybrid_layer_ids"]),
            "layers": cfg["num_hidden_layers"]}


def top_shapes(cfg: Mapping) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    return {"embed": ((W.padded_vocab(cfg), cfg["hidden_size"]), "normal"),
            "ln_f": ((cfg["hidden_size"],), "zeros")}


def leaves(cfg: Mapping) -> List[Tuple[str, Optional[int], Tuple[int, ...], str]]:
    """Every leaf, as (path, stack index or None, shape, init): a stack's
    slice is a leaf of its own, its path the stack's name and the path
    below it."""
    out = [(p, None, s, i) for p, (s, i) in sorted(top_shapes(cfg).items())]
    sizes, shapes = stack_sizes(cfg), stack_shapes(cfg)
    for stack in STACKS:
        for idx in range(sizes[stack]):
            out += [(f"{stack}.{p}", idx, s, i) for p, (s, i) in sorted(shapes[stack].items())]
    return out


def _leaf_index(cfg: Mapping, path: str, idx: Optional[int]) -> int:
    names = sorted(top_shapes(cfg)) + [f"{st}.{p}" for st in STACKS
                                       for p in sorted(stack_shapes(cfg)[st])]
    return names.index(path) * 100_003 + (0 if idx is None else idx + 1)


def block_seed(seed: int, cfg: Mapping, path: str, idx: Optional[int], block: int) -> int:
    return (seed * 1_000_003 + _leaf_index(cfg, path, idx) * 4099 + block) % (1 << 63)


def draw_block(cfg: Mapping, seed: int, path: str, idx: Optional[int], block: int,
               shape: Tuple[int, ...], init: str, device) -> torch.Tensor:
    """One block of rows of one leaf, in the served dtype."""
    dtype = W.dtype_of(cfg)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init == "a_log":
        return torch.arange(1, shape[0] + 1, dtype=torch.float32, device=device).log().to(dtype)
    gen = torch.Generator(device=device).manual_seed(block_seed(seed, cfg, path, idx, block))
    if init == "dt_bias":
        lo, hi = math.log(cfg["time_step_min"]), math.log(cfg["time_step_max"])
        u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
        dt = torch.exp(u * (hi - lo) + lo).clamp(min=cfg["time_step_floor"])
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    return out.normal_(0.0, cfg["initializer_range"], generator=gen)


def fill_leaf(out: torch.Tensor, cfg: Mapping, seed: int, path: str, idx: Optional[int],
              init: str) -> torch.Tensor:
    """Draw a leaf into ``out`` (a tensor of its shape), block by block."""
    for i, r0, r1 in W.blocks(tuple(out.shape)):
        out[r0:r1].copy_(draw_block(cfg, seed, path, idx, i, (r1 - r0,) + tuple(out.shape[1:]),
                                    init, out.device))
    return out


def shape_of(cfg: Mapping, path: str) -> Tuple[Tuple[int, ...], str]:
    stack, _, rest = path.partition(".")
    return stack_shapes(cfg)[stack][rest] if stack in STACKS else top_shapes(cfg)[path]


def draw_leaf(cfg: Mapping, seed: int, path: str, idx: Optional[int], device) -> torch.Tensor:
    shape, init = shape_of(cfg, path)
    return fill_leaf(torch.empty(shape, dtype=W.dtype_of(cfg), device=device), cfg, seed,
                     path, idx, init)


def make(cfg: Mapping, seed: int, device) -> dict:
    """The whole tree on ``device``, stacks stacked, in the served dtype."""
    dtype = W.dtype_of(cfg)
    tree: dict = {}
    for path, (shape, init) in top_shapes(cfg).items():
        W._set(tree, path, fill_leaf(torch.empty(shape, dtype=dtype, device=device), cfg,
                                     seed, path, None, init))
    sizes = stack_sizes(cfg)
    for stack, shapes in stack_shapes(cfg).items():
        for path, (shape, init) in shapes.items():
            full = f"{stack}.{path}"
            out = torch.empty((sizes[stack],) + shape, dtype=dtype, device=device)
            for idx in range(sizes[stack]):
                fill_leaf(out[idx], cfg, seed, full, idx, init)
            W._set(tree, full, out)
    return tree


def get(tree: Mapping, path: str, idx: Optional[int] = None) -> torch.Tensor:
    """A leaf of the tree by dotted path (a stack's slice at ``idx``)."""
    node = tree
    for p in path.split("."):
        node = node[p]
    return node if idx is None else node[idx]
