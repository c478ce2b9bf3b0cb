"""Seeded weights in the port's parameter tree, made by the benchmark.

The tree is the port's decoder LM's: ``embed`` (padded vocab, d), ``layers``
stacked on a leading layer axis (``ln1``, ``attn`` with ``wq``, ``wk``, ``wv``,
``wo`` and, with ``qkv_bias``, ``bq``, ``bk``, ``bv``; ``ln2``; ``ffn`` or
``moe``), ``ln_f`` and ``head`` (d, padded vocab).  A norm's weight is stored
as ``gamma`` in a ``(1 + gamma)`` scale.

Every matrix is drawn from a normal of standard deviation
``initializer_range`` (the published configuration's), biases and norm
gammas are zeros.  A leaf is drawn in blocks of its leading rows, each block
from a generator of its own seeded from (seed, leaf, layer, block), so that
any block can be drawn again alone, with little memory, and gives the same
numbers: the reference and the readings after a run draw the weights again
rather than read the program's tensors.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import torch

#: elements of one drawn block (32 MB in bf16)
BLOCK = 1 << 24
VOCAB_MULTIPLE = 256
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def dtype_of(cfg: Mapping) -> torch.dtype:
    return _DTYPES[cfg["torch_dtype"]]


def padded_vocab(cfg: Mapping) -> int:
    v = cfg["vocab_size"]
    return (v + VOCAB_MULTIPLE - 1) // VOCAB_MULTIPLE * VOCAB_MULTIPLE


def head_dim(cfg: Mapping) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]


def layer_shapes(cfg: Mapping) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """One layer's leaves by dotted path: (shape, init), init "normal" or
    "zeros"."""
    d, h, kv, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                    cfg["num_key_value_heads"], head_dim(cfg))
    out = {
        "ln1": ((d,), "zeros"),
        "attn.wq": ((d, h * hd), "normal"),
        "attn.wk": ((d, kv * hd), "normal"),
        "attn.wv": ((d, kv * hd), "normal"),
        "attn.wo": ((h * hd, d), "normal"),
        "ln2": ((d,), "zeros"),
    }
    if cfg.get("qkv_bias"):
        out.update({"attn.bq": ((h * hd,), "zeros"), "attn.bk": ((kv * hd,), "zeros"),
                    "attn.bv": ((kv * hd,), "zeros")})
    if cfg.get("num_experts"):
        e, f = cfg["num_experts"], cfg["moe_intermediate_size"]
        out.update({"moe.router": ((d, e), "normal"), "moe.w_gate": ((e, d, f), "normal"),
                    "moe.w_up": ((e, d, f), "normal"), "moe.w_down": ((e, f, d), "normal")})
    else:
        f = cfg["intermediate_size"]
        out.update({"ffn.w_gate": ((d, f), "normal"), "ffn.w_up": ((d, f), "normal"),
                    "ffn.w_down": ((f, d), "normal")})
    return out


def top_shapes(cfg: Mapping) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    d, vp = cfg["hidden_size"], padded_vocab(cfg)
    return {"embed": ((vp, d), "normal"), "ln_f": ((d,), "zeros"),
            "head": ((d, vp), "normal")}


def leaves(cfg: Mapping) -> List[Tuple[str, Optional[int], Tuple[int, ...], str]]:
    """Every leaf the model has, as (path, layer or None, shape, init): a
    layer's slice of a stacked leaf is a leaf of its own."""
    out = [(p, None, s, i) for p, (s, i) in sorted(top_shapes(cfg).items())]
    for layer in range(cfg["num_hidden_layers"]):
        out += [(p, layer, s, i) for p, (s, i) in sorted(layer_shapes(cfg).items())]
    return out


def leaf_name(path: str, layer: Optional[int]) -> str:
    return path if layer is None else f"layers.{layer}.{path}"


def _leaf_index(cfg: Mapping, path: str, layer: Optional[int]) -> int:
    names = sorted(top_shapes(cfg)) + sorted(layer_shapes(cfg))
    return names.index(path) * 100_003 + (0 if layer is None else layer + 1)


def blocks(shape: Tuple[int, ...]) -> Iterator[Tuple[int, int, int]]:
    """(block number, first row, end row) of a leaf's leading rows."""
    rest = math.prod(shape[1:])
    rows = max(1, BLOCK // max(rest, 1))
    for i, r0 in enumerate(range(0, shape[0], rows)):
        yield i, r0, min(r0 + rows, shape[0])


def block_seed(seed: int, cfg: Mapping, path: str, layer: Optional[int], block: int) -> int:
    return (seed * 1_000_003 + _leaf_index(cfg, path, layer) * 4099 + block) % (1 << 63)


def draw_block(cfg: Mapping, seed: int, path: str, layer: Optional[int], block: int,
               shape: Tuple[int, ...], init: str, device) -> torch.Tensor:
    """One block of rows of one leaf, in the served dtype."""
    dtype = dtype_of(cfg)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(block_seed(seed, cfg, path, layer, block))
    out = torch.empty(shape, dtype=dtype, device=device)
    return out.normal_(0.0, cfg["initializer_range"], generator=gen)


def fill_leaf(out: torch.Tensor, cfg: Mapping, seed: int, path: str,
              layer: Optional[int], init: str) -> torch.Tensor:
    """Draw a leaf into ``out`` (a tensor of its shape), block by block."""
    for i, r0, r1 in blocks(tuple(out.shape)):
        out[r0:r1].copy_(draw_block(cfg, seed, path, layer, i, (r1 - r0,) + tuple(out.shape[1:]),
                                    init, out.device))
    return out


def draw_leaf(cfg: Mapping, seed: int, path: str, layer: Optional[int], device
              ) -> torch.Tensor:
    shape, init = (layer_shapes(cfg) if layer is not None else top_shapes(cfg))[path]
    return fill_leaf(torch.empty(shape, dtype=dtype_of(cfg), device=device), cfg, seed,
                     path, layer, init)


def _set(tree: dict, path: str, value) -> None:
    *parents, last = path.split(".")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[last] = value


def make(cfg: Mapping, seed: int, device) -> dict:
    """The whole tree on ``device``, layers stacked, in the served dtype."""
    n = cfg["num_hidden_layers"]
    dtype = dtype_of(cfg)
    tree: dict = {}
    for path, (shape, init) in top_shapes(cfg).items():
        _set(tree, path, fill_leaf(torch.empty(shape, dtype=dtype, device=device), cfg, seed,
                                   path, None, init))
    layers: dict = {}
    for path, (shape, init) in layer_shapes(cfg).items():
        stack = torch.empty((n,) + shape, dtype=dtype, device=device)
        for layer in range(n):
            fill_leaf(stack[layer], cfg, seed, path, layer, init)
        _set(layers, path, stack)
    tree["layers"] = layers
    return tree


def get(tree: Mapping, path: str, layer: Optional[int] = None) -> torch.Tensor:
    """A leaf of the tree by dotted path (a layer's slice of a stacked one)."""
    node = tree if layer is None else tree["layers"]
    for p in path.split("."):
        node = node[p]
    return node if layer is None else node[layer]


def shapes_of(tree: Mapping, prefix: str = "") -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{dotted path: (shape, dtype)} of a tree of tensors."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(shapes_of(v, name + "."))
        else:
            out[name] = (tuple(v.shape), v.dtype)
    return out
