"""The port's ``moe`` and ``vlm`` families (qwen3-moe-30b-a3b, dbrx-132b,
internvl2-2b) against the reference package's, on the CPU.

One set of weights, made with numpy from a seed, goes to both packages
(``params_from_jax``) with the same seeded tokens (and, for the vlm, the same
frontend rows), in fp32 (the smoke configs with ``dtype="float32"``).  The
forward's logits and MoE aux loss, the training loss and its metrics (the
MoE aux included, the vlm's over the text positions only), the prefill's
last logits and cache, and three decode steps' logits and cache must agree
within rtol 1e-4, atol 1e-5 (sums in another order), as
``tests/test_torch_llama.py`` holds the dense model.

``moe_ffn`` alone: at capacity 1.25, where tokens are dropped, and without
drops, the output and the aux loss match the reference, and the set of
(token, choice) pairs each package keeps is the one an independent rule
keeps (per sequence and expert, the first ``cap`` pairs in token-major
order).  Each package's kept set is read off its own output
(:func:`_kept`).  Also: the exact parameter counts of every new FULL
config, the sliced init of leaves past ``SLICED_DRAW_BYTES``, and the
dot FLOPs of the smoke prefill and train steps' captures against the
reference's live captures.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as RC
from repro.core import Simulator as RefSimulator
from repro.models import build_model as ref_build_model
from repro.models import param_count as ref_param_count
from repro.models.moe import moe_ffn as ref_moe_ffn
from repro.runtime.server import Server as RefServer
from repro.runtime.steps import prefill_bundle
from repro.runtime.steps import train_bundle as ref_train_bundle
from repro_torch import config as C
from repro_torch.core import Simulator
from repro_torch.core.capture import capture_bundle
from repro_torch.models import build_model, layers, param_count
from repro_torch.models.moe import _capacity, moe_ffn, route
from repro_torch.models.transformer import params_from_jax
from repro_torch.runtime.server import Server
from repro_torch.runtime.steps import decode_step, prefill_step, train_bundle

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-moe-30b-a3b", "dbrx-132b", "internvl2-2b"]
B = 2


def _np_tree(specs, rng):
    """Weights in the reference's tree: unit-scale activations, random norm
    gains and biases (the reference initializes them to zero or one)."""
    if not isinstance(specs, dict):
        shape = specs.shape
        if specs.init in ("zeros", "ones"):
            base = 1.0 if specs.init == "ones" else 0.0
            return (base + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        std = 0.5 if specs.init == "embed" else 1.0 / np.sqrt(shape[-2])
        return (std * rng.standard_normal(shape)).astype(np.float32)
    return {k: _np_tree(v, rng) for k, v in specs.items()}


def _close(mine, ref):
    mine = mine.detach().float().numpy() if isinstance(mine, torch.Tensor) else mine
    ref = np.asarray(ref, np.float32)
    assert mine.shape == ref.shape
    np.testing.assert_allclose(mine, ref, rtol=1e-4, atol=1e-5)


def _close_tree(mine, ref):
    if ref is None:
        assert mine is None
        return
    if isinstance(ref, dict):
        assert set(mine) == set(ref)
        for k in ref:
            _close_tree(mine[k], ref[k])
        return
    if isinstance(mine, int):
        assert mine == int(ref)
        return
    _close(mine, ref)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference model, its params, port model, its params, inputs) in fp32."""
    arch = request.param
    ref_cfg = dataclasses.replace(RC.get(arch).smoke, dtype="float32")
    cfg = dataclasses.replace(C.get(arch).smoke, dtype="float32")
    ref_model = ref_build_model(ref_cfg)
    rng = np.random.default_rng(0)
    weights = _np_tree(ref_model.param_specs(), rng)
    front = None
    if cfg.frontend != "none":
        front = rng.standard_normal((B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return (ref_model, jax.tree.map(jnp.asarray, weights), build_model(cfg),
            params_from_jax(weights, cfg), front)


def _tokens(s, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (B, s)).astype(np.int32)


def _batches(front, tokens, labels=None):
    """The same batch for the reference (jnp) and the port (torch)."""
    ref = {"tokens": jnp.asarray(tokens)}
    port = {"tokens": torch.from_numpy(tokens).long()}
    if labels is not None:
        ref["labels"], port["labels"] = jnp.asarray(labels), torch.from_numpy(labels).long()
    if front is not None:
        ref["frontend_emb"] = jnp.asarray(front)
        port["frontend_emb"] = torch.from_numpy(front)
    return ref, port


@pytest.mark.parametrize("s", [16, 40])
def test_forward_matches_reference(pair, s):
    ref_model, ref_params, model, params, front = pair
    rb, pb = _batches(front, _tokens(s))
    want, want_aux = jax.jit(ref_model.forward)(ref_params, rb["tokens"],
                                                rb.get("frontend_emb"))
    got, aux = model.forward(params, pb["tokens"], pb.get("frontend_emb"))
    _close(got, want)
    _close(aux, want_aux)
    assert (float(aux) > 0) == (model.cfg.family == "moe")


def test_loss_and_metrics_match_reference(pair):
    """The training loss with the MoE aux term, or the vlm's over the text
    positions only."""
    ref_model, ref_params, model, params, front = pair
    tokens = _tokens(24)
    rb, pb = _batches(front, tokens, labels=_tokens(24, seed=2))
    want, want_m = jax.jit(ref_model.loss)(ref_params, rb)
    got, got_m = model.loss(params, pb)
    _close(got, want)
    assert set(got_m) == set(want_m)
    for k in want_m:
        _close(got_m[k], want_m[k])


@pytest.mark.parametrize("s", [16, 40])
def test_prefill_and_three_decode_steps_match_reference(pair, s):
    ref_model, ref_params, model, params, front = pair
    tokens = _tokens(s + 3)
    rb, pb = _batches(front, tokens[:, :s])
    want, ref_cache = jax.jit(ref_model.prefill)(ref_params, rb)
    got, cache = prefill_step(model, params, pb)
    _close(got, want)
    _close_tree(cache, ref_cache)
    ref_cache = RefServer._grow_cache(ref_cache, 3)
    cache = Server._grow_cache(cache, 3)
    ref_decode = jax.jit(ref_model.decode_step)
    for i in range(3):
        tok = tokens[:, s + i:s + i + 1]
        want, ref_cache = ref_decode(ref_params, ref_cache, {"token": jnp.asarray(tok)})
        got, cache = decode_step(model, params, cache, {"token": torch.from_numpy(tok).long()})
        _close(got, want)
        _close_tree(cache, ref_cache)


def test_vlm_loss_covers_the_text_only():
    """The frontend rows change the text positions' hidden states, but the
    loss reads only the text's positions."""
    cfg = dataclasses.replace(C.get("internvl2-2b").smoke, dtype="float32")
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    tok = torch.from_numpy(_tokens(12)).long()
    front = torch.randn(B, cfg.frontend_seq, cfg.d_model, generator=torch.Generator().manual_seed(0))
    loss, _ = model.loss(params, {"tokens": tok, "labels": tok, "frontend_emb": front})
    loss0, _ = model.loss(params, {"tokens": tok, "labels": tok, "frontend_emb": 0 * front})
    assert torch.isfinite(loss) and float(loss) != float(loss0)
    specs, _ = model.train_input_specs(C.ShapeConfig("t", 40, B, "train"))
    assert specs["tokens"].shape == (B, 40 - cfg.frontend_seq)
    assert specs["frontend_emb"].shape == (B, cfg.frontend_seq, cfg.d_model)


# -- moe_ffn ----------------------------------------------------------------

E_D = 16     # width of the unit's experts and tokens


def _unit_cfg(e=8, k=2):
    return dataclasses.replace(C.get("qwen3-moe-30b-a3b").smoke, d_model=E_D, d_ff=8,
                               num_experts=e, experts_per_token=k, dtype="float32")


def _unit_params(cfg, rng):
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {"router": rng.standard_normal((d, e)).astype(np.float32),
            "w_gate": (rng.standard_normal((e, d, f)) / 4).astype(np.float32),
            "w_up": (rng.standard_normal((e, d, f)) / 4).astype(np.float32),
            "w_down": (rng.standard_normal((e, f, d)) / 3).astype(np.float32)}


def _independent_kept(gate_idx: np.ndarray, e: int, cap: int) -> np.ndarray:
    """(b, s, k) bool: per sequence and expert, the first ``cap`` (token,
    choice) pairs in token-major order are kept."""
    b, s, k = gate_idx.shape
    kept = np.zeros(gate_idx.shape, bool)
    for i in range(b):
        seen = np.zeros(e, int)
        for t in range(s):
            for c in range(k):
                ex = gate_idx[i, t, c]
                kept[i, t, c] = seen[ex] < cap
                seen[ex] += 1
    return kept


def _kept(fn, params, x, gate_idx):
    """The kept set of an ``moe_ffn`` read off its output: with every
    token's feature 0 set to 1 and experts that map it to silu(10) times the
    one-hot of their own index, output (t, e) is positive iff a kept choice
    of token t went to expert e (the gates are positive).  The router sees
    the same x, so the routing (``gate_idx``, taken beforehand) is kept."""
    e, d, f = params["w_gate"].shape
    probe = dict(params)
    probe["w_gate"] = np.zeros((e, d, f), np.float32)
    probe["w_gate"][:, 0, 0] = 10.0
    probe["w_up"] = np.zeros((e, d, f), np.float32)
    probe["w_up"][:, 0, 0] = 1.0
    probe["w_down"] = np.zeros((e, f, d), np.float32)
    probe["w_down"][np.arange(e), 0, np.arange(e)] = 1.0
    out = np.asarray(fn(probe, x))
    return np.take_along_axis(out, gate_idx, axis=-1) > 0


def _moe_x(rng, s):
    x = rng.standard_normal((B, s, E_D)).astype(np.float32)
    x[..., 0] = 1.0
    return x


@pytest.mark.parametrize("factor,drops", [(1.25, True), (0.0, False)])
def test_moe_ffn_matches_reference_and_keeps_the_token_major_first(factor, drops):
    cfg = _unit_cfg()
    ref_cfg = dataclasses.replace(RC.get("qwen3-moe-30b-a3b").smoke, d_model=E_D, d_ff=8,
                                  num_experts=8, experts_per_token=2, dtype="float32")
    rng = np.random.default_rng(3)
    params, s = _unit_params(cfg, rng), 48
    x = _moe_x(rng, s)

    def port(p, xx):
        return moe_ffn({k: torch.from_numpy(v) for k, v in p.items()}, cfg,
                       torch.from_numpy(xx), capacity_factor=factor)[0].numpy()

    def ref(p, xx):
        return ref_moe_ffn(jax.tree.map(jnp.asarray, p), ref_cfg, jnp.asarray(xx),
                           capacity_factor=factor)[0]

    want, want_aux = ref_moe_ffn(jax.tree.map(jnp.asarray, params), ref_cfg, jnp.asarray(x),
                                 capacity_factor=factor)
    got, aux = moe_ffn({k: torch.from_numpy(v) for k, v in params.items()}, cfg,
                       torch.from_numpy(x), capacity_factor=factor)
    _close(got, want)
    _close(aux, want_aux)
    cap = _capacity(s, cfg, factor)
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(params["router"]), -1)
    gate_idx = torch.topk(probs, 2, -1).indices.numpy()
    rule = _independent_kept(gate_idx, 8, cap)
    assert (not rule.all()) == drops
    np.testing.assert_array_equal(_kept(port, params, x, gate_idx), rule)
    np.testing.assert_array_equal(_kept(ref, params, x, gate_idx), rule)
    # the plan the port's dispatch builds says the same
    _, _, gates, slot, gather_idx, filled = route(
        {"router": torch.from_numpy(params["router"])}, cfg, torch.from_numpy(x), cap)
    np.testing.assert_array_equal((slot < 8 * cap).reshape(B, s, 2).numpy(), rule)
    assert int(filled.sum()) == int(rule.sum())
    assert bool((gates[torch.from_numpy(~rule)] == 0).all())


def test_capacity_caps_at_the_tokens_then_floors_at_4():
    cfg = _unit_cfg()
    assert _capacity(2, cfg, 1.25) == 4          # min(0, 2), then the floor
    assert _capacity(8, cfg, 1.25) == 4          # int(2.5) floored at 4
    assert _capacity(40, cfg, 4.0) == 40         # int(40) capped at the tokens
    assert _capacity(64, cfg, 1.25) == 20
    assert _capacity(64, cfg, 0.0) == 64 == _capacity(64, cfg, -1.0)


def test_aux_loss_is_the_switch_loss():
    """e * sum_e f_e P_e with f the routed fraction (top-k choices over
    tokens) and P the mean router probability, averaged over the batch."""
    cfg = _unit_cfg()
    rng = np.random.default_rng(4)
    params = _unit_params(cfg, rng)
    x = torch.from_numpy(_moe_x(rng, 32))
    _, aux = moe_ffn({k: torch.from_numpy(v) for k, v in params.items()}, cfg, x)
    probs = torch.softmax(x @ torch.from_numpy(params["router"]), -1)
    idx = torch.topk(probs, 2, -1).indices
    frac = torch.stack([torch.bincount(i.reshape(-1), minlength=8) for i in idx]).float() / 32
    want = 8 * torch.mean(frac.mean(0) * probs.mean((0, 1)))
    torch.testing.assert_close(aux, want, rtol=1e-6, atol=0)


# -- parameter counts, init ---------------------------------------------------

COUNTS = {  # arch: (parameters, active parameters)
    "qwen3-moe-30b-a3b": (30_532_634_624, 3_353_544_704),
    "dbrx-132b": (131_596_523_520, 36_469_708_800),
    "internvl2-2b": (1_889_634_304, 1_889_634_304),
    "zamba2-7b": (6_751_130_832, 6_751_130_832),
    "rwkv6-1.6b": (1_599_721_472, 1_599_721_472),
    "seamless-m4t-large-v2": (1_632_675_840, 1_632_675_840),
}


@pytest.mark.parametrize("arch", sorted(COUNTS))
def test_full_config_param_counts(arch):
    full = C.get(arch).full
    n, active = COUNTS[arch]
    assert param_count(full) == n == ref_param_count(RC.get(arch).full)
    assert param_count(full, active_only=True) == active == ref_param_count(
        RC.get(arch).full, active_only=True)


def test_a_leaf_past_the_slicing_size_is_drawn_slice_by_slice(monkeypatch):
    """Each slice of the leading dim is one fp32 draw of the slice's shape,
    written into a tensor of the target dtype; the leaf below the size is
    one draw, as before."""
    spec = layers.ParamSpec((3, 4, 5), (None, None, None))
    small = layers.ParamSpec((2, 3), (None, None))
    monkeypatch.setattr(layers, "SLICED_DRAW_BYTES", 4 * 4 * 5)
    got = layers.init_params({"a": spec, "b": small}, torch.Generator().manual_seed(7),
                             "bfloat16")
    gen = torch.Generator().manual_seed(7)
    std = 1.0 / np.sqrt(3)
    rows = [torch.randn((4, 5), generator=gen).mul_(std) for _ in range(3)]
    whole = torch.randn((2, 3), generator=gen).mul_(1.0 / np.sqrt(2))
    assert got["a"].dtype == torch.bfloat16
    torch.testing.assert_close(got["a"], torch.stack(rows).bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(got["b"], whole.bfloat16(), rtol=0, atol=0)


def _whole_draws(specs, gen, dtype):
    """The init before slicing: every leaf one fp32 draw, cast."""
    if isinstance(specs, layers.ParamSpec):
        return layers._init_one(specs, gen, dtype)
    return {k: _whole_draws(v, gen, dtype) for k, v in specs.items()}


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma3-12b", "qwen1.5-4b",
                                  "qwen3-moe-30b-a3b"])
def test_dense_draws_are_unchanged_and_the_expert_stack_is_sliced(arch, monkeypatch):
    """Every leaf of the dense FULL configs (and of every smoke config)
    stays within the slicing size, so it is drawn whole as before; the
    qwen3-moe FULL expert stacks (38.65 GB in fp32) are past it."""
    full = list(layers._spec_leaves(build_model(C.get(arch).full).param_specs()))
    biggest = max(4 * int(np.prod(s.shape)) for s in full)
    assert (biggest > layers.SLICED_DRAW_BYTES) == (arch == "qwen3-moe-30b-a3b")
    smoke = build_model(C.get(arch).smoke).param_specs()
    got = layers.init_params(smoke, torch.Generator().manual_seed(1), "float32")
    monkeypatch.setattr(layers, "SLICED_DRAW_BYTES", 1 << 62)
    want = _whole_draws(smoke, torch.Generator().manual_seed(1), "float32")
    for g, w in zip(_leaves(got), _leaves(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# -- capture, imports ---------------------------------------------------------

def _dot_flops(module):
    return sum(scale * module.op_flops(comp, op)["mxu"]
               for op, comp, scale in module.walk_entry() if op.opcode == "dot")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_capture_dot_flops_match_the_reference(arch):
    b, s = B, 256
    cfg = C.get(arch).smoke
    model = build_model(cfg)
    specs, _ = model.prefill_input_specs(C.ShapeConfig("p", s, b, "prefill"))
    batch = {k: torch.zeros(v.shape, dtype=torch.long if k == "tokens" else v.dtype)
             for k, v in specs.items()}
    port = Simulator().capture(lambda p, bt: prefill_step(model, p, bt),
                               model.init(seed=0, device="cpu"), batch, name="prefill")
    ref = RefSimulator().capture_bundle(prefill_bundle(RC.RunConfig(
        model=RC.get(arch).smoke, shape=RC.ShapeConfig("p", s, b, "prefill"),
        mesh=RC.SMOKE_MESH)), name="prefill")
    assert _dot_flops(port.module) == _dot_flops(ref.module)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_capture_dot_flops_match_the_reference(arch):
    """The smoke train step captured by both packages at b 1, s 1024 (two
    loss chunks): the port's products are the reference's plus the 2
    attention products of the flash op's backward recompute, a layer (see
    tests/test_torch_train.py); the expert products, the router and the
    dispatch count alike."""
    b, s = 1, 1024
    rc = C.RunConfig(model=C.get(arch).smoke, shape=C.ShapeConfig("t", s, b, "train"),
                     mesh=C.SMOKE_MESH)
    port = capture_bundle(train_bundle(rc), device="cpu")
    ref_rc = RC.RunConfig(model=RC.get(arch).smoke, shape=RC.ShapeConfig("t", s, b, "train"),
                          mesh=RC.SMOKE_MESH)
    ref = RefSimulator().capture_bundle(ref_train_bundle(ref_rc))
    cfg = rc.model
    att = 2 * b * cfg.num_heads * s * s * cfg.resolved_head_dim
    assert _dot_flops(port.module) == _dot_flops(ref.module) + cfg.num_layers * 2 * att


def test_new_modules_import_with_jax_and_repro_blocked():
    mods = ["repro_torch.models.moe", "repro_torch.configs.qwen3_moe_30b",
            "repro_torch.configs.dbrx_132b", "repro_torch.configs.internvl2_2b"]
    script = ("import importlib, sys\n"
              "sys.modules['jax'] = None\nsys.modules['repro'] = None\n"
              f"for m in {mods!r}:\n    importlib.import_module(m)\n"
              "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
