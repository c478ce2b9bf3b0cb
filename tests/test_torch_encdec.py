"""The port's encoder-decoder family (seamless-m4t-large-v2, family "audio")
and cross-attention against the reference package's, on the CPU.

One set of weights, made with numpy from a seed, goes to both packages
(``params_from_jax``: the ``encoder``/``decoder`` tree) with the same seeded
tokens and frontend frames, in fp32 (the smoke config with
``dtype="float32"``).  The forward's logits, the training loss, the
prefill's last logits and cache (decoder K/V and the encoder's output) and
three decode steps' logits and cache must agree within rtol 1e-4, atol
1e-5, as ``tests/test_torch_llama.py`` holds the dense model.

``attention`` with ``kv_source`` (cross-attention: no mask, no RoPE, s
queries against t other rows) matches the reference's at s != t and at
s = 1, and runs the flash op.  The prefill capture counts the reference's
dot FLOPs exactly, and the train step's are the reference's plus the 2
attention products the flash op's backward recomputes for every
full-sequence attention: encoder, decoder and cross.
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
from repro.models import attention as ref_attn
from repro.models import build_model as ref_build_model
from repro.runtime.server import Server as RefServer
from repro.runtime.steps import prefill_bundle
from repro.runtime.steps import train_bundle as ref_train_bundle
from repro_torch import config as C
from repro_torch.core import Simulator
from repro_torch.core.capture import capture_bundle
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.models.transformer import params_from_jax
from repro_torch.runtime.server import Server
from repro_torch.runtime.steps import decode_step, prefill_step, train_bundle

ROOT = Path(__file__).resolve().parents[1]
ARCH = "seamless-m4t-large-v2"
B = 2


def _np_tree(specs, rng):
    """Weights in the reference's tree: unit-scale activations, random norm
    gains and biases (the reference initializes them to zero)."""
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
    if isinstance(ref, dict):
        assert set(mine) == set(ref)
        for k in ref:
            _close_tree(mine[k], ref[k])
        return
    if isinstance(mine, int):
        assert mine == int(ref)
        return
    _close(mine, ref)


@pytest.fixture(scope="module")
def pair():
    """(reference model, its params, port model, its params, frames) in fp32."""
    ref_cfg = dataclasses.replace(RC.get(ARCH).smoke, dtype="float32")
    cfg = dataclasses.replace(C.get(ARCH).smoke, dtype="float32")
    ref_model = ref_build_model(ref_cfg)
    rng = np.random.default_rng(0)
    weights = _np_tree(ref_model.param_specs(), rng)
    front = rng.standard_normal((B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return (ref_model, jax.tree.map(jnp.asarray, weights), build_model(cfg),
            params_from_jax(weights, cfg), front)


def _tokens(s, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (B, s)).astype(np.int32)


@pytest.mark.parametrize("s", [1, 16, 40])
def test_forward_matches_reference(pair, s):
    ref_model, ref_params, model, params, front = pair
    tokens = _tokens(s)
    want = jax.jit(ref_model.forward)(ref_params, jnp.asarray(tokens), jnp.asarray(front))
    _close(model.forward(params, torch.from_numpy(tokens).long(), torch.from_numpy(front)),
           want)


def test_loss_matches_reference(pair):
    ref_model, ref_params, model, params, front = pair
    tokens, labels = _tokens(24), _tokens(24, seed=2)
    want, want_m = jax.jit(ref_model.loss)(ref_params, {
        "tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
        "frontend_emb": jnp.asarray(front)})
    got, got_m = model.loss(params, {
        "tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long(),
        "frontend_emb": torch.from_numpy(front)})
    _close(got, want)
    _close(got_m["ce"], want_m["ce"])


@pytest.mark.parametrize("s", [16, 40])
def test_prefill_and_three_decode_steps_match_reference(pair, s):
    ref_model, ref_params, model, params, front = pair
    tokens = _tokens(s + 3)
    want, ref_cache = jax.jit(ref_model.prefill)(ref_params, {
        "tokens": jnp.asarray(tokens[:, :s]), "frontend_emb": jnp.asarray(front)})
    got, cache = prefill_step(model, params, {"tokens": torch.from_numpy(tokens[:, :s]).long(),
                                              "frontend_emb": torch.from_numpy(front)})
    _close(got, want)
    _close_tree(cache, ref_cache)
    ref_cache = RefServer._grow_cache(ref_cache, 3)
    cache = Server._grow_cache(cache, 3)
    assert cache["enc_out"].shape == (B, model.cfg.frontend_seq, model.cfg.d_model)
    ref_decode = jax.jit(ref_model.decode_step)
    for i in range(3):
        tok = tokens[:, s + i:s + i + 1]
        want, ref_cache = ref_decode(ref_params, ref_cache, {"token": jnp.asarray(tok)})
        got, cache = decode_step(model, params, cache, {"token": torch.from_numpy(tok).long()})
        _close(got, want)
        _close_tree(cache, ref_cache)


# -- cross-attention ------------------------------------------------------------

class _FlashCalls(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the (s, t, causal) of every flash op call."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.repro_torch.flash_attention.default:
            self.calls.append((args[0].shape[2], args[1].shape[2], args[3]))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("s,t", [(24, 16), (1, 16), (16, 40)])
def test_cross_attention_matches_reference_through_the_flash_op(s, t):
    ref_cfg = dataclasses.replace(RC.get(ARCH).smoke, dtype="float32")
    cfg = dataclasses.replace(C.get(ARCH).smoke, dtype="float32")
    rng = np.random.default_rng(s + t)
    p = _np_tree(ref_attn.attn_param_specs(ref_cfg), rng)
    x = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((B, t, cfg.d_model)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32) + 5
    want = ref_attn.attention(jax.tree.map(jnp.asarray, p), ref_cfg, jnp.asarray(x),
                              jnp.asarray(pos), kv_source=jnp.asarray(src), causal=False)
    with _FlashCalls() as mode:
        got = attn.attention({k: torch.from_numpy(v) for k, v in p.items()}, cfg,
                             torch.from_numpy(x), torch.from_numpy(pos),
                             kv_source=torch.from_numpy(src), causal=False)
    _close(got, want)
    assert mode.calls == [(s, t, False)]


def test_self_attention_without_rope_matches_reference():
    ref_cfg = dataclasses.replace(RC.get(ARCH).smoke, dtype="float32")
    cfg = dataclasses.replace(C.get(ARCH).smoke, dtype="float32")
    rng = np.random.default_rng(9)
    p = _np_tree(ref_attn.attn_param_specs(ref_cfg), rng)
    x = rng.standard_normal((B, 12, cfg.d_model)).astype(np.float32)
    pos = np.arange(12, dtype=np.int32)
    for causal in (True, False):
        want = ref_attn.attention(jax.tree.map(jnp.asarray, p), ref_cfg, jnp.asarray(x),
                                  jnp.asarray(pos), causal=causal, use_rope=False)
        got = attn.attention({k: torch.from_numpy(v) for k, v in p.items()}, cfg,
                             torch.from_numpy(x), torch.from_numpy(pos), causal=causal,
                             use_rope=False)
        _close(got, want)


def test_every_full_sequence_attention_runs_the_flash_op(pair):
    """A prefill: per encoder layer one non-causal call over the frames,
    per decoder layer one causal self-attention and one cross-attention;
    a decode step: one cross-attention call (s = 1) a decoder layer."""
    _, _, model, params, front = pair
    cfg, s, t = model.cfg, 12, model.cfg.frontend_seq
    batch = {"tokens": torch.from_numpy(_tokens(s)).long(),
             "frontend_emb": torch.from_numpy(front)}
    with _FlashCalls() as mode:
        _, cache = prefill_step(model, params, batch)
    assert mode.calls == ([(t, t, False)] * cfg.encoder_layers
                          + [(s, s, True), (s, t, False)] * cfg.num_layers)
    cache = Server._grow_cache(cache, 1)
    with _FlashCalls() as mode:
        decode_step(model, params, cache, {"token": batch["tokens"][:, :1]})
    assert mode.calls == [(1, t, False)] * cfg.num_layers


# -- capture, imports ------------------------------------------------------------

def _dot_flops(module):
    return sum(scale * module.op_flops(comp, op)["mxu"]
               for op, comp, scale in module.walk_entry() if op.opcode == "dot")


def test_prefill_capture_dot_flops_match_the_reference():
    b, s = B, 256
    cfg = C.get(ARCH).smoke
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    specs, _ = model.prefill_input_specs(C.ShapeConfig("p", s, b, "prefill"))
    batch = {"tokens": torch.zeros(specs["tokens"].shape, dtype=torch.long),
             "frontend_emb": torch.zeros(specs["frontend_emb"].shape, dtype=torch.bfloat16)}
    port = Simulator().capture(lambda p, bt: prefill_step(model, p, bt), params, batch,
                               name="prefill")
    ref = RefSimulator().capture_bundle(prefill_bundle(RC.RunConfig(
        model=RC.get(ARCH).smoke, shape=RC.ShapeConfig("p", s, b, "prefill"),
        mesh=RC.SMOKE_MESH)), name="prefill")
    assert _dot_flops(port.module) == _dot_flops(ref.module)


def test_train_capture_dot_flops_match_the_reference():
    """b 1, s 1024 (1008 text positions after 16 frames: two loss chunks)."""
    b, s = 1, 1024
    rc = C.RunConfig(model=C.get(ARCH).smoke, shape=C.ShapeConfig("t", s, b, "train"),
                     mesh=C.SMOKE_MESH)
    port = _dot_flops(capture_bundle(train_bundle(rc), device="cpu").module)
    ref = _dot_flops(RefSimulator().capture_bundle(ref_train_bundle(RC.RunConfig(
        model=RC.get(ARCH).smoke, shape=RC.ShapeConfig("t", s, b, "train"),
        mesh=RC.SMOKE_MESH))).module)
    cfg = rc.model
    f, n = cfg.frontend_seq, s - cfg.frontend_seq

    def att(q, k):
        return 2 * b * cfg.num_heads * q * k * cfg.resolved_head_dim

    recompute = 2 * (cfg.encoder_layers * att(f, f) + cfg.num_layers * (att(n, n) + att(n, f)))
    assert port == ref + recompute


def test_new_modules_import_with_jax_and_repro_blocked():
    mods = ["repro_torch.models.encdec", "repro_torch.models.attention",
            "repro_torch.configs.seamless_m4t"]
    script = ("import importlib, sys\n"
              "sys.modules['jax'] = None\nsys.modules['repro'] = None\n"
              f"for m in {mods!r}:\n    importlib.import_module(m)\n"
              "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
