"""The port's hybrid family (zamba2-7b: Mamba2 layers and one shared
attention block) against the reference package's, on the CPU.

One set of weights, made with numpy from a seed, goes to both packages
(``params_from_jax``: the ``shared``/``groups``/``tail`` tree) with the same
seeded tokens, in fp32 (the smoke config with ``dtype="float32"``, and a
5-layer variant that has a ``tail`` layer).  The forward's logits, the
training loss, the prefill's last logits and cache (each application's K/V,
the Mamba2 states and conv tails) and three decode steps' logits and cache
must agree within rtol 1e-4, atol 1e-5, as ``tests/test_torch_llama.py``
holds the dense model.  Lengths 16 and 272: at 272 the SSD scan runs two
chunks of 136.

``ssd_chunked`` alone, over four chunks, matches the reference and the
step-by-step recurrence (float64 numpy).  ``Server._grow_cache`` pads every
K/V cache of a nested cache and leaves the recurrent states as they are.
The prefill capture counts the reference's dot FLOPs exactly; the train
step's are held within a stated band (see the test).
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
from repro.models.ssm import ssd_chunked as ref_ssd_chunked
from repro.runtime.server import Server as RefServer
from repro.runtime.steps import prefill_bundle
from repro.runtime.steps import train_bundle as ref_train_bundle
from repro_torch import config as C
from repro_torch.core import Simulator
from repro_torch.core.capture import capture_bundle
from repro_torch.models import build_model
from repro_torch.models.ssm import ssd_chunked
from repro_torch.models.transformer import params_from_jax
from repro_torch.runtime.server import Server
from repro_torch.runtime.steps import decode_step, prefill_step, train_bundle

ROOT = Path(__file__).resolve().parents[1]
ARCH = "zamba2-7b"
B = 2


def _np_tree(specs, rng):
    """Weights in the reference's tree: unit-scale activations, random norm
    gains, biases and SSM parameters (the reference initializes them to zero
    or one)."""
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


def _mamba2_init(tree, rng):
    """Mamba2's own initialization of the decay (arXiv:2405.21060, as
    released): A uniform in [1, 16] (a_log = log A) and the step dt
    log-uniform in [1e-3, 1e-1] (dt_bias its inverse softplus).  With the
    reference's zeros (A = 1, dt the softplus of a unit-scale input) both
    packages' fp32 forwards at s 272 miss a float64 evaluation of the
    reference by 3.5e-5 of logits of scale 4.6, more than the tolerance:
    the chunk's cumulative log decay is long, and the two sum it in another
    order.  At Mamba2's decays they agree within it."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "a_log":
                tree[k] = np.log(rng.uniform(1, 16, v.shape)).astype(np.float32)
            elif k == "dt_bias":
                dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), v.shape))
                tree[k] = (dt + np.log(-np.expm1(-dt))).astype(np.float32)
            else:
                _mamba2_init(v, rng)
    return tree


@pytest.fixture(scope="module", params=[4, 5], ids=["smoke", "with_tail"])
def pair(request):
    """(reference model, its params, port model, its params) in fp32."""
    layers = request.param
    ref_cfg = dataclasses.replace(RC.get(ARCH).smoke, dtype="float32", num_layers=layers)
    cfg = dataclasses.replace(C.get(ARCH).smoke, dtype="float32", num_layers=layers)
    ref_model = ref_build_model(ref_cfg)
    rng = np.random.default_rng(0)
    weights = _mamba2_init(_np_tree(ref_model.param_specs(), rng), rng)
    model = build_model(cfg)
    assert ("tail" in weights) == (layers == 5) == bool(model.remainder)
    return ref_model, jax.tree.map(jnp.asarray, weights), model, params_from_jax(weights, cfg)


def _tokens(s, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (B, s)).astype(np.int32)


@pytest.mark.parametrize("s", [16, 272])
def test_forward_matches_reference(pair, s):
    ref_model, ref_params, model, params = pair
    tokens = _tokens(s)
    want = jax.jit(ref_model.forward)(ref_params, jnp.asarray(tokens))
    _close(model.forward(params, torch.from_numpy(tokens).long()), want)


def test_loss_matches_reference(pair):
    ref_model, ref_params, model, params = pair
    tokens, labels = _tokens(24), _tokens(24, seed=2)
    want, want_m = jax.jit(ref_model.loss)(
        ref_params, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    got, got_m = model.loss(params, {"tokens": torch.from_numpy(tokens).long(),
                                     "labels": torch.from_numpy(labels).long()})
    _close(got, want)
    _close(got_m["ce"], want_m["ce"])


@pytest.mark.parametrize("s", [16, 272])
def test_prefill_and_three_decode_steps_match_reference(pair, s):
    ref_model, ref_params, model, params = pair
    tokens = _tokens(s + 3)
    want, ref_cache = jax.jit(ref_model.prefill)(
        ref_params, {"tokens": jnp.asarray(tokens[:, :s])})
    got, cache = prefill_step(model, params, {"tokens": torch.from_numpy(tokens[:, :s]).long()})
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


def test_each_shared_application_has_its_own_kv_cache(pair):
    """The G applications of the one shared block write G different K/V
    caches (their inputs differ); the Mamba2 states are (G, attn_every, b,
    heads, headdim, state) and the tail's (R, ...)."""
    _, _, model, params = pair
    _, cache = prefill_step(model, params, {"tokens": torch.from_numpy(_tokens(16)).long()})
    k = cache["groups"]["k"]
    assert k.shape[0] == model.groups == 2
    assert not torch.allclose(k[0], k[1])
    cfg = model.cfg
    assert cache["groups"]["mamba"]["state"].shape == (2, cfg.attn_every, B, 2, 64,
                                                       cfg.ssm_state)
    assert (cache["tail"] is None) == (model.remainder == 0)
    if model.remainder:
        assert cache["tail"]["state"].shape == (model.remainder, B, 2, 64, cfg.ssm_state)


# -- the SSD scan -------------------------------------------------------------

def _ssd_inputs(rng, s, h=3, p=8, n=5):
    xdt = rng.standard_normal((B, s, h, p)).astype(np.float32)
    dA = -np.abs(rng.standard_normal((B, s, h))).astype(np.float32) * 0.3
    Bm = rng.standard_normal((B, s, n)).astype(np.float32)
    Cm = rng.standard_normal((B, s, n)).astype(np.float32)
    state0 = rng.standard_normal((B, h, p, n)).astype(np.float32)
    return xdt, dA, Bm, Cm, state0


def _ssd_sequential(xdt, dA, B_, C_, state0):
    """Step-by-step SSD recurrence in float64."""
    state = state0.astype(np.float64)
    ys = np.zeros(xdt.shape)
    for t in range(xdt.shape[1]):
        state = (state * np.exp(dA[:, t])[..., None, None]
                 + np.einsum("bn,bhp->bhpn", B_[:, t], xdt[:, t]))
        ys[:, t] = np.einsum("bn,bhpn->bhp", C_[:, t], state)
    return ys, state


@pytest.mark.parametrize("s", [64, 72])
def test_ssd_chunked_over_several_chunks(s):
    """Four chunks of 16 (s 64) or of 18 (s 72): the port's scan equals the
    reference's and the recurrence, output and final state."""
    args = _ssd_inputs(np.random.default_rng(s), s)
    y, state = ssd_chunked(*(torch.from_numpy(a) for a in args), chunk=16)
    want_y, want_state = ref_ssd_chunked(*(jnp.asarray(a) for a in args), chunk=16)
    _close(y, want_y)
    _close(state, want_state)
    seq_y, seq_state = _ssd_sequential(*args)
    np.testing.assert_allclose(y.numpy(), seq_y, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(state.numpy(), seq_state, rtol=1e-4, atol=1e-4)


# -- the server's cache growth -------------------------------------------------

def test_grow_cache_pads_every_kv_cache_and_keeps_the_states():
    kv = torch.ones(2, B, 5, 4, 16)
    state = torch.ones(2, 3, B, 2, 64, 16)
    conv = torch.ones(2, 3, B, 3, 160)
    cache = {"groups": {"k": kv, "v": kv.clone(), "mamba": {"state": state, "conv": conv}},
             "tail": {"state": state[0], "conv": conv[0]}, "pos": 5}
    grown = Server._grow_cache(cache, 7)
    for key in ("k", "v"):
        assert grown["groups"][key].shape == (2, B, 12, 4, 16)
        assert bool((grown["groups"][key][:, :, 5:] == 0).all())
        assert torch.equal(grown["groups"][key][:, :, :5], kv)
    assert grown["groups"]["mamba"]["state"] is state
    assert grown["groups"]["mamba"]["conv"] is conv
    assert grown["tail"]["state"].shape == state[0].shape and grown["pos"] == 5
    assert Server._grow_cache({"tail": None, "pos": 3}, 2) == {"tail": None, "pos": 3}


# -- capture, imports ------------------------------------------------------------

def _dot_flops(module):
    return sum(scale * module.op_flops(comp, op)["mxu"]
               for op, comp, scale in module.walk_entry() if op.opcode == "dot")


def test_prefill_capture_dot_flops_match_the_reference():
    b, s = B, 256
    cfg = C.get(ARCH).smoke
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    port = Simulator().capture(lambda p, bt: prefill_step(model, p, bt), params,
                               {"tokens": torch.zeros(b, s, dtype=torch.long)}, name="prefill")
    ref = RefSimulator().capture_bundle(prefill_bundle(RC.RunConfig(
        model=RC.get(ARCH).smoke, shape=RC.ShapeConfig("p", s, b, "prefill"),
        mesh=RC.SMOKE_MESH)), name="prefill")
    assert _dot_flops(port.module) == _dot_flops(ref.module)


def test_train_capture_dot_flops_are_within_the_band_of_the_reference():
    """The smoke train step at b 1, s 1024 (two loss chunks, eight SSD
    chunks a layer).  Less the 2 attention products a shared-block
    application that the flash op's backward recomputes, the port counts
    at most the reference's dot FLOPs and at least 95% of them: the
    reference's XLA program computes the scan's first-chunk state gradient
    (its loop body is uniform), runs some multiply-and-reduce gradients of
    the scan as products, and recomputes the last Mamba2 layer of each group
    once more than PyTorch's checkpoint, which stops its recompute once the
    saved tensors are back (measured: 95.7%)."""
    b, s = 1, 1024
    rc = C.RunConfig(model=C.get(ARCH).smoke, shape=C.ShapeConfig("t", s, b, "train"),
                     mesh=C.SMOKE_MESH)
    port = _dot_flops(capture_bundle(train_bundle(rc), device="cpu").module)
    ref = _dot_flops(RefSimulator().capture_bundle(ref_train_bundle(RC.RunConfig(
        model=RC.get(ARCH).smoke, shape=RC.ShapeConfig("t", s, b, "train"),
        mesh=RC.SMOKE_MESH))).module)
    cfg = rc.model
    att = 2 * b * cfg.num_heads * s * s * cfg.resolved_head_dim
    groups = cfg.num_layers // cfg.attn_every
    mine = port - groups * 2 * att
    assert 0.95 * ref <= mine <= ref


def test_new_modules_import_with_jax_and_repro_blocked():
    mods = ["repro_torch.models.ssm", "repro_torch.models.hybrid",
            "repro_torch.configs.zamba2_7b"]
    script = ("import importlib, sys\n"
              "sys.modules['jax'] = None\nsys.modules['repro'] = None\n"
              f"for m in {mods!r}:\n    importlib.import_module(m)\n"
              "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
