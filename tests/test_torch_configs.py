"""The port's dense configs (qwen1.5-4b, gemma3-12b, gemma3-27b) against the
reference package's, on their smoke configs with the same weights.

As ``tests/test_torch_llama.py`` does for llama3-8b: one set of weights and
one token batch, made with numpy from a seed, go to both packages
(``params_from_jax``), in fp32 (the configs with ``dtype="float32"``); the
full forward's logits, the prefill's last-token logits and KV cache, and
one decode step after a prefill of s-1 tokens must agree within rtol 1e-4,
atol 1e-5 (sums in another order).  Lengths 16 and 40: the gemma3 smoke
window is 16, so at 40 a window layer and a global layer see different keys,
and the test shows that the window changes the output.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as RC
from repro.models import build_model as ref_build_model
from repro.models import param_count as ref_param_count
from repro_torch import config as C
from repro_torch.models import build_model, param_count
from repro_torch.models.transformer import params_from_jax
from repro_torch.runtime.server import Server
from repro_torch.runtime.steps import decode_step, prefill_step

ARCHS = ["qwen1.5-4b", "gemma3-12b", "gemma3-27b"]
B = 2


def _np_tree(specs, rng):
    """Weights in the reference's tree: unit-scale activations, random norm
    gains and biases (the reference initializes them to zero)."""
    if not isinstance(specs, dict):
        shape = specs.shape
        if specs.init == "zeros":
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        std = 0.5 if specs.init == "embed" else 1.0 / np.sqrt(shape[-2])
        return (std * rng.standard_normal(shape)).astype(np.float32)
    return {k: _np_tree(v, rng) for k, v in specs.items()}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference model, its params, port model, its params) in fp32."""
    arch = request.param
    ref_cfg = dataclasses.replace(RC.get(arch).smoke, dtype="float32")
    cfg = dataclasses.replace(C.get(arch).smoke, dtype="float32")
    ref_model = ref_build_model(ref_cfg)
    weights = _np_tree(ref_model.param_specs(), np.random.default_rng(0))
    ref_params = jax.tree.map(jnp.asarray, weights)
    return ref_model, ref_params, build_model(cfg), params_from_jax(weights, cfg)


def _tokens(s, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (B, s)).astype(np.int32)


def _close(mine, ref):
    mine = mine.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert mine.shape == ref.shape
    np.testing.assert_allclose(mine, ref, rtol=1e-4, atol=1e-5)


def _pad_cache(cache, extra):
    return {k: (jnp.pad(v, [(0, 0)] * 2 + [(0, extra)] + [(0, 0)] * 2)
                if k in ("k", "v") else v) for k, v in cache.items()}


@pytest.mark.parametrize("s", [16, 40])
def test_forward_matches_reference(pair, s):
    ref_model, ref_params, model, params = pair
    tokens = _tokens(s)
    want, _ = jax.jit(ref_model.forward)(ref_params, jnp.asarray(tokens))
    got, aux = model.forward(params, torch.from_numpy(tokens).long())
    assert float(aux) == 0.0
    _close(got, want)


@pytest.mark.parametrize("s", [16, 40])
def test_prefill_logits_and_cache_match_reference(pair, s):
    ref_model, ref_params, model, params = pair
    tokens = _tokens(s)
    want, want_cache = jax.jit(ref_model.prefill)(ref_params,
                                                  {"tokens": jnp.asarray(tokens)})
    got, cache = prefill_step(model, params, {"tokens": torch.from_numpy(tokens).long()})
    _close(got, want)
    for key in ("k", "v"):
        _close(cache[key], want_cache[key])
    assert cache["pos"].dtype == torch.int32 and cache["pos"].dim() == 0
    assert int(cache["pos"]) == int(want_cache["pos"]) == s


@pytest.mark.parametrize("s", [16, 40])
def test_decode_step_matches_reference_and_forward(pair, s):
    ref_model, ref_params, model, params = pair
    tokens = _tokens(s)
    _, ref_cache = jax.jit(ref_model.prefill)(
        ref_params, {"tokens": jnp.asarray(tokens[:, :s - 1])})
    want, _ = jax.jit(ref_model.decode_step)(
        ref_params, _pad_cache(ref_cache, 4), {"token": jnp.asarray(tokens[:, s - 1:])})
    tt = torch.from_numpy(tokens).long()
    _, cache = prefill_step(model, params, {"tokens": tt[:, :s - 1]})
    cache = Server._grow_cache(cache, 4)
    got, new_cache = decode_step(model, params, cache, {"token": tt[:, s - 1:]})
    assert int(new_cache["pos"]) == s
    _close(got, want)
    full, _ = model.forward(params, tt)
    _close(got[:, 0], full[:, -1].numpy())


@pytest.mark.parametrize("arch", ["gemma3-12b", "gemma3-27b"])
def test_window_layers_differ_from_global_ones_past_the_window(arch):
    """At s = 40 > window 16 the window layers see fewer keys than the
    global ones: dropping the window changes the logits past position 16,
    and leaves those before it as they were."""
    cfg = dataclasses.replace(C.get(arch).smoke, dtype="float32")
    assert 0 < cfg.window_size < 40 and cfg.global_every > 0
    model = build_model(cfg)
    windows = [model._window_for(i) for i in range(cfg.num_layers)]
    assert 0 in windows and cfg.window_size in windows
    params = params_from_jax(_np_tree(model.param_specs(), np.random.default_rng(0)), cfg)
    tokens = torch.from_numpy(_tokens(40)).long()
    windowed, _ = model.forward(params, tokens)
    unwindowed, _ = build_model(dataclasses.replace(cfg, window_size=0)).forward(params, tokens)
    w = cfg.window_size
    torch.testing.assert_close(windowed[:, :w], unwindowed[:, :w], rtol=1e-5, atol=1e-6)
    assert (windowed[:, w:] - unwindowed[:, w:]).abs().max() > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    """The same dims, source and accumulation steps as the reference's
    registry entry, and the same parameter count."""
    ref, port = RC.get(arch), C.get(arch)
    for name in ("full", "smoke"):
        assert dataclasses.asdict(getattr(port, name)) == dataclasses.asdict(getattr(ref, name))
    assert (port.source, port.accum_steps, port.shape_skips) == (
        ref.source, ref.accum_steps, ref.shape_skips)
    assert param_count(port.full) == ref_param_count(ref.full)
