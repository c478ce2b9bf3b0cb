"""The port's compiled steps (``runtime/jit.py``, ``StepBundle.jit``) and the
decode position on the device, against the reference, on the CPU.

One set of weights per family, made with numpy from a seed, goes to both
packages in fp32 (each smoke config with ``dtype="float32"``):

* the prefill's cache has the reference's tree, leaf for leaf, with
  ``pos`` a 0-d int32 tensor (the reference's int32 scalar array);
* the reference's ``prefill_bundle(...).jit()`` and ``decode_bundle(...).jit()``
  against the port's for a prefill and three decode steps: logits within
  rtol 1e-4, atol 1e-5 (as ``tests/test_torch_{llama,moe,hybrid,rwkv,encdec}.py``
  hold the models), the position advanced on the device;
* a proxy for what a CUDA graph needs, on the CPU: under a
  ``TorchDispatchMode`` the decode step of every family and LeNet's
  ``sgd_step`` dispatch no op that reads a device value on the host
  (``_local_scalar_dense``, ``nonzero``, ``masked_select``, ``unique``,
  ``bincount``, ``repeat_interleave`` with tensor repeats), and two decode
  steps at positions p and p + 1 dispatch the same ops with the same
  shapes and non-tensor arguments, which a replay of one capture needs;
* ``jit`` on CPU tensors is the step itself, and a donated argument gets
  the output of its structure written over it;
* the Server serves one batch, then another of another prompt length, then
  the first again from its own caches, as a fresh Server serves each.

The graphed step against the eager one on the card is in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 27.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from repro import config as RC
from repro.models import build_model as ref_build_model
from repro.runtime.server import Server as RefServer
from repro.runtime.steps import decode_bundle as ref_decode_bundle
from repro.runtime.steps import prefill_bundle as ref_prefill_bundle
from repro_torch import config as C
from repro_torch.models import build_model
from repro_torch.models.lenet import LeNet, sgd_step
from repro_torch.models.transformer import params_from_jax
from repro_torch.runtime.jit import Jitted, disable_jit, jit
from repro_torch.runtime.server import Server
from repro_torch.runtime.steps import decode_bundle, prefill_bundle

ARCHS = ["llama3-8b", "qwen3-moe-30b-a3b", "internvl2-2b", "zamba2-7b", "rwkv6-1.6b",
         "seamless-m4t-large-v2"]
B, S = 2, 16

#: ops that read a device value on the host (or size their output by one)
HOST_READS = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
              "aten.unique", "aten._unique", "aten.bincount",
              "aten.repeat_interleave.Tensor")


def _np_tree(specs, rng):
    """Weights in the reference's tree: unit-scale activations, random norm
    gains and biases."""
    if not isinstance(specs, dict):
        shape = specs.shape
        if specs.init in ("zeros", "ones"):
            base = 1.0 if specs.init == "ones" else 0.0
            return (base + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        std = 0.5 if specs.init == "embed" else 1.0 / np.sqrt(shape[-2])
        return (std * rng.standard_normal(shape)).astype(np.float32)
    return {k: _np_tree(v, rng) for k, v in specs.items()}


def _run_cfgs(arch):
    shape = ("p", S, B, "prefill")
    ref = RC.RunConfig(model=dataclasses.replace(RC.get(arch).smoke, dtype="float32"),
                       shape=RC.ShapeConfig(*shape), mesh=RC.SMOKE_MESH)
    port = C.RunConfig(model=dataclasses.replace(C.get(arch).smoke, dtype="float32"),
                       shape=C.ShapeConfig(*shape))
    return ref, port


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """(arch, reference run config, its params, port run config, its
    params, the reference's batch, the port's batch, tokens)."""
    arch = request.param
    ref_rc, rc = _run_cfgs(arch)
    rng = np.random.default_rng(0)
    weights = _np_tree(ref_build_model(ref_rc.model).param_specs(), rng)
    tokens = rng.integers(0, 256, (B, S + 3)).astype(np.int32)
    rb = {"tokens": jnp.asarray(tokens[:, :S])}
    pb = {"tokens": torch.from_numpy(tokens[:, :S]).long()}
    if rc.model.frontend != "none":
        front = rng.standard_normal((B, rc.model.frontend_seq, rc.model.d_model))
        rb["frontend_emb"] = jnp.asarray(front.astype(np.float32))
        pb["frontend_emb"] = torch.from_numpy(front.astype(np.float32))
    return (arch, ref_rc, jax.tree.map(jnp.asarray, weights), rc,
            params_from_jax(weights, rc.model), rb, pb, tokens)


def _close(mine, ref):
    np.testing.assert_allclose(mine.detach().float().numpy(), np.asarray(ref, np.float32),
                               rtol=1e-4, atol=1e-5)


def _same_tree(mine, ref):
    """The port's cache tree against the reference's: keys, leaf shapes and
    dtypes, and the position's value."""
    if isinstance(ref, dict):
        assert isinstance(mine, dict) and set(mine) == set(ref)
        for k in ref:
            _same_tree(mine[k], ref[k])
        return
    if ref is None:
        assert mine is None
        return
    assert isinstance(mine, torch.Tensor)
    assert tuple(mine.shape) == ref.shape
    assert str(mine.dtype).split(".")[-1] == str(ref.dtype)


def test_prefill_cache_has_the_reference_tree_with_pos_on_the_device(family):
    arch, ref_rc, ref_params, rc, params, rb, pb, _ = family
    _, ref_cache = ref_prefill_bundle(ref_rc).jit()(ref_params, rb)
    _, cache = prefill_bundle(rc).jit()(params, pb)
    _same_tree(cache, ref_cache)
    pos = cache["pos"]
    assert pos.dim() == 0 and pos.dtype == torch.int32 and pos.device == pb["tokens"].device
    assert int(pos) == int(ref_cache["pos"])


def test_compiled_prefill_and_three_decode_steps_match_the_reference(family):
    arch, ref_rc, ref_params, rc, params, rb, pb, tokens = family
    want, ref_cache = ref_prefill_bundle(ref_rc).jit()(ref_params, rb)
    got, cache = prefill_bundle(rc).jit()(params, pb)
    _close(got, want)
    ref_cache = RefServer._grow_cache(ref_cache, 3)
    cache = Server._grow_cache(cache, 3)
    ref_step, step = ref_decode_bundle(ref_rc).jit(), decode_bundle(rc).jit()
    start = int(cache["pos"])
    for i in range(3):
        tok = tokens[:, S + i:S + i + 1]
        want, ref_cache = ref_step(ref_params, ref_cache, {"token": jnp.asarray(tok)})
        got, cache = step(params, cache, {"token": torch.from_numpy(tok).long()})
        _close(got, want)
        assert cache["pos"].dim() == 0 and int(cache["pos"]) == start + i + 1
        assert int(cache["pos"]) == int(ref_cache["pos"])


class _Ops(TorchDispatchMode):
    """Records every dispatched op with its tensors' shapes and dtypes and
    its other arguments."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        desc = tree_map(lambda a: ("T", tuple(a.shape), a.dtype)
                        if isinstance(a, torch.Tensor) else repr(a), (args, kwargs))
        self.ops.append((str(func), desc))
        return func(*args, **kwargs)

    def host_reads(self):
        return sorted({f for f, _ in self.ops if f.startswith(HOST_READS)})


def test_decode_steps_are_graph_safe(family):
    """No host read of a device value, and one op sequence at p and p + 1."""
    arch, _, _, rc, params, _, pb, tokens = family
    _, cache = prefill_bundle(rc).fn(params, pb)
    cache = Server._grow_cache(cache, 3)
    step = decode_bundle(rc).fn
    runs = []
    for i in range(2):
        with _Ops() as ops:
            _, cache = step(params, cache, {"token": torch.from_numpy(
                tokens[:, S + i:S + i + 1]).long()})
        assert ops.host_reads() == [], (arch, ops.host_reads())
        runs.append(ops.ops)
    assert len(runs[0]) > 0 and runs[0] == runs[1]


def test_lenet_sgd_step_is_graph_safe():
    cfg = C.get("lenet").full
    model = LeNet(cfg, conv_algo="gemm", device="cpu", seed=0)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.standard_normal(
        (8, cfg.image_hw, cfg.image_hw, cfg.image_c)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, cfg.num_classes, 8)).long()
    params = model.param_dict()
    runs = []
    for _ in range(2):
        with _Ops() as ops:
            params, loss, acc = sgd_step(model, params, images, labels, 0.05)
        assert ops.host_reads() == []
        runs.append(ops.ops)
    assert len(runs[0]) > 0 and runs[0] == runs[1]


def test_jit_on_the_cpu_is_the_step_itself():
    calls = []

    def fn(x, y, scale):
        calls.append(x)
        return x * scale + y, {"n": y.sum()}

    x, y = torch.arange(4.0), torch.ones(4)
    step = jit(fn, donate=(1,))
    got = step(x, y, 2.0)
    want = fn(x, y, 2.0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1]["n"], want[1]["n"])
    assert calls[0] is x and step.graphs == {}
    with disable_jit():
        assert torch.equal(step(x, y, 3.0)[0], x * 3.0 + y)
    assert torch.equal(y, torch.ones(4))          # eager: nothing written over y


def test_a_donated_argument_gets_the_output_of_its_structure():
    """What the graph does at its end (here on CPU tensors): the advanced
    cache is written over the donated one, leaf by leaf, where it is not
    already there (k, updated in place); two leaves of one shape keep
    their places; the other outputs stay the step's own."""
    k = torch.zeros(2, 3)
    cache = {"k": k, "a": torch.zeros(4), "b": torch.ones(4), "pos": torch.tensor(5)}
    new = {"k": k, "a": torch.full((4,), 7.0), "b": torch.full((4,), 8.0),
           "pos": cache["pos"] + 1}
    logits = torch.randn(2, 5)
    out = Jitted(lambda *a: None, donate=(1,))._write_donated(
        (None, cache, {"token": torch.zeros(2)}), (logits, new))
    assert out[0] is logits and out[1]["k"] is k
    for key in ("a", "b", "pos"):
        assert out[1][key] is cache[key]
    assert torch.equal(cache["a"], torch.full((4,), 7.0))
    assert torch.equal(cache["b"], torch.full((4,), 8.0)) and int(cache["pos"]) == 6
    whole = Jitted(lambda *a: None, donate=(0,))._write_donated(
        ({"w": torch.zeros(3)},), {"w": torch.ones(3)})
    assert torch.equal(whole["w"], torch.ones(3))


@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-7b"])
def test_server_reuses_its_caches_across_prompt_lengths(arch):
    """Three requests through one Server (the second at another prompt
    length, the third the first again) give what a fresh Server gives each:
    the server's own caches are filled anew, not carried over."""
    _, rc = _run_cfgs(arch)
    model = build_model(rc.model)
    params = model.init(seed=0, device="cpu")
    rng = np.random.default_rng(3)
    first = {"tokens": torch.from_numpy(rng.integers(0, 256, (B, S))).long()}
    second = {"tokens": torch.from_numpy(rng.integers(0, 256, (B, S + 5))).long()}
    server = Server(rc, params)
    outs = [server.generate(b, max_new_tokens=4) for b in (first, second, first)]
    for b, got in zip((first, second, first), outs):
        np.testing.assert_array_equal(got, Server(rc, params).generate(b, max_new_tokens=4))
    assert len(server._caches) == 2
