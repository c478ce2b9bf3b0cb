"""The port's distributed layer against the reference's, on the CPU.

The multi-rank cases run four gloo ranks, one process each
(``tests/torch_dist_cases.py``), each case in a subprocess with a timeout of
its own (and each rank's process group with one), so nothing can hang the
suite:

* int8 compression: ``quantize_int8`` bit-exact with the reference's; the
  ``compressed_psum_mean`` of four ranks within ``max|x|/127`` of the exact
  mean and within 1e-6 of the reference's own, computed by its shard_map on
  a 4-device host platform;
* ``pipeline_apply`` at S = 4, M = 6, b = 2, d = 8 equal to the sequential
  stage math (rtol/atol 2e-5), forward and gradient;
* one llama3-8b smoke train step on a (2, 2) data x model mesh with fsdp, in
  fp32, from the reference's state (``state_from_jax``): the loss and metrics
  within 1e-5 (rtol), the new params and master within 2e-5 and m and v
  within 1e-5 of each tensor's largest magnitude, as the unsharded step is
  held in ``tests/test_torch_train.py``;
* one smoke train step of the MoE and hybrid families on that mesh
  against the same step without one, in fp32 and in float64: the loss
  within 1e-5 (rtol), the grad norm and the new first moments (the clipped
  gradients, scaled) within 1e-3 of each tensor's largest magnitude in
  fp32 and within 2e-5 in float64.  The router's and the Mamba2 conv's run
  on each rank's rows, and their gradients are sums over the ranks that
  split the rows (read as replicated, they were off by 0.86 and 1.04 of
  their scale).  zamba2's fp32 gradients read 2e-4 off, rounding that the
  smoke net amplifies (in float64 they agree to 2e-13).  zamba2 also on
  (4, 1) and (1, 4), where its 2 SSM heads do not divide the model axis;
* ``init_train_state`` on the mesh: the plain init's weights, each leaf
  sharded as it is drawn; the sharded state's checkpoint bytes
  (``faults.pricing.tree_nbytes``) the whole state's;
* prefill and three decode steps on that mesh (zamba2 also on (1, 4))
  against the same steps without one (rtol 1e-4, atol 1e-5);
* a sharded state saved by rank 0 alone, one shard at a time: the other
  ranks make no new tensor, rank 0 none of a sharded leaf's full size but
  its host copies, and the state restores resharded, each shard in a
  storage of its own;
* ``Trainer(use_mesh=True)`` with a failure that loses 2 of the 4 ranks:
  one restart, resumed on a (1, 2) mesh from the resharded checkpoint.
"""
import dataclasses
import math
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
from repro.distributed.compression import quantize_int8 as ref_quantize_int8
from repro.models import build_model as ref_build_model
from repro.optim import TrainState as RefTrainState
from repro.runtime.steps import train_bundle as ref_train_bundle
from repro_torch import config as C
from repro_torch.checkpoint.store import list_steps
from repro_torch.distributed.compression import dequantize_int8, quantize_int8

ROOT = Path(__file__).resolve().parents[1]
CASES = ROOT / "tests" / "torch_dist_cases.py"
ARCH = "llama3-8b"
TRAIN = dict(warmup_steps=2, total_steps=10, learning_rate=1e-2)


def _run_case(case, tmp_path, **inputs):
    np.savez(tmp_path / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, str(CASES), case, str(tmp_path)],
                         capture_output=True, text=True, timeout=240, env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return torch.load(tmp_path / "out.pt", weights_only=False)


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


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


# -- compression -------------------------------------------------------------

@pytest.mark.parametrize("scale", [1e-3, 1.0, 3.0, 1e4])
def test_quantize_int8_is_bit_exact_with_the_reference(scale):
    x = (np.random.default_rng(0).standard_normal(4099) * scale).astype(np.float32)
    x[:5] = [0.0, scale, -scale, 0.5 * scale, 1.5 * scale]   # halfway cases round to even
    q, s = quantize_int8(torch.from_numpy(x))
    rq, rs = ref_quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    err = (dequantize_int8(q, s) - torch.from_numpy(x)).abs().max()
    assert float(err) <= float(np.abs(x).max()) / 127.0 + 1e-6


REF_PSUM = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.sharding import PartitionSpec as P
from repro.distributed._compat import shard_map
from repro.distributed.compression import compressed_psum_mean
xs = np.load(sys.argv[1])
mesh = jax.make_mesh((4,), ("data",))
out = shard_map(lambda x: compressed_psum_mean(x, "data"), mesh=mesh, in_specs=P("data"),
                out_specs=P("data"), check_vma=False)(xs)
np.save(sys.argv[2], np.asarray(out))
"""


def test_compressed_psum_mean_matches_the_exact_mean_and_the_reference(tmp_path):
    xs = np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32)
    np.save(tmp_path / "xs.npy", xs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", REF_PSUM, str(tmp_path / "xs.npy"),
                          str(tmp_path / "ref.npy")], capture_output=True, text=True,
                         timeout=240, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    ref = np.load(tmp_path / "ref.npy")
    got = _run_case("compression", tmp_path, xs=xs)
    out = got["out"].numpy()
    exact = np.broadcast_to(xs.mean(0, keepdims=True), xs.shape)
    assert np.abs(out - exact).max() <= np.abs(xs).max() / 127.0 + 1e-6
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    # compressed_grad_mean: without residuals the same mean; with error
    # feedback the mean of gradient plus residual, and the residual it
    # leaves is what that mean missed
    assert got["no_errors"] and torch.equal(got["plain"], got["out"][0])
    assert torch.equal(got["with_feedback"], got["feedback_want"])
    assert torch.equal(got["new_err"], got["x_plus_resid"] - got["with_feedback"])


# -- pipeline ----------------------------------------------------------------

def test_pipeline_apply_equals_the_sequential_stages_and_their_gradient(tmp_path):
    """The stage math of ``tests/test_distributed.py``: tanh(x @ w_s) for s
    = 0..3 on each of 6 microbatches; the gradient of the outputs' sum
    against every stage's weights."""
    S, M, b, d = 4, 6, 2, 8
    rng = np.random.default_rng(1)
    ws = (rng.standard_normal((S, d, d)) * 0.3).astype(np.float32)
    x = rng.standard_normal((M, b, d)).astype(np.float32)
    got = _run_case("pipeline", tmp_path, ws=ws, x=x)
    wt = torch.from_numpy(ws).requires_grad_()
    ref = torch.from_numpy(x)
    for s in range(S):
        ref = torch.tanh(ref @ wt[s])
    grad, = torch.autograd.grad(ref.sum(), wt)
    assert got["same_on_every_rank"]
    np.testing.assert_allclose(got["out"].numpy(), ref.detach().numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got["grad"].numpy(), grad.numpy(), rtol=2e-5, atol=2e-5)


# -- the sharded steps -------------------------------------------------------

def test_sharded_train_step_matches_the_reference(tmp_path):
    b, s = 4, 32
    ref_cfg = dataclasses.replace(RC.get(ARCH).smoke, dtype="float32")
    ref_rc = RC.RunConfig(model=ref_cfg, shape=RC.ShapeConfig("t", s, b, "train"),
                          mesh=RC.SMOKE_MESH, train=RC.TrainConfig(**TRAIN))
    rng = np.random.default_rng(3)
    w = _np_tree(ref_build_model(ref_cfg).param_specs(), rng)
    m = jax.tree.map(lambda a: (1e-2 * rng.standard_normal(a.shape)).astype(np.float32), w)
    v = jax.tree.map(lambda a: (1e-4 * rng.random(a.shape)).astype(np.float32), w)
    tok = rng.integers(0, ref_cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    ref_state = RefTrainState(jnp.int32(3), *(jax.tree.map(jnp.asarray, t)
                                              for t in (w, w, m, v)))
    ref_new, ref_m = jax.jit(ref_train_bundle(ref_rc).fn)(
        ref_state, {k: jnp.asarray(x) for k, x in batch.items()})
    got = _run_case("train", tmp_path, b=b, s=s, step=np.int32(3), **batch,
                    **_flat(w, "params"), **_flat(w, "master"), **_flat(m, "m"),
                    **_flat(v, "v"))
    assert got["sharded"] == [True, True]
    assert got["step"] == int(ref_new.step) == 4
    for key in ("loss", "ce", "grad_norm"):
        assert math.isclose(got["metrics"][key], float(ref_m[key]), rel_tol=1e-5), key
    assert math.isclose(got["metrics"]["lr"], float(ref_m["lr"]), rel_tol=1e-6)
    for name, tol in (("params", 2e-5), ("master", 2e-5), ("m", 1e-5), ("v", 1e-5)):
        ref_leaves = dict(_leaves(jax.tree.map(np.asarray, getattr(ref_new, name))))
        for path, leaf in _leaves(got[name]):
            ref = ref_leaves[path]
            err = np.abs(leaf.numpy() - ref).max() / max(np.abs(ref).max(), 1e-30)
            assert err <= tol, (name, path, err)


def _check_family_step(got):
    """The sharded step against the plain one: in fp32 the metrics and the
    first moments within 1e-3, in float64 (where run) within 2e-5 (the
    tolerance the llama3-8b step holds its params to)."""
    for prec, tol in (("fp32", 1e-3), ("fp64", 2e-5)):
        if prec not in got:
            continue
        run = got[prec]
        for key in ("loss", "ce"):
            assert math.isclose(run["metrics"][key], run["want_metrics"][key],
                                rel_tol=1e-5), (prec, key)
        assert math.isclose(run["metrics"]["grad_norm"], run["want_metrics"]["grad_norm"],
                            rel_tol=tol), prec
        want = dict(_leaves(run["want_m"]))
        for path, leaf in _leaves(run["m"]):
            ref = want[path]
            err = float((leaf - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
            assert err <= tol, (prec, path, err)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "zamba2-7b"])
def test_sharded_train_step_of_a_family_matches_the_unsharded_one(tmp_path, arch):
    """In fp32 the zamba2 smoke step's gradients read up to 2e-4 of their
    scale off the plain step's, and the plain fp32 step is itself 4.6e-4
    off the same step in float64: the smoke net amplifies rounding (a 1e-7
    relative change of its weights moves its gradients 1e-4).  In float64
    the sharded step agrees to 2e-13 (``scripts/zamba2_rounding.py``), so
    the fp32 bound is the rounding's and the float64 one holds the
    program."""
    fp64 = arch == "zamba2-7b"
    got = _run_case("train_family", tmp_path, arch=np.array(arch), fp64=np.array(fp64))
    assert ("fp64" in got) == fp64
    _check_family_step(got)


@pytest.mark.parametrize("mesh", [(4, 1), (1, 4)])
def test_sharded_train_step_of_zamba2_on_other_meshes(tmp_path, mesh):
    """All data and all model ranks: on (1, 4) the model axis splits the
    channels of 2 SSM heads over 4 ranks, which the heads' view gathers
    first (forward and backward)."""
    got = _run_case("train_family", tmp_path, arch=np.array("zamba2-7b"), mesh=np.array(mesh),
                    fp64=np.array(True))
    assert "fp64" in got
    _check_family_step(got)


def test_init_on_a_mesh_draws_the_plain_weights_one_leaf_at_a_time(tmp_path):
    got = _run_case("init", tmp_path)
    assert any(got["sharded"]), "the fsdp state has no sharded leaf"
    for path, leaf in _leaves(got["params"]):
        want = dict(_leaves(got["want"]))[path]
        assert torch.equal(leaf, want), path
    for path, leaf in _leaves(got["master"]):
        assert torch.equal(leaf, dict(_leaves(got["want"]))[path].float()), path
    # when each leaf is drawn, no earlier draw is alive but those the rank
    # keeps whole as its own shard (its replicated leaves)
    kept = set(got["kept"])
    assert got["n_draws"] == len(got["sharded"])
    assert len(kept) < got["n_draws"]
    for i, live in enumerate(got["live_at_draw"]):
        assert set(live) <= kept, (i, sorted(set(live) - kept))


@pytest.mark.parametrize("arch", [ARCH, "qwen3-moe-30b-a3b", "internvl2-2b",
                                  "seamless-m4t-large-v2", "zamba2-7b", "rwkv6-1.6b"])
def test_sharded_prefill_and_decode_match_the_unsharded_steps(tmp_path, arch):
    """Dense, MoE (routing, dispatch and combine on each rank's rows, the
    experts under local_map), a frontend, the encoder-decoder's
    cross-attention and the two scans (each rank's rows and heads): the
    logits of prefill and three decode steps, and the whole cache, on the
    (2, 2) mesh against the same steps without one."""
    _check_serve(tmp_path, arch)


def _check_serve(tmp_path, arch, mesh=(2, 2), batch=4):
    cfg = dataclasses.replace(C.get(arch).smoke, dtype="float32")
    from repro_torch.models import build_model
    rng = np.random.default_rng(5)
    w = _np_tree(build_model(cfg).param_specs(), rng)
    tokens = rng.integers(0, cfg.vocab_size, (batch, 16)).astype(np.int64)
    extra = {}
    if cfg.frontend != "none":
        extra["frontend_emb"] = rng.standard_normal((batch, cfg.frontend_seq, cfg.d_model)
                                                    ).astype(np.float32)
    got = _run_case("serve", tmp_path, arch=np.array(arch), tokens=tokens, mesh=np.array(mesh),
                    **extra, **_flat(w, "params"))
    np.testing.assert_allclose(got["got"].numpy(), got["want"].numpy(), rtol=1e-4, atol=1e-5)
    cache, want = dict(_leaves(got["cache"])), dict(_leaves(got["cache_want"]))
    assert set(cache) == set(want)
    for path, leaf in cache.items():
        if isinstance(leaf, torch.Tensor):
            np.testing.assert_allclose(leaf.numpy(), want[path].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=path)
        else:
            assert leaf == want[path], path


def test_a_batch_the_mesh_cannot_split_serves_as_without_a_mesh(tmp_path):
    """Batch 1 on (2, 2): the rules keep the batch whole (and put
    ``kv_seq`` on ``data``, as the reference's do for long_500k); prefill
    and three decode steps, the position on the device, against the same
    steps without a mesh."""
    _check_serve(tmp_path, ARCH, batch=1)


def test_the_decode_write_lands_on_the_rank_that_holds_the_position(tmp_path):
    """The decode step's write of one position into a DTensor K/V cache
    (``attention._write_row``) on the (2, 2) mesh, the cache split over
    positions (long_500k's ``kv_seq`` on ``data``), over batch rows, over
    heads, or whole, at the first, a middle and the last position: the
    whole cache equals the plain write's."""
    got = _run_case("cache_write", tmp_path)
    assert got["checked"] == 12 and got["bad"] == []


def test_tree_nbytes_of_a_sharded_state_counts_each_leaf_whole(tmp_path):
    """The bytes a checkpoint of the sharded state holds (rank 0 writes each
    leaf whole): the plain state's, not the rank's shards'."""
    got = _run_case("init", tmp_path)
    assert got["nbytes"] == got["nbytes_plain"] > got["local_nbytes"] > 0


def test_zamba2_serves_on_a_mesh_whose_model_axis_its_heads_do_not_divide(tmp_path):
    """zamba2's smoke config on a (1, 4) mesh: 2 SSM heads over 4 model
    ranks; prefill and three decode steps against the same steps without
    one, as on (2, 2)."""
    _check_serve(tmp_path, "zamba2-7b", mesh=(1, 4))


def test_sharded_save_holds_no_leaf_whole_on_the_device(tmp_path):
    from repro_torch.checkpoint.store import _flatten, restore
    got = _run_case("save", tmp_path, dir=np.array(str(tmp_path / "ckpt")))
    largest_shard = max(got["local_bytes"])
    sharded = set(got["sharded_shapes"])
    assert sharded, "the fsdp state has no sharded leaf"
    for rank, sizes in enumerate(got["sizes"]):
        if rank:
            # a rank that does not write sends its own shards as they are
            assert sizes == [], (rank, sorted(sizes)[-3:])
        else:
            # rank 0: one host copy a leaf, and one other rank's shard at a time
            whole = [shape for n, shape in sizes if n > largest_shard or shape in sharded]
            assert all(s in got["full_shapes"] for s in whole), whole
            assert len(whole) <= got["n_leaves"]
    assert got["same"] and got["same_layout"] and got["own_storage"]
    # what rank 0 wrote is the state whole
    saved = restore(str(tmp_path / "ckpt"), 1, got["whole"])
    for (path, a), (_, b) in zip(_flatten(saved), _flatten(got["whole"]), strict=True):
        assert torch.equal(a, b), path


def test_trainer_on_a_mesh_restarts_on_the_ranks_left(tmp_path):
    ckpt = tmp_path / "ckpt"
    got = _run_case("trainer", tmp_path, ckpt_dir=np.array(str(ckpt)))
    reports = got["reports"]
    assert all(r["restarts"] == 1 for r in reports)
    # ranks 0 and 1: steps 0-2, the failure at 3, steps 2-5 again from the
    # step-2 checkpoint; ranks 2 and 3 left at the restart
    for r in reports[:2]:
        assert r["steps_done"] == 3 + 4 and len(r["losses"]) == 7
        assert math.isfinite(r["final_loss"])
    for r in reports[2:]:
        assert r["steps_done"] == 3
    # both ranks of the new mesh report the one (replicated) loss
    assert reports[0]["losses"] == reports[1]["losses"]
    assert list_steps(str(ckpt))[-1] == 6
