"""The port's sharding rules and mesh arithmetic against the reference's, on
the CPU, without a process group.

``logical_rules``, ``axes_to_pspec``, ``make_mesh_config``, ``shrink_to``
and ``fabric_spec`` are plain Python in both packages and must agree
exactly over a grid: the smoke, single-pod and multi-pod meshes (the last
with ``pod_role`` data and pipeline) x ``fsdp``, ``expert_parallel`` and
``sequence_parallel_decode``.  Every model's ``axes()`` tree,
``logical_overrides`` and decode cache axes must equal the reference's leaf
for leaf.  ``placements`` turns a spec into DTensor placements, one per mesh
dim; ``lc`` is the identity without ambient rules and on a plain tensor.
"""
import dataclasses
import itertools

import jax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro import config as RC
from repro.distributed import mesh as ref_mesh
from repro.distributed import sharding as ref_sharding
from repro.models import build_model as ref_build_model
from repro_torch import config as C
from repro_torch.distributed import mesh as port_mesh
from repro_torch.distributed import sharding
from repro_torch.models import build_model

MESHES = {"smoke": (C.SMOKE_MESH, RC.SMOKE_MESH),
          "single-pod": (C.SINGLE_POD_MESH, RC.SINGLE_POD_MESH),
          "multi-pod": (C.MULTI_POD_MESH, RC.MULTI_POD_MESH),
          "multi-pod-pipeline": (dataclasses.replace(C.MULTI_POD_MESH, pod_role="pipeline"),
                                 dataclasses.replace(RC.MULTI_POD_MESH, pod_role="pipeline"))}
KNOBS = list(itertools.product([True, False], repeat=3))     # fsdp, ep, sp-decode
LM_ARCHS = ["llama3-8b", "qwen1.5-4b", "gemma3-12b", "gemma3-27b", "qwen3-moe-30b-a3b",
            "dbrx-132b", "internvl2-2b", "zamba2-7b", "rwkv6-1.6b", "seamless-m4t-large-v2"]


def _knobs(fsdp, ep, spd):
    kw = dict(fsdp=fsdp, expert_parallel=ep, sequence_parallel_decode=spd)
    return C.ShardingConfig(**kw), RC.ShardingConfig(**kw)


def _axes_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _axes_leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: "fsdp%d-ep%d-spd%d" % k)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_logical_rules_match_reference(mesh, knobs):
    port_cfg, ref_cfg = MESHES[mesh]
    port_sh, ref_sh = _knobs(*knobs)
    assert sharding.logical_rules(port_cfg, port_sh) == \
        ref_sharding.logical_rules(ref_cfg, ref_sh)


@pytest.mark.parametrize("knobs", KNOBS[:2] + KNOBS[-2:], ids=lambda k: "fsdp%d-ep%d-spd%d" % k)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_axes_to_pspec_matches_reference_on_every_model_axis(mesh, knobs):
    """Every parameter's axes of every model, the activation and cache axes
    the models constrain, and made-up tuples that name one mesh axis
    twice."""
    port_cfg, ref_cfg = MESHES[mesh]
    port_sh, ref_sh = _knobs(*knobs)
    rules = sharding.logical_rules(port_cfg, port_sh)
    ref_rules = ref_sharding.logical_rules(ref_cfg, ref_sh)
    tuples = {("batch", "act_seq", "embed"), ("batch", "seq", "qkv"), ("batch", "act_seq", "vocab"),
              ("layers", "batch", "kv_seq", "kv_heads", "head_dim"), ("batch", None, "ssm_heads"),
              ("batch", "experts", None, "moe_ffn"), ("fsdp", "fsdp", "data"), ("batch", "batch"),
              ("experts", "experts", None), (), (None, None)}
    for arch in LM_ARCHS:
        tuples |= {a for _, a in _axes_leaves(build_model(C.get(arch).smoke).axes())}
    for axes in sorted(tuples, key=str):
        got = sharding.axes_to_pspec(axes, rules)
        assert isinstance(got, sharding.PartitionSpec)
        assert tuple(got) == tuple(ref_sharding.axes_to_pspec(axes, ref_rules)), axes


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_model_axes_trees_match_reference(arch):
    mine = dict(_axes_leaves(build_model(C.get(arch).smoke).axes()))
    ref = dict(_axes_leaves(ref_build_model(RC.get(arch).smoke).axes()))
    assert mine == ref


def test_lenet_axes_and_overrides_match_reference():
    from repro_torch.models.lenet import LeNet
    cfg, ref_cfg = C.get("lenet").smoke, RC.get("lenet").smoke
    model, ref = LeNet(cfg, device="cpu"), ref_build_model(ref_cfg)
    assert model.axes() == dict(ref.axes())
    assert model.logical_overrides(C.SINGLE_POD_MESH) == \
        ref.logical_overrides(RC.SINGLE_POD_MESH) == {}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_logical_overrides_match_reference(arch):
    for port_cfg, ref_cfg in MESHES.values():
        for full in (True, False):
            port = C.get(arch).full if full else C.get(arch).smoke
            ref = RC.get(arch).full if full else RC.get(arch).smoke
            assert build_model(port).logical_overrides(port_cfg) == \
                ref_build_model(ref).logical_overrides(ref_cfg)


@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-7b", "rwkv6-1.6b",
                                  "seamless-m4t-large-v2"])
def test_decode_state_specs_match_reference(arch):
    """The cache's shapes, dtypes and logical axes, and the token's; ``pos``
    is a 0-d int32 spec in both packages."""
    shape = C.ShapeConfig("d", 64, 4, "decode")
    cache, axes, tok, tok_axes = build_model(C.get(arch).smoke).decode_state_specs(shape)
    rcache, raxes, rtok, rtok_axes = ref_build_model(RC.get(arch).smoke).decode_state_specs(
        RC.ShapeConfig("d", 64, 4, "decode"))
    assert axes == raxes and tok_axes == rtok_axes
    flat = dict(_axes_leaves(cache))
    rflat = dict(_axes_leaves(rcache))
    assert set(flat) == set(rflat)
    for k, v in flat.items():
        if k.endswith("pos"):
            assert v.device.type == "meta"
        if v is not None:
            assert tuple(v.shape) == rflat[k].shape, k
            assert str(v.dtype).split(".")[-1] == str(rflat[k].dtype), k
    assert tuple(tok["token"].shape) == rtok["token"].shape


GRID = [(n, m, p) for n in (1, 2, 4, 6, 8, 16, 64, 256, 512) for m in (1, 2, 4, 16)
        for p in (1, 2)]


@pytest.mark.parametrize("n,m,p", GRID)
def test_make_mesh_config_matches_reference(n, m, p):
    try:
        want = ref_mesh.make_mesh_config(n, m, p)
    except ValueError as e:
        with pytest.raises(ValueError, match="not divisible"):
            port_mesh.make_mesh_config(n, m, p)
        assert "not divisible" in str(e)
        return
    got = port_mesh.make_mesh_config(n, m, p)
    assert (got.shape, got.axis_names) == (want.shape, want.axis_names)
    assert port_mesh.fabric_spec(got) == ref_mesh.fabric_spec(want)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_shrink_to_and_fabric_spec_match_reference(mesh):
    port_cfg, ref_cfg = MESHES[mesh]
    assert port_mesh.fabric_spec(port_cfg) == ref_mesh.fabric_spec(ref_cfg)
    for n in range(1, 520, 7):
        try:
            want = ref_mesh.shrink_to(ref_cfg, n)
        except ValueError:
            with pytest.raises(ValueError, match="model-parallel"):
                port_mesh.shrink_to(port_cfg, n)
            continue
        got = port_mesh.shrink_to(port_cfg, n)
        assert (got.shape, got.axis_names) == (want.shape, want.axis_names)
        assert port_mesh.fabric_spec(got) == ref_mesh.fabric_spec(want)


class _Mesh:
    """What ``placements`` reads of a DeviceMesh: its dim names and sizes."""

    def __init__(self, names, sizes):
        self.mesh_dim_names, self._sizes = names, sizes
        self.ndim = len(names)

    def size(self, i):
        return self._sizes[i]


def test_placements_shard_each_named_mesh_dim():
    mesh = _Mesh(("pod", "data", "model"), (2, 4, 2))
    P = sharding.PartitionSpec
    assert sharding.placements(P(), mesh) == (Replicate(),) * 3
    assert sharding.placements(P(None, "model"), mesh) == (Replicate(), Replicate(), Shard(1))
    assert sharding.placements(P(("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    # an axis the mesh lacks is left replicated
    assert sharding.placements(P("experts"), mesh) == (Replicate(),) * 3
    # a dim its axes do not divide stays whole
    assert sharding.even_placements((6, 4), P("data", "model"), mesh) == \
        (Replicate(), Replicate(), Shard(1))


def test_param_shardings_pair_the_mesh_with_each_leafs_placements():
    mesh = _Mesh(("data", "model"), (2, 2))
    rules = sharding.logical_rules(C.MeshConfig((2, 2), ("data", "model")), C.ShardingConfig())
    tree = sharding.param_shardings({"w": ("fsdp", "qkv"), "g": (None,)}, rules, mesh)
    assert tree == {"w": (mesh, (Shard(0), Shard(1))), "g": (mesh, (Replicate(), Replicate()))}


def test_lc_is_the_identity_without_rules_or_on_a_plain_tensor():
    x = torch.randn(4, 8)
    assert sharding.lc(x, ("batch", "embed")) is x
    rules = sharding.logical_rules(C.SINGLE_POD_MESH, C.ShardingConfig())
    with sharding.use_rules(rules, _Mesh(("data", "model"), (16, 16))):
        assert sharding.rules_for() is rules
        assert sharding.lc(x, ("batch", "embed")) is x      # not a DTensor
    assert sharding.rules_for() is None and sharding.ambient_mesh() is None


def test_the_reference_keeps_its_jax_partition_spec():
    """The port's PartitionSpec is its own tuple type (no jax), equal entry
    for entry to the reference's."""
    spec = sharding.PartitionSpec("data", None, ("pod", "data"))
    assert tuple(spec) == tuple(jax.sharding.PartitionSpec("data", None, ("pod", "data")))
    assert "PartitionSpec" in repr(spec)
