"""kubeai_tpu_torch.parallel.mesh and .sharding against kubeai_tpu.parallel,
in one process: the topology parser, MeshConfig, the sharding rules, each
family's param_specs and quantized_specs, and `shard_params`, whose
shard on rank r must equal the block a JAX NamedSharding of the same spec
places on device r of a `build_mesh(MeshConfig(tp=n))` mesh over the
virtual CPU devices, for every leaf of tiny llama, qwen2 (q/k/v biases),
int8-quantized llama and mixtral at tp = 2 and 4.

The port's meshes here are DeviceMeshes over torch's "fake" process-group
backend (torch.testing), which gives one process any rank of any world
size; no collective runs. The multi-process engines are in
tests/test_torch_tp.py."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from kubeai_tpu.engine import quantization as jq
from kubeai_tpu.models import llama as jl
from kubeai_tpu.models import mixtral as jm
from kubeai_tpu.parallel import mesh as jmesh
from kubeai_tpu.parallel import sharding as jsh
from kubeai_tpu_torch.engine import quantization as tq
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.models import mixtral as tm
from kubeai_tpu_torch.parallel import mesh as tmesh
from kubeai_tpu_torch.parallel import sharding as tsh
from kubeai_tpu_torch.parity import MIXTRAL_EXPERT_MINOR, params_from_numpy


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs thousands of tiny ops: one intra-op thread
    keeps them from spinning against the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def fake_world(size: int, rank: int = 0):
    """A process group of `size` ranks in which this process is `rank`."""
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---- mesh ------------------------------------------------------------------


@pytest.mark.parametrize("topology", ["1x1", "2x2", "2x4", "4x4", "2x2x4", "8"])
def test_parse_topology_matches_jax(topology):
    assert tmesh.parse_topology(topology) == jmesh.parse_topology(topology)
    assert tmesh.topology_num_chips(topology) == jmesh.topology_num_chips(topology)


@pytest.mark.parametrize("topology", ["", "2x", "x2", "2*2", "v5e-2x2"])
def test_parse_topology_refuses_as_jax(topology):
    with pytest.raises(ValueError, match="invalid TPU topology"):
        jmesh.parse_topology(topology)
    with pytest.raises(ValueError, match="invalid TPU topology"):
        tmesh.parse_topology(topology)


@pytest.mark.parametrize("kw", [{}, dict(tp=4), dict(dp=2, tp=4), dict(pp=2, sp=2, tp=2)])
def test_mesh_config_matches_jax(kw):
    t, j = tmesh.MeshConfig(**kw), jmesh.MeshConfig(**kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.num_devices == j.num_devices and t.axis_sizes() == j.axis_sizes()
    assert tmesh.MESH_AXES == jmesh.MESH_AXES
    for name in ("AXIS_DATA", "AXIS_PIPELINE", "AXIS_TENSOR", "AXIS_SEQ", "AXIS_EXPERT"):
        assert getattr(tmesh, name) == getattr(jmesh, name)


@pytest.mark.parametrize("kw", [dict(tp=4), dict(dp=2, tp=2), dict(pp=2, sp=2)])
def test_build_mesh_shape_matches_jax(devices8, kw):
    cfg = tmesh.MeshConfig(**kw)
    jm_ = jmesh.build_mesh(jmesh.MeshConfig(**kw), devices=devices8[:cfg.num_devices])
    with fake_world(cfg.num_devices):
        m = tmesh.build_mesh(cfg)
        assert m.mesh_dim_names == tuple(jm_.shape)
        assert tuple(m.shape) == tuple(jm_.shape.values())
        assert m.device_type == "cpu"
        for axis in tmesh.MESH_AXES:
            assert tmesh.axis_size(m, axis) == jm_.shape[axis]
    assert tmesh.axis_size(None, "tp") == 1


def test_build_mesh_refuses_a_wrong_world_as_jax(devices8):
    with pytest.raises(ValueError, match="needs 2 devices, got 4"):
        jmesh.build_mesh(jmesh.MeshConfig(tp=2), devices=devices8[:4])
    with fake_world(4):
        with pytest.raises(ValueError, match="needs 2 devices, got 4"):
            tmesh.build_mesh(tmesh.MeshConfig(tp=2))
    with pytest.raises(RuntimeError, match="initialised process group"):
        tmesh.build_mesh(tmesh.MeshConfig())


@pytest.mark.parametrize("topology,kw", [("2x2", {}), ("2x4", dict(tp=4)), ("2x2", dict(sp=2))])
def test_mesh_from_topology_matches_jax(devices8, topology, kw):
    n = jmesh.topology_num_chips(topology)
    jm_ = jmesh.mesh_from_topology(topology, devices=devices8[:n], **kw)
    with fake_world(n):
        m = tmesh.mesh_from_topology(topology, **kw)
        assert dict(zip(m.mesh_dim_names, m.shape)) == dict(jm_.shape)
    with fake_world(1):
        assert tuple(tmesh.single_device_mesh().shape) == (1, 1, 1, 1)


# ---- sharding rules and specs ----------------------------------------------


def test_sharding_rules_match_jax():
    assert tsh.ShardingRules().rules == jsh.ShardingRules().rules
    for name in ("BATCH", "LAYERS", "SEQUENCE", "VOCAB", "EMBED", "HEADS", "KV_HEADS",
                 "HEAD_DIM", "MLP", "EXPERT", "KV_SLOTS", "LORA_RANK"):
        assert getattr(tsh, name) == getattr(jsh, name)
    for axes in [(tsh.LAYERS, tsh.EMBED, tsh.HEADS), (tsh.VOCAB, tsh.EMBED),
                 (None, tsh.EXPERT, None, tsh.EMBED), (tsh.BATCH, tsh.SEQUENCE)]:
        assert tsh.logical_to_physical(axes) == tuple(jsh.logical_to_physical(axes))
    with pytest.raises(KeyError):
        tsh.ShardingRules().physical("nope")
    rep = tsh.DEFAULT_RULES.replicating(tsh.KV_HEADS)
    assert rep.physical(tsh.KV_HEADS) is None and rep.physical(tsh.HEADS) == "tp"


def _expert_minor(specs: dict) -> dict:
    """A JAX mixtral spec tree with the gate and up axes swapped as the
    port stores the stacks."""
    layers = dict(specs["layers"])
    for name in MIXTRAL_EXPERT_MINOR:
        a = layers[name]
        layers[name] = (a[0], a[2], a[1], *a[3:])
    return {**specs, "layers": layers}


@pytest.mark.parametrize("family", ["llama", "qwen", "mixtral"])
def test_param_specs_match_jax(family):
    if family == "mixtral":
        want = _expert_minor(jm.param_specs(jm.MixtralConfig.tiny()))
        assert tm.param_specs(tm.MixtralConfig.tiny()) == want
        return
    bias = family == "qwen"
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), attention_bias=bias)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(), attention_bias=bias)
    assert tl.param_specs(tcfg) == jl.param_specs(jcfg)


def test_quantized_specs_match_jax():
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32)
    jtree = jq.quantize_params(jl.init_params(jcfg, jax.random.PRNGKey(0)))
    want = jq.quantized_specs(jl.param_specs(jcfg), jtree["layers"])
    tparams = tq.quantize_params(params_from_numpy(jax.tree.map(np.asarray, jtree)))
    got = tq.quantized_specs(tl.param_specs(tl.LlamaConfig.tiny()), tparams["layers"])
    assert got == want
    assert got["layers"]["wo"] == {"w8": (tsh.LAYERS, tsh.HEADS, tsh.EMBED),
                                   "scale": (tsh.LAYERS, None, tsh.EMBED)}


# ---- shard_params ----------------------------------------------------------


def _trees(model: str):
    """(JAX param tree, its logical specs, the port's param dict, the
    port's specs) in f32."""
    if model == "mixtral":
        jcfg = dataclasses.replace(jm.MixtralConfig.tiny(), dtype=jnp.float32)
        jtree = jm.init_params(jcfg, jax.random.PRNGKey(2))
        tparams = params_from_numpy(jax.tree.map(np.asarray, jtree))
        return jtree, jm.param_specs(jcfg), tparams, tm.param_specs(tm.MixtralConfig.tiny())
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32,
                               attention_bias=model == "qwen")
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(), attention_bias=model == "qwen")
    tree = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(2)))
    if model == "qwen":
        rng = np.random.default_rng(2)
        for b in ("bq", "bk", "bv"):
            tree["layers"][b] = rng.standard_normal(tree["layers"][b].shape).astype(np.float32)
    jtree = jax.tree.map(jnp.asarray, tree)
    jspecs, tspecs = jl.param_specs(jcfg), tl.param_specs(tcfg)
    tparams = params_from_numpy(tree)
    if model == "int8":
        jtree = jq.quantize_params(jtree)
        jspecs = jq.quantized_specs(jspecs, jtree["layers"])
        tparams = tq.quantize_params(params_from_numpy(jax.tree.map(np.asarray, jtree)))
        tspecs = tq.quantized_specs(tspecs, tparams["layers"])
    return jtree, jspecs, tparams, tspecs


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("model", ["llama", "qwen", "int8", "mixtral"])
def test_shard_params_equals_jax_named_sharding(devices8, model, tp):
    jtree, jspecs, tparams, tspecs = _trees(model)
    jmesh_ = jmesh.build_mesh(jmesh.MeshConfig(tp=tp), devices=devices8[:tp])
    is_spec = lambda x: isinstance(x, tuple)  # noqa: E731
    placed = jax.tree.map(
        lambda x, axes: jax.device_put(x, jsh.named_sharding(jmesh_, axes)),
        jtree, jspecs, is_leaf=is_spec)
    jleaves = dict(_leaves(placed))
    for rank in range(tp):
        with fake_world(tp, rank):
            shard = tsh.shard_params(tparams, tspecs, tmesh.build_mesh(tmesh.MeshConfig(tp=tp)))
        device = devices8[rank]
        for path, got in _leaves(shard):
            arr = jleaves[path]
            want = next(s.data for s in arr.addressable_shards if s.device == device)
            want = np.asarray(want)
            if model == "mixtral" and path.split("/")[-1] in MIXTRAL_EXPERT_MINOR:
                want = np.swapaxes(want, 1, 2)
            assert got.is_contiguous(), path
            assert tuple(got.shape) == want.shape, (path, rank)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{path} rank {rank}")
    # A cut that does not divide its axis raises (JAX would pad the last block).
    with fake_world(tp):
        with pytest.raises(ValueError, match="does not divide"):
            tsh.shard_leaf(torch.zeros(3, 5), (None, "tp"),
                           tmesh.build_mesh(tmesh.MeshConfig(tp=tp)))


def test_shard_params_keeps_a_tied_head_one_tensor():
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), tie_word_embeddings=True)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with fake_world(2, 1):
        shard = tsh.shard_params(params, tl.param_specs(cfg),
                                 tmesh.build_mesh(tmesh.MeshConfig(tp=2)))
    assert shard["lm_head"] is shard["embed"]
    assert torch.equal(shard["embed"], params["embed"][256:])
