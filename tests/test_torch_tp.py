"""Tensor and expert parallelism of the port against the JAX engine, over
gloo ranks on the CPU.

Worlds of 2 and 4 ranks are spawned once for the module (spawn start
method, `file://` rendezvous under tmp_path, gloo with a timeout; the
ranks run tests/torch_tp_ranks.py, which never imports JAX). In each
world every rank builds `Engine(..., mesh=build_mesh(MeshConfig(tp=n)))`
for tiny llama (at tp=4 its 2 KV heads are each held by two ranks), qwen2
with q/k/v biases, llama on int8 weights, llama on int8 pools and
mixtral (its 4 experts over the tp ranks), in the per_layer and fused
layouts, with prompt-lookup speculation (adaptive, so rank 0's choice is
broadcast) and with chunked prefill and the prefix cache, where the
family and pools take them, and tiny llama with two LoRA adapters
(loaded whole; each rank keeps its heads' part) serving a mix of base
and adapter requests. Every rank's greedy and seeded streams must
be identical to each other and to `kubeai_tpu.engine.Engine` on the same
weights, unsharded; prefill, both decode layouts and the verify window
on the ranks' shards must give logits within 1e-4 of the JAX functions
in f32, and each rank's K/V must be its KV heads of JAX's.

Gemma's worlds are tests/test_torch_gemma_tp.py's.

Also here: what still refuses under a mesh (in one process, over torch's
fake process-group backend or a world-1 gloo group), the rank-local
adapter buffers, a world-1 mesh equal to no mesh, and the topology
flags."""

import dataclasses
import datetime
import functools
import multiprocessing
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

import torch_tp_ranks
from torch_mixtral_fixtures import mixtral_models

from kubeai_tpu.engine import Engine as JEngine
from kubeai_tpu.engine import EngineConfig as JEngineConfig
from kubeai_tpu.engine import quantization as jq
from kubeai_tpu.engine.sampling import SamplingParams as JSamplingParams
from kubeai_tpu.models import llama as jl
from kubeai_tpu.models import mixtral as jm
from kubeai_tpu_torch.engine import Engine, EngineConfig
from kubeai_tpu_torch.engine.engine import _refuse_unported
from kubeai_tpu_torch.engine.server import parse_args, resolve_ranks
from kubeai_tpu_torch.models import gemma as tg
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.ops.int8_matmul import (
    K_MULTIPLE,
    MIN_SPLIT_CHUNKS,
    SPLITS,
    WGMMA_ROWS,
    check_weight,
    gemm_plan,
)
from kubeai_tpu_torch.engine.weights import ShardPlan
from kubeai_tpu_torch.models.registry import get_model_family
from kubeai_tpu_torch.parallel.collectives import TpLayout
from kubeai_tpu_torch.parallel.mesh import MeshConfig, build_mesh

ATOL = 1e-4
WORLDS = (2, 4)
# Seconds the spawned worlds may take, all cases included.
JOIN_S = 240
BASE = dict(num_slots=4, max_seq_len=64, page_size=8, decode_chunk=4)
MODES = {
    "per_layer": {},
    "fused": dict(decode_kernel="fused"),
    "speculate": dict(speculate=3, spec_probe_every=4),
    "prefix": dict(prefill_chunk=16, prefix_cache=True),
}
# case -> (family, EngineConfig extras, modes). Int8 pools take neither the
# fused layout nor speculation; mixtral has no verify forward.
CASES = {
    "llama": ("llama", {}, tuple(MODES)),
    "qwen": ("qwen", {}, tuple(MODES)),
    "int8_weights": ("llama", dict(quantization="int8"), tuple(MODES)),
    "int8_pools": ("llama", dict(kv_dtype="int8"), ("per_layer", "prefix")),
    "mixtral": ("mixtral", {}, ("per_layer", "fused", "prefix")),
    "lora": ("llama", dict(max_adapters=2), ("per_layer", "fused", "prefix")),
}
LOGITS = {"llama": 4, "qwen": 4, "int8_weights": 4, "mixtral": 3, "lora": 4}
# The lora case's adapter rows of the forwards' rows.
LORA_IDX = {"prefill": [1, 0, 2], "decode": [2, 1, 0, 1], "verify": [1, 2, 0, 2]}
FORWARDS = ("prefill", "decode_per_layer", "decode_fused", "verify")
SAMPLING = [
    dict(temperature=0.0, max_tokens=10),
    dict(temperature=0.8, top_k=16, top_p=0.9, max_tokens=10, seed=5),
]
PAGE, MP = 8, 6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs thousands of tiny ops: one intra-op thread
    keeps them from spinning against the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _waves() -> list[list[tuple]]:
    """One wave of five prompts, two over one 18-token system prompt (the
    prefix cache's hit), more prompts than slots, all in the 32-token
    bucket, greedy and seeded in turn."""
    rng = np.random.default_rng(8)
    system = rng.integers(1, 256, 18).tolist()
    prompts = [system + rng.integers(1, 256, 5).tolist(),
               system + rng.integers(1, 256, 9).tolist(),
               rng.integers(1, 256, 20).tolist(),
               rng.integers(1, 256, 27).tolist(),
               rng.integers(1, 256, 19).tolist()]
    return [[(p, SAMPLING[i % 2]) for i, p in enumerate(prompts)]]


def _adapters() -> dict:
    """Two rank-4 adapters over wq, wk, wv and wo of tiny llama, whole."""
    rng = np.random.default_rng(9)
    jcfg = jl.LlamaConfig.tiny()
    E, H, KVH, D, NL = (jcfg.hidden_size, jcfg.num_heads, jcfg.num_kv_heads, jcfg.head_size,
                        jcfg.num_layers)
    dims = {"wq": (E, H * D), "wk": (E, KVH * D), "wv": (E, KVH * D), "wo": (H * D, E)}
    return {name: {t: ((rng.standard_normal((NL, i, 4)) * 0.3).astype(np.float32),
                       (rng.standard_normal((NL, 4, o)) * 0.3).astype(np.float32))
                   for t, (i, o) in dims.items()} for name in ("a1", "a2")}


def _lora_waves() -> list[list[tuple]]:
    """`_waves` with the requests spread over the base model and both
    adapters, the two over the system prompt on one adapter (the prefix
    cache's hit)."""
    names = ["a1", "a1", "a2", None, "a2"]
    return [[(p, sp, names[i]) for i, (p, sp) in enumerate(wave)] for wave in _waves()]


def _llama_tree(bias: bool) -> dict:
    """A JAX llama tree in f32 as numpy, wq and wk scaled so attention
    moves the output; qwen's biases non-zero."""
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32, attention_bias=bias)
    tree = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(1)))
    for name in ("wq", "wk"):
        tree["layers"][name] = tree["layers"][name] * 10
    tree["embed"] = tree["embed"] * 10
    if bias:
        rng = np.random.default_rng(2)
        for b in ("bq", "bk", "bv"):
            tree["layers"][b] = (rng.standard_normal(tree["layers"][b].shape) * 0.1
                                 ).astype(np.float32)
    return tree


def _pools(kvh: int, d: int, rng, positions, window: int):
    """Random stacked pools and block tables for 2 layers: slots 0..B-2
    hold pages for positions + window (bounded by MP), the last is free."""
    B = len(positions)
    P = 1 + B * MP
    kp = rng.standard_normal((2, P, PAGE, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((2, P, PAGE, kvh, d)).astype(np.float32)
    perm = rng.permutation(np.arange(1, P))
    bt = np.full((B, MP), -1, np.int32)
    for s in range(B - 1):
        need = min(-(-(int(positions[s]) + window) // PAGE), MP)
        bt[s, :need] = perm[s * MP:s * MP + need]
    return dict(k_pages=kp, v_pages=vp, block_tables=bt)


def _inputs() -> dict:
    """The forwards' inputs (KVH = 2, D = 16 for both families)."""
    rng = np.random.default_rng(3)
    positions = np.array([17, 0, 40, 9], np.int64)
    decode = _pools(2, 16, rng, positions, 1)
    decode.update(tokens=rng.integers(1, 512, 4), positions=positions)
    vpos = np.array([17, 0, 43, 9], np.int64)
    verify = _pools(2, 16, rng, vpos, 5)
    verify.update(tokens=rng.integers(1, 512, (4, 5)), positions=vpos)
    prefill = dict(tokens=rng.integers(1, 512, (3, 16)), lengths=np.array([16, 5, 11]))
    return dict(prefill=prefill, decode=decode, verify=verify,
                lora_idx={k: np.array(v) for k, v in LORA_IDX.items()})


@pytest.fixture(scope="module")
def models():
    """case -> (JAX config, JAX params for the forwards, numpy tree)."""
    out = {}
    for name, (family, _, _) in CASES.items():
        if family == "mixtral":
            jcfg, jp, _, _ = mixtral_models()
            out[name] = (jcfg, jp, jax.tree.map(np.asarray, jp))
            continue
        tree = _llama_tree(family == "qwen")
        jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32,
                                   attention_bias=family == "qwen")
        jp = jax.tree.map(jnp.asarray, tree)
        if name == "int8_weights":
            jp = jq.quantize_params(jp)
        out[name] = (jcfg, jp, tree)
    return out


@pytest.fixture(scope="module")
def spawned(models, tmp_path_factory):
    """The two worlds, started at once: {world: (processes, result paths)}."""
    root = tmp_path_factory.mktemp("tp")
    cases = []
    for name, (family, engine, modes) in CASES.items():
        jcfg, _, tree = models[name]
        cases.append(dict(
            name=name, family=family, tree=tree, engine=engine,
            config={f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
                    if f.name != "dtype"},
            modes={m: MODES[m] for m in modes}, logits=name in LOGITS,
            **(dict(adapters=_adapters(), waves=_lora_waves()) if name == "lora" else {})))
    inputs = root / "inputs.pkl"
    inputs.write_bytes(pickle.dumps(dict(base=BASE, waves=_waves(), cases=cases,
                                         inputs=_inputs())))
    ctx = multiprocessing.get_context("spawn")
    worlds = {}
    for world in WORLDS:
        outs = [root / f"w{world}_rank{r}.pkl" for r in range(world)]
        procs = [ctx.Process(target=torch_tp_ranks.run, daemon=True, args=(
            r, world, str(root / f"rdv{world}"), str(inputs), str(outs[r])))
            for r in range(world)]
        for p in procs:
            p.start()
        worlds[world] = (procs, outs)
    yield worlds
    for procs, _ in worlds.values():
        for p in procs:
            if p.is_alive():
                p.kill()


def _jax_streams(jcfg, jp, family: str, engine: dict, adapters=None, waves=None):
    """The JAX engine's streams of the waves (and the engine, whose adapter
    buffers the forwards read)."""
    eng = JEngine(family, jcfg, jp, cfg=JEngineConfig(
        cache_dtype=jnp.float32, step_overlap="off", **BASE, **engine))
    for name, weights in (adapters or {}).items():
        eng.load_adapter(name, weights)
    streams = []
    for wave in waves or _waves():
        rids = [eng.add_request(p, JSamplingParams(**sp), adapter=(a[0] if a else None))
                for p, sp, *a in wave]
        out = {rid: [] for rid in rids}
        while eng.has_work():
            for ev in eng.step():
                out[ev.rid].append(ev.token)
        streams += [out[rid] for rid in rids]
    return streams, eng


@pytest.fixture(scope="module")
def jax_side(models, spawned):
    """case -> (JAX streams, {forward: (logits, K, V)}), computed while the
    worlds run. The int8-weight case hands JAX the float tree and its
    engine quantizes it, as the port's does."""
    inputs = _inputs()
    out = {}
    for name, (family, engine, _) in CASES.items():
        jcfg, jp, tree = models[name]
        lora = name == "lora"
        streams, jeng = _jax_streams(jcfg, jax.tree.map(jnp.asarray, tree), family, engine,
                                     *((_adapters(), _lora_waves()) if lora else ()))

        def kw(fn):  # the adapter buffers and rows of a forward
            return dict(lora=jeng._lora, lora_idx=jnp.asarray(LORA_IDX[fn])) if lora else {}

        fwd = {}
        if name in LOGITS:
            mod = jm if family == "mixtral" else jl
            pre, dec = inputs["prefill"], inputs["decode"]
            fwd["prefill"] = jax.jit(functools.partial(mod.prefill, **kw("prefill")),
                                     static_argnums=1)(
                jp, jcfg, jnp.asarray(pre["tokens"], jnp.int32), jnp.asarray(pre["lengths"]))
            for layout in ("per_layer", "fused"):
                # The layouts differ only in the free slot's junk row.
                step = jax.jit(functools.partial(mod.decode_step_paged, attn_kernel=layout,
                                                 **kw("decode")), static_argnums=1)
                fwd[f"decode_{layout}"] = step(
                    jp, jcfg, jnp.asarray(dec["tokens"], jnp.int32),
                    jnp.asarray(dec["positions"], jnp.int32), jnp.asarray(dec["k_pages"]),
                    jnp.asarray(dec["v_pages"]), jnp.asarray(dec["block_tables"]))
            if family != "mixtral":
                ver = inputs["verify"]
                fwd["verify"] = jax.jit(functools.partial(jl.decode_verify_paged, **kw("verify")),
                                        static_argnums=1)(
                    jp, jcfg, jnp.asarray(ver["tokens"], jnp.int32),
                    jnp.asarray(ver["positions"], jnp.int32), jnp.asarray(ver["k_pages"]),
                    jnp.asarray(ver["v_pages"]), jnp.asarray(ver["block_tables"]))
        out[name] = (streams, {k: tuple(np.asarray(a) for a in v) for k, v in fwd.items()})
    return out


@pytest.fixture(scope="module")
def ranks(spawned, jax_side):
    """world -> every rank's results, once the world has ended."""
    out = {}
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=JOIN_S)
    for world, (procs, paths) in spawned.items():
        for p in procs:
            p.join(max(1.0, (deadline - datetime.datetime.now()).total_seconds()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
        assert not alive, f"world {world}: {len(alive)} ranks still running after {JOIN_S} s"
        assert [p.exitcode for p in procs] == [0] * world, f"world {world} exit codes"
        out[world] = [pickle.loads(path.read_bytes()) for path in paths]
    return out


STREAM_CASES = [(w, c, m) for w in WORLDS for c, (_, _, modes) in CASES.items() for m in modes]


@pytest.mark.parametrize("world,case,mode", STREAM_CASES,
                         ids=[f"tp{w}-{c}-{m}" for w, c, m in STREAM_CASES])
def test_streams_identical_across_ranks_and_to_jax(ranks, jax_side, world, case, mode):
    got = [r[case]["streams"][mode] for r in ranks[world]]
    assert all(g == got[0] for g in got[1:]), f"ranks disagree: {got}"
    assert got[0] == jax_side[case][0]
    assert all(len(s) == 10 for s in got[0])
    stats = [r[case]["prefix_stats"][mode] for r in ranks[world]]
    assert all(s == stats[0] for s in stats)
    if mode == "prefix":
        assert stats[0]["hit_tokens"] > 0


def _local(a: np.ndarray, rank: int, world: int) -> np.ndarray:
    """Rank's KV heads of a [..., KVH, D] array (two KV heads): one each
    at tp=2; at tp=4 the head its q head reads (rank // 2)."""
    h = rank * 2 // world
    return a[..., h:h + 1, :]


FORWARD_CASES = [(w, c, f) for w in WORLDS for c in LOGITS for f in FORWARDS[:LOGITS[c]]]


@pytest.mark.parametrize("world,case,fn", FORWARD_CASES,
                         ids=[f"tp{w}-{c}-{f}" for w, c, f in FORWARD_CASES])
def test_sharded_forwards_match_jax(ranks, jax_side, world, case, fn):
    want_logits, want_k, want_v = jax_side[case][1][fn]
    for rank, res in enumerate(ranks[world]):
        logits, k, v = res[case]["logits"][fn]
        assert logits.dtype == np.float32 and logits.shape == want_logits.shape
        np.testing.assert_allclose(logits, want_logits, atol=ATOL, err_msg=f"rank {rank}")
        np.testing.assert_array_equal(logits, ranks[world][0][case]["logits"][fn][0])
        # Page 0 is scratch (free slots and positions past the table write there).
        sl = np.s_[:] if fn == "prefill" else np.s_[:, 1:]
        np.testing.assert_allclose(k[sl], _local(want_k, rank, world)[sl], atol=ATOL)
        np.testing.assert_allclose(v[sl], _local(want_v, rank, world)[sl], atol=ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_rank_local_heads_and_columns(ranks, world):
    """Each rank's pools hold KVH / tp heads (one, shared by tp / KVH
    ranks, where tp > KVH) and its wq holds H / tp heads' columns."""
    for res in ranks[world]:
        for case in CASES:
            assert res[case]["kv_heads"] == max(2 // world, 1)
            assert res[case]["wq_columns"] == 4 * 16 // world


# ---- in one process: refusals and a world-1 mesh ---------------------------


@pytest.fixture
def fake_world():
    """Enter a fake process group of n ranks (no collective runs)."""
    def enter(n: int):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    yield enter
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture
def world1(tmp_path):
    """A world-1 gloo group and its mesh."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=30))
    yield build_mesh(MeshConfig())
    dist.destroy_process_group()


def _tiny():
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32)
    return cfg, tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("mesh_kw,item", [
    (dict(pp=2, tp=2), "11b"), (dict(sp=2, tp=2), "11c"), (dict(dp=2, tp=2), "11a2"),
])
def test_mesh_dims_still_refused(fake_world, mesh_kw, item):
    fake_world(4)
    cfg, params = _tiny()
    with pytest.raises(NotImplementedError, match=f"ROADMAP A item {item}"):
        Engine("llama", cfg, params, mesh=build_mesh(MeshConfig(**mesh_kw)), device="cpu")


@pytest.mark.parametrize("what", ["gemma", "lora", "draft", "slot"])
def test_features_still_refused_under_a_mesh(fake_world, what):
    """A draft and the slot cache still refuse under a mesh. LoRA did
    until lockstep serving (ROADMAP A item 11d) and gemma until its
    sharding specs (ROADMAP A item 11a2): their cases now check that the
    mesh refusals pass them and that a rank's adapter buffers and cuts,
    and a rank's gemma shard, are its heads' and its vocabulary block's
    (the parity is the worlds' `lora` case here and
    tests/test_torch_gemma_tp.py)."""
    fake_world(2)
    mesh = build_mesh(MeshConfig(tp=2))
    cfg, params = _tiny()
    family, kw, ecfg = "llama", {}, {}
    if what == "gemma":
        cfg = tg.GemmaConfig.tiny()
        fam = get_model_family("gemma")
        _refuse_unported(EngineConfig(), mesh, None, "per_layer", "paged", fam)
        params = tg.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        shard = ShardPlan(fam, cfg, mesh).shard(params)
        D = cfg.head_size
        assert set(shard) == {"embed", "layers", "final_norm"}
        assert torch.equal(shard["embed"], params["embed"][:cfg.vocab_size // 2])
        assert torch.equal(shard["layers"]["wq"], params["layers"]["wq"][..., :2 * D])
        assert torch.equal(shard["layers"]["wk"], params["layers"]["wk"][..., :D])
        assert torch.equal(shard["layers"]["wo"], params["layers"]["wo"][:, :2 * D])
        assert shard["layers"]["input_norm"] is params["layers"]["input_norm"]
        return
    elif what == "lora":
        fam = get_model_family("llama")
        _refuse_unported(EngineConfig(max_adapters=2), mesh, None, "per_layer", "paged", fam)
        tp = TpLayout.of(mesh)
        bufs = tl.init_lora_buffers(cfg, 3, 8, device="cpu", tp=tp)
        D = cfg.head_size
        assert bufs["wq"]["B"].shape[-1] == bufs["wo"]["A"].shape[-2] == 2 * D
        assert bufs["wk"]["B"].shape[-1] == bufs["wv"]["B"].shape[-1] == D
        A = torch.arange(2 * 64 * 4, dtype=torch.float32).reshape(2, 64, 4)
        B = torch.arange(2 * 4 * 64, dtype=torch.float32).reshape(2, 4, 64)
        a, b = tl.lora_shard(cfg, tp, "wo", A, B)
        assert torch.equal(a, A[:, :2 * D]) and b is B
        a, b = tl.lora_shard(cfg, tp, "wq", A, B)
        assert a is A and torch.equal(b, B[..., :2 * D])
        return
    elif what == "draft":
        kw, ecfg = dict(draft=(cfg, params)), dict(speculate=2)
    else:
        ecfg = dict(cache_mode="slot")
    with pytest.raises(NotImplementedError, match="under a mesh.*ROADMAP A item 11a2"):
        Engine(family, cfg, params, mesh=mesh, cfg=EngineConfig(**ecfg), device="cpu", **kw)


@pytest.mark.parametrize("method", ["export_handoff", "import_handoff", "export_prefix_pages",
                                    "import_prefix_pages", "enable_kv_spill"])
def test_kv_transfers_still_refused_under_a_mesh(world1, method):
    cfg, params = _tiny()
    eng = Engine("llama", cfg, params, mesh=world1, device="cpu", cfg=EngineConfig(
        cache_dtype=torch.float32, prefill_chunk=16, prefix_cache=True, **BASE))
    args = {"export_handoff": ([1, 2, 3],), "import_handoff": (None,),
            "export_prefix_pages": ([],), "import_prefix_pages": (None,),
            "enable_kv_spill": (None,)}[method]
    with pytest.raises(NotImplementedError, match="under a mesh.*ROADMAP A item 11a2"):
        getattr(eng, method)(*args)


@pytest.mark.parametrize("mode", list(MODES))
def test_world1_mesh_equals_no_mesh(world1, mode):
    cfg, params = _tiny()
    kw = dict(cache_dtype=torch.float32, **BASE, **MODES[mode])
    mesh_eng = Engine("llama", cfg, params, mesh=world1, cfg=EngineConfig(**kw), device="cpu")
    plain = Engine("llama", cfg, params, cfg=EngineConfig(**kw), device="cpu")
    assert mesh_eng._tp.size == 1
    assert torch_tp_ranks.run_waves(mesh_eng, _waves()) == torch_tp_ranks.run_waves(
        plain, _waves())


def test_prefill_refuses_only_an_sp_dim(fake_world):
    fake_world(2)
    cfg, params = _tiny()
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP A item 11c"):
        tl.prefill(params, cfg, toks, torch.tensor([4]), mesh=build_mesh(MeshConfig(sp=2)))


def test_tpu_topology_flag_names_11d():
    """--tpu-topology and the multihost flags exited naming ROADMAP A item
    11d until it was done: main now takes them (a slice of ranks in
    lockstep); what still refuses under a mesh names 11a2."""
    args = parse_args(["--model-url", "/m", "--tpu-topology", "2x2"])
    assert resolve_ranks(args).world == 4 and args.step_overlap == "off"
    args = parse_args(["--model-url", "/m", "--tpu-topology", "2x2", "--num-processes", "2",
                       "--process-id", "1", "--dcn-coordinator", "127.0.0.1:1"])
    layout = resolve_ranks(args)
    assert (layout.local, layout.global_rank(0)) == (2, 2)
    with pytest.raises(SystemExit, match="ROADMAP A item 11a2"):
        resolve_ranks(parse_args(["--model-url", "/m", "--tpu-topology", "2x2",
                                  "--role", "decode"]))


@pytest.mark.parametrize("k,n", [(4096, 256), (4096, 128), (3584, 4096), (8192, 128)],
                         ids=["8B-wk-tp4", "8B-wk-tp8", "8B-w_down-tp4", "70B-wk-tp8"])
def test_gemm_plan_at_rank_local_weights(k, n):
    """The W8A16 kernel takes each rank-local weight of the catalog's
    sharded entries, and gemm_plan gives a build and split it has for
    every M the wgmma route takes."""
    check_weight({"w8": torch.zeros((k, n), dtype=torch.int8)})
    for m in (9, 40, 96, 512, 4096):
        bm, z = gemm_plan(m, n, k)
        assert bm in WGMMA_ROWS and z in SPLITS
        assert z == 1 or k // K_MULTIPLE // z >= MIN_SPLIT_CHUNKS
