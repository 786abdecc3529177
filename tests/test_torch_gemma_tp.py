"""Gemma 1 and 2 under tensor parallelism in kubeai_tpu_torch, against the
unsharded JAX package, over gloo ranks on the CPU in f32.

Worlds of 2 and 4 ranks are spawned once for the module (spawn start
method, `file://` rendezvous under tmp_path, gloo with a timeout, joins
bounded; the ranks run tests/torch_gemma_tp_ranks.py, which never imports
JAX). Three tiny configs: Gemma-1 (`GemmaConfig.tiny()`: 4 heads over 2
KV heads, so at tp=4 each KV head is held by the two ranks whose q heads
read it), Gemma-2 (sandwich norms, attention softcap 50, final softcap
30, query_pre_attn_scalar 24 against a head_dim of 16, a window of 8 on
the even layers) and Gemma-2 over one KV head, which tp exceeds in both
worlds. The weights are test_torch_gemma.py's draw: wq and wk scaled,
the embedding scaled, the norms drawn near 0, so that the softcaps, the
window and the zero-centred norms each move the output.

- The forwards on each rank's shard (`weights.ShardPlan`): `prefill`,
  each chunk of `prefill_chunk` and `decode_step_paged` in both layouts
  give logits within 1e-4 of the unsharded JAX functions, equal on every
  rank, and K/V that are the rank's KV heads of JAX's.
- The engine: `Engine(..., mesh=...)` greedy and seeded streams identical
  on every rank and to `kubeai_tpu.engine.Engine` on the same weights:
  per_layer, fused, int8 pools, and chunked prefill with the prefix cache
  (hits) at tp=2; per_layer (and Gemma-1 fused) at tp=4. Adapters stay
  refused on gemma under a mesh (fault C10), int8 weights too (C15).
- The entry point: `main --tpu-topology 1x2` on a Gemma-2 checkpoint
  serves chat through both ranks, each holding its shard, with streams
  equal to the plain SPMD oracle's (tests/torch_gemma_tp_ranks.py's
  `served_oracle`) and the ranks' digests equal.
- Rank-local loading: `load_params("gemma", ..., shard=ShardPlan(...))` of
  a Gemma and a Gemma-2 checkpoint written with HF names
  (tests/torch_gemma_checkpoint.py) equals the plan's cut of the full
  load, bit for bit, on every rank of tp 2 and 4 (torch's fake process
  group, one process); the tied embedding is one vocabulary block.
"""

import dataclasses
import datetime
import functools
import json
import multiprocessing
import os
import pickle
import re
import signal
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

import torch_gemma_tp_ranks
from testutil import http_get, http_post
from torch_gemma_checkpoint import hf_config, write_gemma_checkpoint

from kubeai_tpu.engine import Engine as JEngine
from kubeai_tpu.engine import EngineConfig as JEngineConfig
from kubeai_tpu.engine.sampling import SamplingParams as JSamplingParams
from kubeai_tpu.models import gemma as jg
from kubeai_tpu_torch.engine import EngineConfig
from kubeai_tpu_torch.engine.engine import _refuse_unported
from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
from kubeai_tpu_torch.engine.weights import ShardPlan, load_hf_config, load_params
from kubeai_tpu_torch.models import gemma as tg
from kubeai_tpu_torch.models.registry import get_model_family
from kubeai_tpu_torch.parallel.mesh import MeshConfig, build_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 on both sides through two layers, sums in different orders.
ATOL = 1e-4
WORLDS = (2, 4)
# Seconds the spawned worlds may take, all configs included.
JOIN_S = 240
BASE = dict(num_slots=4, max_seq_len=64, page_size=8, decode_chunk=4)
GEMMA2 = dict(sandwich_norms=True, attn_logit_softcapping=50.0,
              final_logit_softcapping=30.0, query_pre_attn_scalar=24.0,
              sliding_window=8)
CONFIGS = {
    "gemma1": {},
    "gemma2": GEMMA2,
    "gemma2-one-kv-head": {**GEMMA2, "num_kv_heads": 1},
}
MODES = {
    "per_layer": {},
    "fused": dict(decode_kernel="fused"),
    "int8": dict(kv_dtype="int8"),
    "prefix": dict(prefill_chunk=16, prefix_cache=True),
}
# config -> {world: engine modes}
ENGINE_RUNS = {
    "gemma1": {2: ("per_layer",), 4: ("per_layer", "fused")},
    "gemma2": {2: ("per_layer", "fused", "int8", "prefix"), 4: ("per_layer",)},
    "gemma2-one-kv-head": {2: ("per_layer",)},
}
SAMPLING = [
    dict(temperature=0.0, max_tokens=10),
    dict(temperature=0.8, top_k=16, top_p=0.9, max_tokens=10, seed=5),
]
PAGE, MP = 8, 6
# prefill_chunk: a 21-token prompt in chunks of 8 into a 32-token cache.
CHUNK, CHUNK_LEN, STAGE = 8, 21, 32
FORWARDS = ("prefill", "decode_per_layer", "decode_fused",
            *(f"chunk{s}" for s in range(0, CHUNK_LEN, CHUNK)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs thousands of tiny ops: one intra-op thread
    keeps them from spinning against the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _waves() -> list[list[tuple]]:
    """Five prompts past the window of 8, two over one 18-token system
    prompt (the prefix cache's hit), more prompts than slots, all in the
    32-token bucket, greedy and seeded in turn."""
    rng = np.random.default_rng(8)
    system = rng.integers(1, 256, 18).tolist()
    prompts = [system + rng.integers(1, 256, 5).tolist(),
               system + rng.integers(1, 256, 9).tolist(),
               rng.integers(1, 256, 20).tolist(),
               rng.integers(1, 256, 27).tolist(),
               rng.integers(1, 256, 19).tolist()]
    return [[(p, SAMPLING[i % 2]) for i, p in enumerate(prompts)]]


def _model(kind: str):
    """(JAX config, JAX params, numpy tree) in f32."""
    jcfg = dataclasses.replace(jg.GemmaConfig.tiny(vocab_size=512), dtype=jnp.float32,
                               **CONFIGS[kind])
    tree = jax.tree.map(np.asarray, jg.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    tree["layers"]["wq"] = tree["layers"]["wq"] * 25
    tree["layers"]["wk"] = tree["layers"]["wk"] * 25
    tree["embed"] = tree["embed"] * 10
    for name, w in tree["layers"].items():
        if name.endswith("norm"):
            tree["layers"][name] = (rng.standard_normal(w.shape) * 0.1).astype(np.float32)
    tree["final_norm"] = (rng.standard_normal(tree["final_norm"].shape) * 0.1
                          ).astype(np.float32)
    return jcfg, jax.tree.map(jnp.asarray, tree), tree


def _inputs(jcfg) -> dict:
    """The forwards' inputs at the config's KV heads: a ragged prefill
    batch, four decode slots (one free) past the window, and a prompt for
    the chunks with a staging cache of masked junk."""
    rng = np.random.default_rng(3)
    NL, KVH, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_size
    positions = np.array([17, 0, 40, 9], np.int64)
    B, P = len(positions), 1 + len(positions) * MP
    kp = rng.standard_normal((NL, P, PAGE, KVH, D)).astype(np.float32)
    vp = rng.standard_normal((NL, P, PAGE, KVH, D)).astype(np.float32)
    perm = rng.permutation(np.arange(1, P))
    bt = np.full((B, MP), -1, np.int32)
    for s in range(B - 1):
        need = min(-(-(int(positions[s]) + 1) // PAGE), MP)
        bt[s, :need] = perm[s * MP:s * MP + need]
    decode = dict(k_pages=kp, v_pages=vp, block_tables=bt, positions=positions,
                  tokens=rng.integers(1, jcfg.vocab_size, B))
    prefill = dict(tokens=rng.integers(1, jcfg.vocab_size, (3, 24)),
                   lengths=np.array([24, 10, 17]))
    tokens = np.zeros(24, np.int64)
    tokens[:CHUNK_LEN] = rng.integers(1, jcfg.vocab_size, CHUNK_LEN)
    stale = rng.standard_normal((2, NL, STAGE, KVH, D)).astype(np.float32)
    chunk = dict(tokens=tokens, length=CHUNK_LEN, size=CHUNK, k_stale=stale[0],
                 v_stale=stale[1])
    return dict(prefill=prefill, decode=decode, chunk=chunk)


@pytest.fixture(scope="module")
def models():
    return {kind: _model(kind) for kind in CONFIGS}


@pytest.fixture(scope="module")
def served_checkpoint(tmp_path_factory):
    """A Gemma-2 checkpoint with HF names in bf16 for the served run, its
    printable bytes' rows scaled so that the streams are bytes."""
    return write_gemma_checkpoint(tmp_path_factory.mktemp("gemma2_ckpt"), hf_config(True),
                                  seed=6, ascii_scale=4.0)


def _served_spec(model_dir: str) -> dict:
    """The served run as the oracle ranks replay it: the checkpoint, the
    entry point's flags, and each body's (prompt ids, sampling, streamed)."""
    tok = ByteTokenizer()
    return dict(model_dir=model_dir, flags=SERVE_FLAGS, world=2, requests=[
        (tok.apply_chat_template(b["messages"]),
         dict(temperature=b["temperature"], max_tokens=b["max_tokens"], seed=b.get("seed")),
         bool(b.get("stream"))) for b in BODIES])


@pytest.fixture(scope="module")
def spawned(models, served_checkpoint, tmp_path_factory):
    """The two worlds, started at once: {world: (processes, result paths)}."""
    root = tmp_path_factory.mktemp("gemma_tp")
    cases = []
    for kind, (jcfg, _, tree) in models.items():
        cases.append(dict(
            name=kind, tree=tree, inputs=_inputs(jcfg),
            config={f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
                    if f.name != "dtype"},
            modes={w: {m: MODES[m] for m in modes} for w, modes in ENGINE_RUNS[kind].items()}))
    inputs = root / "inputs.pkl"
    inputs.write_bytes(pickle.dumps(dict(base=BASE, waves=_waves(), cases=cases,
                                         served=_served_spec(served_checkpoint))))
    ctx = multiprocessing.get_context("spawn")
    worlds = {}
    for world in WORLDS:
        outs = [root / f"w{world}_rank{r}.pkl" for r in range(world)]
        procs = [ctx.Process(target=torch_gemma_tp_ranks.run, daemon=True, args=(
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


def _jax_forwards(jcfg, jp, inputs) -> dict:
    """The unsharded JAX functions on the same inputs: {forward: (logits,
    K, V)} as numpy."""
    out = {}
    pre, dec, ch = inputs["prefill"], inputs["decode"], inputs["chunk"]
    out["prefill"] = jax.jit(jg.prefill, static_argnums=1)(
        jp, jcfg, jnp.asarray(pre["tokens"], jnp.int32), jnp.asarray(pre["lengths"]))
    for layout in ("per_layer", "fused"):
        step = jax.jit(functools.partial(jg.decode_step_paged, attn_kernel=layout),
                       static_argnums=1)
        out[f"decode_{layout}"] = step(
            jp, jcfg, jnp.asarray(dec["tokens"], jnp.int32),
            jnp.asarray(dec["positions"], jnp.int32), jnp.asarray(dec["k_pages"]),
            jnp.asarray(dec["v_pages"]), jnp.asarray(dec["block_tables"]))
    kc, vc = jnp.asarray(ch["k_stale"]), jnp.asarray(ch["v_stale"])
    for start in range(0, CHUNK_LEN, CHUNK):
        last = start + CHUNK >= CHUNK_LEN
        logits, kc, vc = jg.prefill_chunk(
            jp, jcfg, jnp.asarray(ch["tokens"][None, start:start + CHUNK], jnp.int32),
            jnp.int32(start), jnp.int32(CHUNK_LEN), kc, vc, want_logits=last)
        out[f"chunk{start}"] = (logits, kc, vc)
    return {k: tuple(None if a is None else np.asarray(a) for a in v) for k, v in out.items()}


def _jax_streams(jcfg, jp, engine: dict) -> tuple[list[list[int]], dict]:
    eng = JEngine("gemma", jcfg, jp, cfg=JEngineConfig(
        cache_dtype=jnp.float32, step_overlap="off", **BASE, **engine))
    streams = []
    for wave in _waves():
        rids = [eng.add_request(p, JSamplingParams(**sp)) for p, sp in wave]
        out = {rid: [] for rid in rids}
        while eng.has_work():
            for ev in eng.step():
                out[ev.rid].append(ev.token)
        streams += [out[rid] for rid in rids]
    return streams, dict(eng.prefix_stats)


@pytest.fixture(scope="module")
def jax_side(models, spawned):
    """config -> ({mode: (JAX streams, prefix stats)}, {forward: (logits,
    K, V)}), computed while the worlds run."""
    out = {}
    for kind, (jcfg, jp, _) in models.items():
        modes = {m for ms in ENGINE_RUNS[kind].values() for m in ms}
        streams = {m: _jax_streams(jcfg, jp, MODES[m]) for m in modes}
        out[kind] = (streams, _jax_forwards(jcfg, jp, _inputs(jcfg)))
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


def _local(a: np.ndarray, kvh: int, rank: int, world: int) -> np.ndarray:
    """The rank's KV heads of a [..., KVH, D] array."""
    if kvh % world == 0:
        n = kvh // world
        return a[..., rank * n:(rank + 1) * n, :]
    h = rank * kvh // world
    return a[..., h:h + 1, :]


FORWARD_CASES = [(w, c, f) for w in WORLDS for c in CONFIGS for f in FORWARDS]


@pytest.mark.parametrize("world,kind,fn", FORWARD_CASES,
                         ids=[f"tp{w}-{c}-{f}" for w, c, f in FORWARD_CASES])
def test_sharded_forwards_match_jax(models, ranks, jax_side, world, kind, fn):
    kvh = models[kind][0].num_kv_heads
    want_logits, want_k, want_v = jax_side[kind][1][fn]
    for rank, res in enumerate(ranks[world]):
        logits, k, v = res[kind]["logits"][fn]
        if want_logits is None:
            assert logits is None
        else:
            assert logits.dtype == np.float32 and logits.shape == want_logits.shape
            np.testing.assert_allclose(logits, want_logits, atol=ATOL, rtol=0,
                                       err_msg=f"rank {rank}")
            np.testing.assert_array_equal(logits, ranks[world][0][kind]["logits"][fn][0])
        # Page 0 of a pool is scratch (the free slot writes there).
        sl = np.s_[:, 1:] if fn.startswith("decode") else np.s_[:]
        np.testing.assert_allclose(k[sl], _local(want_k, kvh, rank, world)[sl], atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(v[sl], _local(want_v, kvh, rank, world)[sl], atol=ATOL,
                                   rtol=0)


STREAM_CASES = [(w, c, m) for c, runs in ENGINE_RUNS.items() for w, ms in runs.items()
                for m in ms]


@pytest.mark.parametrize("world,kind,mode", STREAM_CASES,
                         ids=[f"tp{w}-{c}-{m}" for w, c, m in STREAM_CASES])
def test_streams_identical_across_ranks_and_to_jax(ranks, jax_side, world, kind, mode):
    got = [r[kind]["streams"][mode] for r in ranks[world]]
    assert all(g == got[0] for g in got[1:]), f"ranks disagree: {got}"
    want, want_stats = jax_side[kind][0][mode]
    assert got[0] == want
    assert all(len(s) == 10 for s in got[0])
    stats = [r[kind]["prefix_stats"][mode] for r in ranks[world]]
    assert all(s == want_stats for s in stats)
    if mode == "prefix":
        assert stats[0]["hit_tokens"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_rank_local_heads_columns_and_vocabulary(models, ranks, world):
    """Each rank's wq holds H / tp heads' columns, its embedding V / tp
    rows, and its pools KVH / tp heads (one where tp exceeds the KV
    heads)."""
    for res in ranks[world]:
        for kind, (jcfg, _, _) in models.items():
            assert res[kind]["wq_columns"] == jcfg.num_heads * jcfg.head_size // world
            assert res[kind]["embed_rows"] == jcfg.vocab_size // world
            if res[kind]["streams"]:
                assert res[kind]["kv_heads"] == max(jcfg.num_kv_heads // world, 1)


# ---- the entry point on a gemma checkpoint over two ranks -------------------------


SERVE_FLAGS = ["--device", "cpu", "--host", "127.0.0.1", "--num-slots", "4",
               "--max-seq-len", "256", "--drain-timeout", "10", "--tpu-topology", "1x2"]
BODIES = [
    {"messages": [{"role": "user", "content": "Hello there"}], "max_tokens": 8,
     "temperature": 0},
    {"messages": [{"role": "user", "content": "The quick brown fox"}], "max_tokens": 8,
     "temperature": 0.8, "seed": 3, "stream": True},
    {"messages": [{"role": "user", "content": "A longer prompt, past the window"}],
     "max_tokens": 8, "temperature": 0, "stream": True},
]
READY_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _chat(port, body):
    """(status, token ids of a streamed body or the text of a unary one)."""
    status, raw = http_post(f"127.0.0.1:{port}", "/v1/chat/completions", body, timeout=60)
    assert status == 200, raw
    if not body.get("stream"):
        return json.loads(raw)["choices"][0]["message"]["content"]
    chunks = [json.loads(ln[6:]) for ln in raw.decode().splitlines()
              if ln.startswith("data: ") and ln != "data: [DONE]"]
    return [t for c in chunks for t in c.get("token_ids", ())]


def test_main_serves_a_gemma_checkpoint_over_two_ranks(ranks, served_checkpoint, tmp_path):
    """`main --tpu-topology 1x2` on a Gemma-2 checkpoint: two ranks in one
    process, each loading its shard; every served stream equals the plain
    SPMD oracle's on the same bf16 shards (each rank's, equal), the
    ranks' stream digests agree, /v1/embeddings answers gemma's 400 as an
    unsharded server does, and SIGTERM ends both ranks with exit 0."""
    port = _free_port()
    log = tmp_path / "main.log"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", HF_HUB_OFFLINE="1",
               TRANSFORMERS_OFFLINE="1", USE_TF="0", USE_FLAX="0")
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "kubeai_tpu_torch.engine.server", "--model-url",
             served_checkpoint, "--port", str(port), *SERVE_FLAGS], cwd=REPO, env=env,
            stdout=out, stderr=subprocess.STDOUT, start_new_session=True)
    try:
        deadline = time.monotonic() + READY_S
        while True:
            assert proc.poll() is None, log.read_text()[-3000:]
            assert time.monotonic() < deadline, log.read_text()[-3000:]
            try:
                if http_get(f"127.0.0.1:{port}", "/health", timeout=2)[0] == 200:
                    break
            except OSError:
                pass
            time.sleep(0.3)
        got = [_chat(port, body) for body in BODIES]
        status, raw = http_post(f"127.0.0.1:{port}", "/v1/embeddings", {"input": "hi"})
        assert (status, json.loads(raw)) == (
            400, {"error": {"message": "model family gemma has no embedding support"}})
        state = json.loads(http_get(f"127.0.0.1:{port}", "/v1/state")[1])
        assert state["parallel"]["ranks"] == 2 and state["parallel"]["processes"] == 1
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, log.read_text()[-3000:]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    oracle = [r["served"] for r in ranks[2]]
    assert oracle[0] == oracle[1]
    assert got == oracle[0]
    assert all(len(s) == 8 for s in got[1:])
    digests = dict(re.findall(r"lockstep digest: rank (\d+) .* sha256 (\w+)", log.read_text()))
    assert set(digests) == {"0", "1"} and len(set(digests.values())) == 1
    reports = re.findall(r"rank (\d+): H=(\d+) KVH=(\d+)", log.read_text())
    assert sorted(reports) == [("0", "2", "1"), ("1", "2", "1")]


# ---- in one process: the refusals that stay, and rank-local loading ---------------


@pytest.fixture
def fake_world():
    """Enter a fake process group of n ranks at a rank (no collective runs)."""
    def enter(n: int, rank: int = 0):
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n)
        return build_mesh(MeshConfig(tp=n))
    yield enter
    if dist.is_initialized():
        dist.destroy_process_group()


def test_gemma_refusals_that_stay_under_a_mesh(fake_world):
    """Gemma passes the mesh refusals; int8 weights stay refused (fault
    C15), naming the fault as without a mesh, and so do a draft and the
    slot cache (ROADMAP A item 11a2)."""
    mesh = fake_world(2)
    fam = get_model_family("gemma")
    _refuse_unported(EngineConfig(), mesh, None, "per_layer", "paged", fam)
    _refuse_unported(EngineConfig(kv_dtype="int8", prefill_chunk=16, prefix_cache=True),
                     mesh, None, "per_layer", "paged", fam)
    with pytest.raises(NotImplementedError, match="ROADMAP fault C15"):
        _refuse_unported(EngineConfig(quantization="int8"), mesh, None, "per_layer", "paged",
                         fam)
    with pytest.raises(NotImplementedError, match="the slot cache under a mesh.*11a2"):
        _refuse_unported(EngineConfig(), mesh, None, "per_layer", "slot", fam)
    cfg = tg.GemmaConfig.tiny()
    with pytest.raises(NotImplementedError, match="a draft model under a mesh.*11a2"):
        _refuse_unported(EngineConfig(speculate=2), mesh, (cfg, {}), "per_layer", "paged",
                         fam)
    assert fam.init_lora_buffers is None  # the engine's adapter refusal (C10)


LOAD_CASES = [(g, w) for g in (False, True) for w in WORLDS]


@pytest.mark.parametrize("gemma2,world", LOAD_CASES,
                         ids=[f"{'gemma2' if g else 'gemma'}-tp{w}" for g, w in LOAD_CASES])
def test_rank_local_load_equals_the_cut_of_a_full_load(tmp_path, fake_world, gemma2, world):
    model_dir = write_gemma_checkpoint(tmp_path, hf_config(gemma2), seed=4)
    hf = load_hf_config(model_dir)
    fam = get_model_family(hf["architectures"][0])
    cfg = fam.config_from_hf(hf)
    full = load_params("gemma", model_dir, cfg, device="cpu")
    for rank in range(world):
        mesh = fake_world(world, rank)
        plan = ShardPlan(fam, cfg, mesh)
        want = plan.shard(full)
        got = load_params("gemma", model_dir, cfg, device="cpu", shard=plan)
        dist.destroy_process_group()
        assert set(got) == set(want) == {"embed", "layers", "final_norm"}
        assert set(got["layers"]) == set(want["layers"])
        leaves = [(k, got[k], want[k]) for k in ("embed", "final_norm")]
        leaves += [(k, got["layers"][k], want["layers"][k]) for k in want["layers"]]
        for name, g, w in leaves:
            assert g.dtype == w.dtype == torch.bfloat16 and g.shape == w.shape, name
            assert torch.equal(g, w), f"rank {rank} {name}"
        rows = cfg.vocab_size // world
        assert torch.equal(got["embed"], full["embed"][rank * rows:(rank + 1) * rows])
        kvh = cfg.num_kv_heads
        D = cfg.head_size
        first = rank * kvh // world if world > kvh else rank * (kvh // world)
        n = max(kvh // world, 1)
        assert torch.equal(got["layers"]["wk"], full["layers"]["wk"][..., first * D:(first + n) * D])
