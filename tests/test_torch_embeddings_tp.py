"""Embeddings on a sharded replica (the TextEmbedding feature under tensor
parallelism), against the JAX package and the unsharded port, on the CPU.

- `llama.hidden_states` and `llama.trunk_layer` under tp on each rank's
  shard, for a tiny llama and a tiny qwen (q/k/v biases, tied
  embeddings), at tp 2 and 4 over spawned gloo ranks
  (tests/torch_embeddings_tp_ranks.py, which never imports JAX): within
  1e-4 of the unsharded JAX functions in f32, equal on every rank.
- The lockstep embedding op (`LockstepEngine.embed`, mirrored by
  `worker_loop`) in the same worlds: rank 0's vectors equal the sharded
  hidden_states bit for bit, the greedy stream served after it equals the
  JAX engine's, and the ranks' stream digests agree. In one process: its
  descriptor keeps the JAX module's layout (the op is one more code of
  its op column, [B, S] in the first meta row) and it broadcasts the
  descriptor and one payload.
- EngineServer on a lockstep engine: a slice of one process serves
  /v1/embeddings equal to an unsharded server, one of several answers
  the JAX server's 400, and gemma answers its 400 as without a mesh.
- `main --device cpu --tpu-topology 1x2` on a bf16 llama checkpoint
  serves /v1/embeddings close to an unsharded server on the same
  checkpoint (bf16: a rank rounds its partial sums before the f32
  all_reduce).
"""

import dataclasses
import datetime
import json
import multiprocessing
import os
import pickle
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

import torch_embeddings_tp_ranks
from testutil import http_get, http_post
from torch_multihost_ranks import write_llama_checkpoint

from kubeai_tpu.engine import Engine as JEngine
from kubeai_tpu.engine import EngineConfig as JEngineConfig
from kubeai_tpu.engine import multihost as jmh
from kubeai_tpu.engine.sampling import SamplingParams as JSamplingParams
from kubeai_tpu.models import llama as jl
from kubeai_tpu_torch.engine import Engine, EngineConfig
from kubeai_tpu_torch.engine import multihost as mh
from kubeai_tpu_torch.engine.server import EngineServer
from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
from kubeai_tpu_torch.engine.weights import load_hf_config, load_params
from kubeai_tpu_torch.models import gemma as tg
from kubeai_tpu_torch.models import llama as tl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 on both sides through two layers, sums in different orders.
ATOL = 1e-4
WORLDS = (2, 4)
JOIN_S = 180
READY_S = 120
TOK = ByteTokenizer()
# The served vectors of a bf16 checkpoint over two ranks against one rank:
# each element within BF16_ATOL, each vector's cosine at least BF16_MIN_COS.
BF16_ATOL = 2e-3
BF16_MIN_COS = 0.9999
TEXTS = ["hi", "The quick brown fox jumps over the lazy dog.", "x" * 70]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs thousands of tiny ops: one intra-op thread
    keeps them from spinning against the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(family: str):
    """(JAX config, JAX params, numpy tree) in f32; qwen's q/k/v biases
    drawn nonzero and its embeddings tied (the tree holds one array)."""
    extra = dict(attention_bias=True, tie_word_embeddings=True) if family == "qwen" else {}
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32, **extra)
    tree = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(7)))
    tree["layers"]["wq"] = tree["layers"]["wq"] * 10
    tree["layers"]["wk"] = tree["layers"]["wk"] * 10
    rng = np.random.default_rng(8)
    for name in ("bq", "bk", "bv"):
        if name in tree["layers"]:
            tree["layers"][name] = rng.normal(0, 0.1, tree["layers"][name].shape).astype(
                np.float32)
    if jcfg.tie_word_embeddings:
        tree["lm_head"] = tree["embed"]
    return jcfg, jax.tree.map(jnp.asarray, tree), tree


def _inputs(jcfg) -> dict:
    rng = np.random.default_rng(9)
    lengths = np.array([40, 17, 1, 33], np.int32)
    tokens = np.zeros((4, 48), np.int32)
    for row, n in enumerate(lengths):
        tokens[row, :n] = rng.integers(0, jcfg.vocab_size, n)
    x = rng.normal(0, 1, (2, 24, jcfg.hidden_size)).astype(np.float32)
    return dict(tokens=tokens, lengths=lengths, trunk_x=x,
                prompt=rng.integers(1, jcfg.vocab_size, 11).tolist())


@pytest.fixture(scope="module")
def models():
    return {family: _model(family) for family in ("llama", "qwen")}


@pytest.fixture(scope="module")
def worlds(models, tmp_path_factory):
    """The worlds of 2 and 4 ranks, started at once, and the JAX side
    computed while they run; then every rank's results."""
    root = tmp_path_factory.mktemp("embed_tp")
    cases = []
    for family, (jcfg, _, tree) in models.items():
        cases.append(dict(name=family, family=family, tree=tree, **_inputs(jcfg),
                          config={f.name: getattr(jcfg, f.name)
                                  for f in dataclasses.fields(jcfg) if f.name != "dtype"}))
    inputs = root / "inputs.pkl"
    inputs.write_bytes(pickle.dumps(dict(cases=cases)))
    ctx = multiprocessing.get_context("spawn")
    spawned = {}
    for world in WORLDS:
        outs = [root / f"w{world}_rank{r}.pkl" for r in range(world)]
        procs = [ctx.Process(target=torch_embeddings_tp_ranks.run, daemon=True, args=(
            r, world, str(root / f"rdv{world}"), str(inputs), str(outs[r])))
            for r in range(world)]
        for p in procs:
            p.start()
        spawned[world] = (procs, outs)
    try:
        want = {}
        for family, (jcfg, jp, _) in models.items():
            inp = _inputs(jcfg)
            lp = {k: v[1] for k, v in jp["layers"].items()}
            eng = JEngine("llama", jcfg, jp, cfg=JEngineConfig(
                cache_dtype=jnp.float32, step_overlap="off", **torch_embeddings_tp_ranks.ENGINE))
            want[family] = dict(
                hidden_states=np.asarray(jl.hidden_states(
                    jp, jcfg, jnp.asarray(inp["tokens"]), jnp.asarray(inp["lengths"]))),
                trunk_layer=np.asarray(jl.trunk_layer(jnp.asarray(inp["trunk_x"]), lp, jcfg)),
                stream=eng.generate([inp["prompt"]],
                                    JSamplingParams(temperature=0.0, max_tokens=6))[0])
        got = {}
        deadline = time.monotonic() + JOIN_S
        for world, (procs, paths) in spawned.items():
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
            assert [p.exitcode for p in procs] == [0] * world, f"world {world} exit codes"
            got[world] = [pickle.loads(path.read_bytes()) for path in paths]
    finally:
        for procs, _ in spawned.values():
            for p in procs:
                if p.is_alive():
                    p.kill()
    return got, want


CASES = [(w, f, fn) for w in WORLDS for f in ("llama", "qwen")
         for fn in ("hidden_states", "trunk_layer")]


@pytest.mark.parametrize("world,family,fn", CASES,
                         ids=[f"tp{w}-{f}-{fn}" for w, f, fn in CASES])
def test_sharded_trunk_matches_jax(worlds, world, family, fn):
    got, want = worlds
    for rank, res in enumerate(got[world]):
        a = res[family][fn]
        assert a.dtype == np.float32 and a.shape == want[family][fn].shape
        np.testing.assert_allclose(a, want[family][fn], atol=ATOL, rtol=0,
                                   err_msg=f"rank {rank}")
        np.testing.assert_array_equal(a, got[world][0][family][fn])
    if fn == "hidden_states":
        norms = np.linalg.norm(got[world][0][family][fn], axis=-1)
        np.testing.assert_allclose(norms, 1.0, atol=1e-5)


LOCKSTEP_CASES = [(w, f) for w in WORLDS for f in ("llama", "qwen")]


@pytest.mark.parametrize("world,family", LOCKSTEP_CASES,
                         ids=[f"tp{w}-{f}" for w, f in LOCKSTEP_CASES])
def test_lockstep_embed_op_over_ranks(worlds, world, family):
    got, want = worlds
    r0 = got[world][0][family]
    np.testing.assert_array_equal(r0["lockstep"], r0["hidden_states"])
    assert r0["stream"] == want[family]["stream"] and len(r0["stream"]) == 6
    assert {r[family]["digest"] for r in got[world]} == {r0["digest"]}


# ---- in one process: the op's descriptor and the server's gates --------------------


@pytest.fixture
def world1(tmp_path):
    """A world-1 gloo group (the lockstep broadcast's group)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=30))
    yield
    dist.destroy_process_group()


ENGINE = dict(num_slots=2, max_seq_len=256, page_size=16, decode_chunk=4,
              cache_dtype=torch.float32)


def _llama():
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=TOK.vocab_size),
                              dtype=torch.float32)
    return cfg, tl.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")


def test_embed_descriptor_keeps_the_jax_layout(world1, monkeypatch):
    cfg, params = _llama()
    ls = mh.LockstepEngine(Engine("llama", cfg, params, device="cpu",
                                  cfg=EngineConfig(**ENGINE)))
    sent = []
    real = mh._broadcast
    monkeypatch.setattr(mh, "_broadcast", lambda d, g, is_source: sent.append(d) or real(
        d, g, is_source))
    tokens = torch.tensor([[5, 6, 7, 0], [8, 9, 0, 0]])
    vecs = ls.embed(tokens, torch.tensor([3, 2]))
    desc, payload = sent
    want = jmh._control_zeros()
    assert {k: (v.shape, v.dtype) for k, v in desc.items()} == {
        k: (v.shape, v.dtype) for k, v in want.items()}
    assert desc["header"].tolist() == [0, 0, 0, 0, mh._EMBED]
    assert desc["meta"][0, :2].tolist() == [2, 4]
    assert payload.dtype == np.int64 and payload.tolist() == [[5, 6, 7, 0, 3], [8, 9, 0, 0, 2]]
    np.testing.assert_array_equal(
        vecs.numpy(), tl.hidden_states(params, cfg, tokens, torch.tensor([3, 2])).numpy())
    assert ls.inner._next_rid == 0  # no step, no admission


def _serve(engine, parallel):
    srv = EngineServer(engine, TOK, "m", port=0, parallel=parallel)
    srv.start()
    return srv


@pytest.mark.parametrize("processes", [1, 2])
def test_server_on_a_lockstep_engine(world1, processes):
    """One process: /v1/embeddings through the lockstep op, equal to an
    unsharded server's; several: the JAX server's 400."""
    cfg, params = _llama()
    ls = mh.LockstepEngine(Engine("llama", cfg, params, device="cpu",
                                  cfg=EngineConfig(**ENGINE)))
    plain = Engine("llama", cfg, params, device="cpu", cfg=EngineConfig(**ENGINE))
    srv = _serve(ls, {"processes": processes, "lockstep": True})
    ref = _serve(plain, {})
    try:
        status, raw = http_post(f"127.0.0.1:{srv.port}", "/v1/embeddings", {"input": TEXTS})
        if processes > 1:
            assert (status, json.loads(raw)) == (400, {"error": {
                "message": "embeddings not supported on multi-host replicas"}})
            return
        assert status == 200
        want = json.loads(http_post(f"127.0.0.1:{ref.port}", "/v1/embeddings",
                                    {"input": TEXTS})[1])
        assert json.loads(raw) == want
    finally:
        srv.stop()
        ref.stop()


def test_gemma_on_a_one_process_slice_answers_its_400(world1):
    cfg = dataclasses.replace(tg.GemmaConfig.tiny(vocab_size=512), dtype=torch.float32)
    params = tg.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ls = mh.LockstepEngine(Engine("gemma", cfg, params, device="cpu",
                                  cfg=EngineConfig(**ENGINE)))
    srv = _serve(ls, {"processes": 1, "lockstep": True})
    try:
        status, raw = http_post(f"127.0.0.1:{srv.port}", "/v1/embeddings", {"input": "x"})
        assert (status, json.loads(raw)) == (400, {"error": {
            "message": "model family gemma has no embedding support"}})
    finally:
        srv.stop()
    with pytest.raises(ValueError, match="gemma has no embedding support"):
        ls.embed(torch.zeros((1, 4), dtype=torch.long), torch.tensor([4]))


# ---- main over two ranks against an unsharded server ---------------------------------


SMALL_LLAMA = {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
               "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_main_over_two_ranks_serves_embeddings(tmp_path):
    model_dir = write_llama_checkpoint(tmp_path / "llama", SMALL_LLAMA, seed=1)
    port = _free_port()
    log = tmp_path / "main.log"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", HF_HUB_OFFLINE="1",
               TRANSFORMERS_OFFLINE="1", USE_TF="0", USE_FLAX="0")
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "kubeai_tpu_torch.engine.server", "--model-url", model_dir,
             "--device", "cpu", "--host", "127.0.0.1", "--port", str(port), "--num-slots", "4",
             "--max-seq-len", "256", "--drain-timeout", "10", "--tpu-topology", "1x2"],
            cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT, start_new_session=True)
    # The unsharded server on the same checkpoint, as main loads it (bf16).
    cfg = tl.LlamaConfig.from_hf_dict(load_hf_config(model_dir))
    plain = Engine("llama", cfg, load_params("llama", model_dir, cfg, device="cpu"),
                   device="cpu", cfg=EngineConfig(num_slots=4, max_seq_len=256))
    ref = _serve(plain, {})
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
        status, raw = http_post(f"127.0.0.1:{port}", "/v1/embeddings", {"input": TEXTS})
        assert status == 200, raw
        got = json.loads(raw)
        want = json.loads(http_post(f"127.0.0.1:{ref.port}", "/v1/embeddings",
                                    {"input": TEXTS})[1])
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, log.read_text()[-3000:]
    finally:
        ref.stop()
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert (got["object"], got["usage"]) == (want["object"], want["usage"])
    assert len(got["data"]) == len(want["data"]) == len(TEXTS)
    for g, w in zip(got["data"], want["data"]):
        a, b = np.asarray(g["embedding"]), np.asarray(w["embedding"])
        assert g["index"] == w["index"] and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=BF16_ATOL, rtol=0)
        assert float(a @ b / np.linalg.norm(a) / np.linalg.norm(b)) >= BF16_MIN_COS
