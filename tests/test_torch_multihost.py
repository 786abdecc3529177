"""Lockstep serving of the port (kubeai_tpu_torch/engine/multihost.py) and
the entry point over ranks, against the JAX package, on the CPU.

1. `LockstepEngine` in one process over a world-1 gloo group: the
   descriptor's layout is the JAX module's and round-trips through the
   broadcast; admissions past MAX_ADMITS stay buffered; a cancel that
   races a step is resolved; an unload is refused while its admission is
   buffered; a bad adapter is refused before any broadcast; continuations
   are refused and step_overlap="on" raises, in JAX's words; the virtual
   rids map back.
2. Lockstep over two ranks (spawned; tests/torch_multihost_ranks.py,
   which never imports JAX): rank 0 drives the legs of the JAX package's
   tests/integration/test_multihost_serving.py on tiny llama at tp=2
   (seeded sampling, a cancel in mid-flight, an adapter loaded through
   the broadcast and used, the prefix-cache pair) and rank 1 runs
   worker_loop; every stream equals the unsharded JAX engine's in f32,
   and rank 1's stream digest equals rank 0's.
3. Rank-local loading: `load_params(shard=ShardPlan(...))` of llama,
   qwen2 and mixtral checkpoints at tp 2 and 4, in bf16 and with int8
   weights, equals `Engine._shard` of the full load bit for bit, on every
   rank (torch's fake process group, one process).
4. `main` end to end: `--tpu-topology 1x2` in one process and as two
   processes (`--num-processes 2 --dcn-coordinator`): unary and streamed
   greedy and seeded chat, an adapter loaded and used, equal to the
   unsharded port's engine and the JAX engine on the same bf16
   checkpoint; /v1/embeddings served in one process through the lockstep
   op (equal to the SPMD oracle's hidden_states) and refused in two with
   the JAX server's 400; the refusal of `kubeai_resume`; the worker
   process's /health; SIGTERM ends every rank
   with exit 0; a killed worker ends rank 0 nonzero; `--step-overlap on`
   and a slice's refused features exit at boot.
5. Snapshots under a mesh: a mesh-free snapshot misses on a tp rank, and
   a rank restores only its own shard.
"""

import dataclasses
import datetime
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
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

import torch_multihost_ranks as ranks_mod
from testutil import http_get, http_post
from torch_mixtral_fixtures import hf_config as mixtral_hf_config
from torch_mixtral_fixtures import write_mixtral_checkpoint

from kubeai_tpu.engine import Engine as JEngine
from kubeai_tpu.engine import EngineConfig as JEngineConfig
from kubeai_tpu.engine import multihost as jmh
from kubeai_tpu.engine.lora_weights import load_peft_adapter as j_load_peft_adapter
from kubeai_tpu.engine.sampling import SamplingParams as JSamplingParams
from kubeai_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from kubeai_tpu.engine.weights import load_params as j_load_params
from kubeai_tpu.models import llama as jl
from kubeai_tpu.models.registry import get_model_family as j_family
from kubeai_tpu_torch.engine import Engine, EngineConfig, SamplingParams
from kubeai_tpu_torch.engine import multihost as mh
from kubeai_tpu_torch.engine.coldstart import ColdStartManager, mesh_signature
from kubeai_tpu_torch.engine.engine import StepOverlapUnsupported
from kubeai_tpu_torch.engine.lora_weights import load_peft_adapter
from kubeai_tpu_torch.engine.quantization import quantize_params
from kubeai_tpu_torch.engine.server import main, parse_args, resolve_ranks
from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
from kubeai_tpu_torch.engine.weights import ShardPlan, load_hf_config, load_params
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.models.registry import get_model_family
from kubeai_tpu_torch.parallel.collectives import TpLayout
from kubeai_tpu_torch.parallel.mesh import MeshConfig, build_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPROCESS_ENV = dict(os.environ, HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1", USE_TF="0",
                      USE_FLAX="0", PYTHONPATH=REPO, OMP_NUM_THREADS="1")
# Seconds the spawned world and each served process may take.
JOIN_S = 180
READY_S = 120


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs thousands of tiny ops: one intra-op thread
    keeps them from spinning against the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_f32():
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32)
    return cfg, tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


# ---- 1. LockstepEngine in one process ----------------------------------------


@pytest.fixture
def world1(tmp_path):
    """A world-1 gloo group (the lockstep broadcast's group)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=30))
    yield
    dist.destroy_process_group()


def _lockstep(**ecfg):
    cfg, params = _tiny_f32()
    kw = dict(num_slots=4, max_seq_len=64, page_size=8, decode_chunk=4,
              cache_dtype=torch.float32, step_overlap="auto")
    kw.update(ecfg)
    return mh.LockstepEngine(Engine("llama", cfg, params, device="cpu",
                                    cfg=EngineConfig(**kw)))


def test_descriptor_layout_is_the_jax_modules(world1):
    want, got = jmh._control_zeros(), mh._control_zeros()
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == {
        k: (v.shape, v.dtype) for k, v in want.items()}
    assert (mh.MAX_ADMITS, mh.MAX_CANCELS, mh._META_COLS) == (
        jmh.MAX_ADMITS, jmh.MAX_CANCELS, jmh._META_COLS)
    name = "tenant-ä"
    np.testing.assert_array_equal(mh._encode_name(name), jmh._encode_name(name))
    assert mh._decode_name(mh._encode_name(name)) == name
    with pytest.raises(ValueError, match="longer than 64 utf-8 bytes"):
        mh._encode_name("x" * 65)
    got["header"][:] = [3, 1, 1, 0, 2]
    got["floats"][0] = [0.8, 0.9]
    got["adapter_name"] = mh._encode_name(name)
    back = mh._broadcast(got, None, is_source=True)
    for k in got:
        np.testing.assert_array_equal(back[k], got[k])
        assert back[k].dtype == got[k].dtype
    tokens = np.arange(24, dtype=np.int32).reshape(2, 12)
    np.testing.assert_array_equal(mh._broadcast(tokens, None, is_source=True), tokens)


def test_admissions_past_max_stay_buffered(world1):
    ls = _lockstep(num_slots=12)
    sp = SamplingParams(temperature=0.0, max_tokens=2)
    rids = [ls.add_request([1, 2, 3 + i], sp) for i in range(mh.MAX_ADMITS + 3)]
    assert rids == list(range(mh.MAX_ADMITS + 3))
    ls.step()
    assert len(ls._adds) == 3
    assert ls.inner._next_rid == mh.MAX_ADMITS
    assert ls.num_pending == 3 + ls.inner.num_pending
    ls.step()
    assert not ls._adds and ls.inner._next_rid == mh.MAX_ADMITS + 3


def test_virtual_rids_map_back_and_equal_the_inner_engine(world1):
    ls = _lockstep()
    cfg, params = _tiny_f32()
    plain = Engine("llama", cfg, params, device="cpu", cfg=EngineConfig(
        num_slots=4, max_seq_len=64, page_size=8, decode_chunk=4,
        cache_dtype=torch.float32, step_overlap="off"))
    prompts = [[1, 2, 3, 4], [9, 8, 7], [5, 6]]
    sp = SamplingParams(temperature=0.8, top_k=16, max_tokens=8, seed=42)
    # A first request offsets the virtual rids from the inner ones.
    ls.generate([[7, 7]], SamplingParams(temperature=0.0, max_tokens=3))
    plain.generate([[7, 7]], SamplingParams(temperature=0.0, max_tokens=3))
    assert ls.generate(prompts, sp) == plain.generate(prompts, sp)
    assert not ls._rid_map  # finished mappings are pruned


def test_cancel_racing_a_step_is_resolved(world1):
    ls = _lockstep()
    sp = SamplingParams(temperature=0.0, max_tokens=40)
    rid = ls.add_request([3, 1, 4, 1, 5], sp)
    # The admission batch left the buffer but is not mapped yet.
    with ls._lock:
        batch, ls._adds = ls._adds, []
    assert ls.cancel(rid) and ls._unresolved_cancels == [rid]
    with ls._lock:
        ls._adds = batch + ls._adds
    ls.step()  # resolves the cancel: the entry is tombstoned before broadcast
    assert ls._unresolved_cancels == [] and ls.inner._next_rid == 0
    other = ls.add_request([2, 7], sp)
    got = [e for e in ls.step() if e.rid == other]
    assert got and ls.cancel(other)
    ls.step()
    while ls.has_work():
        ls.step()
    assert other not in ls._rid_map and not ls.cancel(99)


def test_unload_refused_while_admission_buffered(world1):
    ls = _lockstep(max_adapters=1)
    cfg = ls.model_cfg
    rng = np.random.default_rng(0)
    w = {t: (rng.standard_normal((cfg.num_layers, i, 4)).astype(np.float32),
             rng.standard_normal((cfg.num_layers, 4, o)).astype(np.float32))
         for t, (i, o) in tl.lora_dims(cfg).items()}
    ls.load_adapter("a", w)
    ls.add_request([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=2), adapter="a")
    with pytest.raises(RuntimeError, match="has queued requests; retry after they admit"):
        ls.unload_adapter("a")
    while ls.has_work():
        ls.step()
    assert ls.unload_adapter("a") and ls.loaded_adapters() == []


def test_bad_adapter_refused_before_any_broadcast(world1, monkeypatch):
    ls = _lockstep(max_adapters=1)
    cfg = ls.model_cfg
    sent = []
    real = mh._broadcast
    monkeypatch.setattr(mh, "_broadcast", lambda d, g, is_source: sent.append(1) or real(
        d, g, is_source))
    A = np.zeros((cfg.num_layers, cfg.hidden_size, 17), np.float32)
    B = np.zeros((cfg.num_layers, 17, cfg.num_heads * cfg.head_size), np.float32)
    with pytest.raises(ValueError, match="adapter rank 17 > max_lora_rank 16"):
        ls.load_adapter("x", {"wq": (A, B)})
    with pytest.raises(KeyError, match="unknown LoRA target 'w_up'"):
        ls.load_adapter("x", {"w_up": (A[..., :4], B[:, :4])})
    ls.load_adapter("x", {"wq": (A[..., :4], B[:, :4])})
    assert len(sent) == 2  # the descriptor and the payload
    with pytest.raises(RuntimeError, match=r"adapter capacity \(1\) exhausted"):
        ls.load_adapter("y", {"wq": (A[..., :4], B[:, :4])})
    ls.add_request([1, 2], SamplingParams(temperature=0.0, max_tokens=8), adapter="x")
    ls.step()
    with pytest.raises(RuntimeError, match="has in-flight requests"):
        ls.load_adapter("x", {"wq": (A[..., :4], B[:, :4])})
    assert len(sent) == 4  # the step's descriptor and tokens only
    off = _lockstep()
    with pytest.raises(ValueError, match="LoRA is disabled"):
        off.load_adapter("x", {"wq": (A[..., :4], B[:, :4])})


def test_refusals_in_jax_words(world1):
    with pytest.raises(StepOverlapUnsupported, match="lockstep") as e:
        _lockstep(step_overlap="on")
    cfg, params = _tiny_f32()
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32)
    with pytest.raises(Exception) as je:
        jmh.LockstepEngine(JEngine("llama", jcfg, jl.init_params(jcfg, jax.random.PRNGKey(0)),
                                   cfg=JEngineConfig(num_slots=2, max_seq_len=64,
                                                     step_overlap="on")))
    assert str(e.value) == str(je.value)
    ls = _lockstep()
    assert ls.inner._overlap is False and ls.is_lockstep
    with pytest.raises(ValueError, match="stream resume is not supported on multi-host"):
        ls.add_request([1, 2], resume_tokens=[3])
    with pytest.raises(ValueError, match="empty prompt"):
        ls.add_request([])
    with pytest.raises(KeyError, match="not loaded"):
        _lockstep(max_adapters=1).add_request([1], adapter="nope")


# ---- 2. lockstep over two ranks ------------------------------------------------


LOCKSTEP_ENGINE = dict(num_slots=4, max_seq_len=64, page_size=16, decode_chunk=4,
                       max_adapters=1, prefill_chunk=16, prefix_cache=True)


def _lockstep_spec():
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(0)))
    for name in ("wq", "wk"):
        tree["layers"][name] = tree["layers"][name] * 10
    arng = np.random.default_rng(5)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32)
    adapter = {t: ((0.5 * arng.standard_normal((jcfg.num_layers, i, 4))).astype(np.float32),
                   (0.5 * arng.standard_normal((jcfg.num_layers, 4, o))).astype(np.float32))
               for t, (i, o) in tl.lora_dims(tcfg).items()}
    return jcfg, dict(
        tree=tree, engine=LOCKSTEP_ENGINE, adapter=adapter,
        config={f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
                if f.name != "dtype"},
        prompts=[[1, 2, 3, 4], [9, 8, 7], [5, 6]],
        sampling=dict(temperature=0.8, top_k=16, max_tokens=8, seed=42),
        cancel_prompt=[3, 1, 4, 1, 5], lora_prompt=[2, 4, 6, 8],
        apc_prompts=[[7] * 20 + [1, 2, 3], [7] * 20 + [4, 5]])


@pytest.fixture(scope="module")
def lockstep_world(tmp_path_factory, checkpoints, references):
    """The two ranks' results, and the unsharded JAX engine's streams of
    the same legs. The ranks also run the served runs' SPMD oracle."""
    root = tmp_path_factory.mktemp("lockstep")
    jcfg, spec = _lockstep_spec()
    tok = ByteTokenizer()
    spec["served"] = dict(
        model_dir=checkpoints["llama"], adapter_dir=references[0], engine=SERVED_ENGINE,
        embed_inputs=EMBED_INPUTS, requests=[(tok.apply_chat_template(b["messages"]),
                   dict(temperature=b["temperature"], max_tokens=b["max_tokens"],
                        seed=b.get("seed")), b.get("model"), bool(b.get("stream")))
                  for b in BODIES])
    inputs = root / "inputs.pkl"
    inputs.write_bytes(pickle.dumps(spec))
    ctx = multiprocessing.get_context("spawn")
    outs = [root / f"rank{r}.pkl" for r in range(2)]
    procs = [ctx.Process(target=ranks_mod.run_lockstep, daemon=True, args=(
        r, 2, str(root / "rdv"), str(inputs), str(outs[r]))) for r in range(2)]
    for p in procs:
        p.start()
    # The oracle while the ranks run: one unsharded JAX engine in f32.
    jeng = JEngine("llama", jcfg, jax.tree.map(jnp.asarray, spec["tree"]),
                   cfg=JEngineConfig(cache_dtype=jnp.float32, step_overlap="off",
                                     **LOCKSTEP_ENGINE))
    lsp = JSamplingParams(temperature=0.0, max_tokens=8)
    ref = {"outs": jeng.generate(spec["prompts"], JSamplingParams(**spec["sampling"]))}
    jeng.load_adapter("fin", spec["adapter"])
    ref["lora"] = jeng.generate([spec["lora_prompt"]], lsp, adapter="fin")[0]
    ref["base"] = jeng.generate([spec["lora_prompt"]], lsp)[0]
    jeng.unload_adapter("fin")
    ref["apc"] = jeng.generate(spec["apc_prompts"], lsp)
    deadline = time.monotonic() + JOIN_S
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        assert [p.exitcode for p in procs] == [0, 0], "the lockstep ranks failed"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    return [pickle.loads(o.read_bytes()) for o in outs], ref


@pytest.mark.parametrize("leg", ["outs", "lora", "base", "apc"])
def test_lockstep_streams_equal_the_unsharded_jax_engine(lockstep_world, leg):
    (r0, _), ref = lockstep_world
    assert r0[leg] == ref[leg]
    if leg == "outs":
        assert len(r0[leg]) == 3 and all(len(s) == 8 for s in r0[leg])
    if leg == "lora":
        assert r0["lora"] != r0["base"]  # the adapter moves the stream


def test_lockstep_cancel_and_ranks_agree(lockstep_world):
    (r0, r1), _ = lockstep_world
    # One admission + two chunks of 4, then the cancel, well short of 40.
    assert r0["cancel_tokens"] == 9
    assert r0["unloaded"] is True
    assert r0["digest"] == r1["digest"]
    assert r0["apc_stats"] == r1["apc_stats"] and r0["apc_stats"]["hit_tokens"] >= 16
    # Each rank holds its half of wq's columns and of the adapter's B.
    assert r0["wq_columns"] == r1["wq_columns"] == 4 * 16 // 2
    assert r0["lora_b_columns"] == r1["lora_b_columns"] == 4 * 16 // 2


def test_admission_of_an_unloaded_adapter_slot_raises(world1):
    """A descriptor that names an adapter slot this rank has not loaded
    (its state has diverged from rank 0's) raises rather than serve the
    base model."""
    ls = _lockstep(max_adapters=1)
    desc = mh._control_zeros()
    desc["header"][0] = 1
    desc["meta"][0] = (3, 0, 0, 1, 2)  # plen, seed, top_k, adapter slot 1, max_tokens
    tokens = np.zeros((mh.MAX_ADMITS, 64), np.int32)
    tokens[0, :3] = (1, 2, 3)
    with pytest.raises(RuntimeError, match="adapter slot 1, which this rank has not loaded"):
        mh._apply_descriptor(ls.inner, desc, tokens, do_step=True)


def test_adapter_load_failing_on_a_worker_ends_the_world(tmp_path):
    """An adapter load that rank 0 validated and broadcast but that fails
    on rank 1 ends rank 1 with a nonzero exit, and rank 0's next
    broadcast fails: neither serves on with the ranks' models apart."""
    _, spec = _lockstep_spec()
    inputs = tmp_path / "inputs.pkl"
    inputs.write_bytes(pickle.dumps(spec))
    ctx = multiprocessing.get_context("spawn")
    outs = [tmp_path / f"rank{r}.pkl" for r in range(2)]
    procs = [ctx.Process(target=ranks_mod.run_diverged_load, daemon=True, args=(
        r, 2, str(tmp_path / "rdv"), str(inputs), str(outs[r]))) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        codes = [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    errors = [pickle.loads(o.read_bytes())["error"] for o in outs]
    assert codes[1] not in (None, 0) and "planted: adapter fin" in errors[1], (codes, errors)
    assert codes[0] not in (None, 0) and errors[0] is not None, (codes, errors)


# ---- 3. rank-local loading -------------------------------------------------------


SMALL_LLAMA = {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
               "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    return {
        "llama": ranks_mod.write_llama_checkpoint(root / "llama", SMALL_LLAMA, seed=1),
        "qwen": ranks_mod.write_llama_checkpoint(root / "qwen", SMALL_LLAMA, seed=2,
                                                 bias=True),
        "mixtral": write_mixtral_checkpoint(root / "mixtral", mixtral_hf_config(), seed=3),
    }


def _assert_trees_bit_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_bit_equal(got[k], want[k], f"{path}.{k}")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert torch.equal(got, want), path


LOAD_CASES = [(f, w, q) for f in ("llama", "qwen", "mixtral") for w in (2, 4)
              for q in (("", "int8") if f != "mixtral" else ("",))]


@pytest.mark.parametrize("family,world,quant", LOAD_CASES,
                         ids=[f"{f}-tp{w}-{q or 'bf16'}" for f, w, q in LOAD_CASES])
def test_rank_local_load_equals_engine_shard(checkpoints, family, world, quant):
    model_dir = checkpoints[family]
    hf = load_hf_config(model_dir)
    fam = get_model_family(hf["architectures"][0])
    cfg = fam.config_from_hf(hf)
    full = load_params(fam.name, model_dir, cfg, device="cpu")
    if quant:
        full = quantize_params(full)
    for rank in range(world):
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
        try:
            mesh = build_mesh(MeshConfig(tp=world))
            # Engine._shard on the engine's own attributes, without the
            # tp group the fake backend cannot build.
            stub = SimpleNamespace(_tp=TpLayout.of(mesh), model_cfg=cfg, family=fam,
                                   cfg=EngineConfig(quantization=quant))
            want = Engine._shard(stub, full, mesh)
            got = load_params(fam.name, model_dir, cfg, device="cpu",
                              shard=ShardPlan(fam, cfg, mesh, quantize=bool(quant)))
        finally:
            dist.destroy_process_group()
        _assert_trees_bit_equal(got, want, f"rank {rank}")
        if quant:
            for name in ("wo", "w_down"):  # N-major, as the kernel reads it
                assert got["layers"][name]["w8"].transpose(-1, -2).is_contiguous()
        if "lm_head" in got and got["lm_head"].shape == got["embed"].shape:
            assert (got["lm_head"] is got["embed"]) == (full["lm_head"] is full["embed"])


@pytest.mark.parametrize("axis,start,length", [(0, 16, 40), (1, 16, 32), (1, 48, 16)])
def test_stored_slice_reads_the_slice(checkpoints, monkeypatch, axis, start, length):
    """A slice read in blocks of a few rows (the last one short) equals the
    narrowed tensor, bit for bit; a 1-D tensor's slice too."""
    from kubeai_tpu_torch.engine import weights

    monkeypatch.setattr(weights, "SLICE_BLOCK", 64 * 2 * 7)  # 7 rows of 64 bf16
    lazy = weights.LazyTensors(checkpoints["llama"])
    for name in ("model.embed_tokens.weight", "model.layers.0.self_attn.o_proj.weight"):
        want = lazy.stored(name).narrow(axis, start, length)
        got = lazy.stored_slice(name, axis, start, length)
        assert got.dtype == want.dtype and torch.equal(got, want)
    bias = weights.LazyTensors(checkpoints["qwen"])
    name = "model.layers.1.self_attn.k_proj.bias"
    assert torch.equal(bias.stored_slice(name, 0, 16, 16), bias.stored(name)[16:32])


def test_rank_local_load_refuses_an_unsharded_family(tmp_path):
    """A family with no sharding specs: whisper (gemma was one until its
    specs were ported; tests/test_torch_gemma_tp.py loads its shards)."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        mesh = build_mesh(MeshConfig(tp=2))
        with pytest.raises(Exception, match="no sharding specs"):
            ShardPlan(get_model_family("whisper"), None, mesh)
    finally:
        dist.destroy_process_group()


# ---- 4. main end to end -----------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# The served runs' engine (the flags below, lockstep's overlap off).
SERVED_ENGINE = dict(num_slots=4, max_seq_len=256, max_adapters=4, step_overlap="off")
SERVE_FLAGS = ["--device", "cpu", "--host", "127.0.0.1", "--num-slots", "4",
               "--max-seq-len", "256", "--drain-timeout", "10"]
BODIES = [
    {"messages": [{"role": "user", "content": "Hello there"}], "max_tokens": 8,
     "temperature": 0},
    {"messages": [{"role": "user", "content": "The quick brown fox"}], "max_tokens": 8,
     "temperature": 0.8, "seed": 3, "stream": True},
    {"messages": [{"role": "user", "content": "Hello there"}], "max_tokens": 8,
     "temperature": 0, "model": "tenant", "stream": True},
]


def _start(model_dir, tmp_path, name, extra):
    log = open(tmp_path / f"{name}.log", "w")
    return subprocess.Popen(
        [sys.executable, "-m", "kubeai_tpu_torch.engine.server", "--model-url", model_dir,
         *SERVE_FLAGS, *extra], cwd=REPO, env=SUBPROCESS_ENV, stdout=log,
        stderr=subprocess.STDOUT, start_new_session=True)


def _wait_ready(procs, port, logs):
    deadline = time.monotonic() + READY_S
    while time.monotonic() < deadline:
        for p, log in zip(procs, logs):
            assert p.poll() is None, f"exited {p.returncode}:\n{log.read_text()[-3000:]}"
        try:
            if http_get(f"127.0.0.1:{port}", "/health", timeout=2)[0] == 200:
                return
        except OSError:
            pass
        time.sleep(0.3)
    raise AssertionError("not ready:\n" + "\n".join(log.read_text()[-2000:] for log in logs))


def _chat(port, body):
    """(status, token ids or text, raw JSON or chunks) of one request."""
    status, raw = http_post(f"127.0.0.1:{port}", "/v1/chat/completions", body, timeout=60)
    if status != 200:
        return status, None, json.loads(raw)
    if not body.get("stream"):
        res = json.loads(raw)
        return status, res["choices"][0]["message"]["content"], res
    chunks = [json.loads(ln[6:]) for ln in raw.decode().splitlines()
              if ln.startswith("data: ") and ln != "data: [DONE]"]
    return status, [t for c in chunks for t in c.get("token_ids", ())], chunks


def _kill_all(procs):
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()


@pytest.fixture(scope="module")
def references(checkpoints, tmp_path_factory):
    """The adapter's directory, and the three requests' streams (text for
    the unary one) from the unsharded port engine and the unsharded JAX
    engine on the bf16 llama checkpoint, each request run alone."""
    model_dir = checkpoints["llama"]
    adapter_dir = ranks_mod.write_peft_adapter(
        tmp_path_factory.mktemp("adapter") / "tenant",
        tl.LlamaConfig.from_hf_dict(load_hf_config(model_dir)), seed=4)
    hf = load_hf_config(model_dir)
    tcfg = tl.LlamaConfig.from_hf_dict(hf)
    jfam = j_family("LlamaForCausalLM")
    jcfg = jfam.config_from_hf(hf)
    port = Engine("llama", tcfg, load_params("llama", model_dir, tcfg, device="cpu"),
                  device="cpu", eos_token_ids=ByteTokenizer().eos_token_ids,
                  cfg=EngineConfig(**SERVED_ENGINE))
    port.load_adapter("tenant", load_peft_adapter(adapter_dir, tcfg))
    jeng = JEngine("llama", jcfg, j_load_params("llama", model_dir, jcfg),
                   eos_token_ids=JByteTokenizer().eos_token_ids,
                   cfg=JEngineConfig(**SERVED_ENGINE))
    jeng.load_adapter("tenant", j_load_peft_adapter(adapter_dir, jcfg))
    tok = ByteTokenizer()
    out = {"port": [], "jax": []}
    for body in BODIES:
        ids = tok.apply_chat_template(body["messages"])
        adapter = body.get("model")
        for name, eng, sp in (("port", port, SamplingParams), ("jax", jeng, JSamplingParams)):
            params = sp(temperature=body["temperature"], max_tokens=body["max_tokens"],
                        seed=body.get("seed"))
            stream = eng.generate([ids], params, adapter=adapter)[0]
            out[name].append(stream if body.get("stream") else tok.decode(stream))
    return adapter_dir, out


# The served runs' /v1/embeddings inputs.
EMBED_INPUTS = ["hi", "The quick brown fox"]


def _drive(port, adapter_dir, processes: int):
    """The served run: the two base requests, the adapter load, the adapter
    request, /v1/embeddings, then the lockstep refusals. A slice of one
    process serves the embeddings (through the lockstep op; returned for
    `_assert_served`), one of several answers the JAX server's 400."""
    got = []
    for body in BODIES[:2]:
        status, stream, _ = _chat(port, body)
        assert status == 200
        got.append(stream)
    status, raw = http_post(f"127.0.0.1:{port}", "/v1/load_lora_adapter",
                            {"lora_name": "tenant", "lora_path": adapter_dir})
    assert (status, json.loads(raw)) == (200, {"status": "loaded", "lora_name": "tenant"})
    status, stream, _ = _chat(port, BODIES[2])
    assert status == 200
    got.append(stream)
    status, raw = http_post(f"127.0.0.1:{port}", "/v1/embeddings", {"input": EMBED_INPUTS})
    vectors = None
    if processes > 1:
        assert (status, json.loads(raw)) == (
            400, {"error": {"message": "embeddings not supported on multi-host replicas"}})
    else:
        assert status == 200, raw
        vectors = [d["embedding"] for d in json.loads(raw)["data"]]
    status, _, res = _chat(port, {**BODIES[0], "kubeai_resume": {"token_ids": [72],
                                                                 "emitted": 1}})
    assert status == 400 and "stream resume is not supported on multi-host" in json.dumps(res)
    return got, vectors


def _assert_served(served, ref, lockstep_world):
    """A served run's streams equal the plain SPMD tp=2 oracle's on the same
    bf16 weights token for token, and its greedy ones the unsharded port
    and JAX engines' (which agree on all three). A seeded stream is held
    to the SPMD oracle only: in bf16 a tp rank rounds its partial sums
    before the all_reduce, which can move a sampled token. Served
    embeddings equal the oracle's hidden_states under its tp group."""
    got, vectors = served
    (r0, _), _ = lockstep_world
    assert ref["port"] == ref["jax"]
    assert got == r0["spmd"]
    if vectors is not None:
        assert vectors == r0["spmd_embed"]
    for body, have, want in zip(BODIES, got, ref["jax"]):
        if body["temperature"] == 0:
            assert have == want


def _digests(text: str) -> dict:
    """{rank: sha256} of the log's lockstep digest lines."""
    return dict(re.findall(r"lockstep digest: rank (\d+) .* sha256 (\w+)", text))


def test_main_two_ranks_in_one_process(checkpoints, references, lockstep_world, tmp_path):
    adapter_dir, ref = references
    port = _free_port()
    proc = _start(checkpoints["llama"], tmp_path, "one", ["--port", str(port),
                                                           "--tpu-topology", "1x2"])
    log = tmp_path / "one.log"
    try:
        _wait_ready([proc], port, [log])
        got = _drive(port, adapter_dir, processes=1)
        state = json.loads(http_get(f"127.0.0.1:{port}", "/v1/state")[1])
        assert state["parallel"] == {
            "topology": "1x2", "ranks": 2, "processes": 1, "process_id": 0,
            "ranks_per_process": 2, "device": "cpu", "backend": "gloo",
            "ranks_per_device": 2, "lockstep": True}
        assert state["adapters"] == ["tenant"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, log.read_text()[-3000:]
    finally:
        _kill_all([proc])
    _assert_served(got, ref, lockstep_world)
    digests = _digests(log.read_text())
    assert set(digests) == {"0", "1"} and len(set(digests.values())) == 1


def test_main_two_processes(checkpoints, references, lockstep_world, tmp_path):
    adapter_dir, ref = references
    ports = [_free_port(), _free_port()]
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [_start(checkpoints["llama"], tmp_path, f"p{i}", [
        "--port", str(ports[i]), "--tpu-topology", "1x2", "--num-processes", "2",
        "--process-id", str(i), "--dcn-coordinator", coordinator]) for i in range(2)]
    logs = [tmp_path / "p0.log", tmp_path / "p1.log"]
    try:
        _wait_ready(procs, ports[0], logs)
        # The worker process answers /health only.
        assert http_get(f"127.0.0.1:{ports[1]}", "/health")[0] == 200
        assert http_get(f"127.0.0.1:{ports[1]}", "/v1/models")[0] == 404
        got = _drive(ports[0], adapter_dir, processes=2)
        state = json.loads(http_get(f"127.0.0.1:{ports[0]}", "/v1/state")[1])
        assert state["parallel"]["processes"] == 2 and state["parallel"]["ranks_per_process"] == 1
        procs[0].send_signal(signal.SIGTERM)
        assert [p.wait(timeout=60) for p in procs] == [0, 0], logs[1].read_text()[-3000:]
    finally:
        _kill_all(procs)
    _assert_served(got, ref, lockstep_world)
    digests = {**_digests(logs[0].read_text()), **_digests(logs[1].read_text())}
    assert set(digests) == {"0", "1"} and len(set(digests.values())) == 1


def test_main_killed_worker_ends_rank_0(checkpoints, tmp_path):
    ports = [_free_port(), _free_port()]
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [_start(checkpoints["llama"], tmp_path, f"k{i}", [
        "--port", str(ports[i]), "--tpu-topology", "1x2", "--num-processes", "2",
        "--process-id", str(i), "--dcn-coordinator", coordinator]) for i in range(2)]
    logs = [tmp_path / "k0.log", tmp_path / "k1.log"]
    try:
        _wait_ready(procs, ports[0], logs)
        os.killpg(procs[1].pid, signal.SIGKILL)
        procs[1].wait()
        # Rank 0's next heartbeat (HEARTBEAT_S) fails.
        rc = procs[0].wait(timeout=60)
    finally:
        _kill_all(procs)
    text = logs[0].read_text()
    assert rc != 0 and "ending the replica" in text, text[-3000:]


def test_main_refuses_at_boot(checkpoints, tmp_path):
    model_dir = checkpoints["llama"]
    with pytest.raises(StepOverlapUnsupported, match="lockstep"):
        main(["--model-url", model_dir, "--device", "cpu", "--tpu-topology", "1x2",
              "--step-overlap", "on"])
    with pytest.raises(StepOverlapUnsupported, match="lockstep"):
        main(["--model-url", model_dir, "--device", "cpu", "--tpu-topology", "1x2",
              "--pipeline"])
    for extra in (["--role", "prefill"], ["--kv-sharing"], ["--draft-url", "/m"]):
        with pytest.raises(SystemExit, match="under a mesh.*ROADMAP A item 11a2"):
            main(["--model-url", model_dir, "--device", "cpu", "--tpu-topology", "2x2",
                  *extra])
    with pytest.raises(SystemExit, match="do not divide over 3 processes"):
        main(["--model-url", model_dir, "--device", "cpu", "--tpu-topology", "2x2",
              "--num-processes", "3", "--dcn-coordinator", "127.0.0.1:1"])
    with pytest.raises(SystemExit, match="give its --tpu-topology"):
        main(["--model-url", model_dir, "--device", "cpu", "--num-processes", "2"])


@pytest.mark.parametrize("argv,want", [
    (["--tpu-topology", "2x2"], (4, 1, 0, 4, "off")),
    (["--tpu-topology", "2x4", "--num-processes", "2", "--process-id", "1",
      "--dcn-coordinator", "10.0.0.1:8476"], (8, 2, 1, 4, "off")),
    (["--tpu-topology", "1x1"], (1, 1, 0, 1, "auto")),
])
def test_topology_flags_give_the_rank_layout(argv, want):
    args = parse_args(["--model-url", "/m", *argv])
    layout = resolve_ranks(args)
    assert (layout.world, layout.num_processes, layout.process_id, layout.local,
            args.step_overlap) == want
    assert layout.global_rank(layout.local - 1) == want[2] * want[3] + want[3] - 1


def test_topology_env_defaults(monkeypatch):
    monkeypatch.setenv("TPU_PROCESS_COUNT", "2")
    monkeypatch.setenv("TPU_PROCESS_ID", "1")
    monkeypatch.setenv("TPU_COORDINATOR", "10.0.0.1:8476")
    args = parse_args(["--model-url", "/m", "--tpu-topology", "2x2"])
    layout = resolve_ranks(args)
    assert (layout.num_processes, layout.process_id, layout.coordinator) == (
        2, 1, "10.0.0.1:8476")


# ---- 5. snapshots under a mesh ---------------------------------------------------


def test_snapshots_are_keyed_by_mesh_and_rank(tmp_path):
    url = f"file://{tmp_path / 'bucket'}"
    ecfg = EngineConfig(num_slots=2, max_seq_len=64)
    cfg, params = _tiny_f32()
    mesh_free = ColdStartManager(url, "m", ecfg, "cpu", work_dir=str(tmp_path / "w0"))
    assert mesh_free.maybe_publish(mesh_free.acquire_params(lambda: params))
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        mesh = build_mesh(MeshConfig(tp=2))
        sigs = [mesh_signature(mesh, r) for r in range(2)]
    finally:
        dist.destroy_process_group()
    assert sigs[0] == ["dp=1", "pp=1", "sp=1", "tp=2", "rank=0"] and sigs[0] != sigs[1]
    shards = [{"w": torch.full((2,), float(r))} for r in range(2)]
    boots = []
    for r in range(2):
        m = ColdStartManager(url, "m", ecfg, "cpu", work_dir=str(tmp_path / f"r{r}"),
                             mesh_sig=sigs[r])
        got = m.acquire_params(lambda r=r: shards[r])
        # A mesh-free snapshot never restores into a rank.
        assert m.tracker.events == ["absent"] and got is shards[r]
        assert m.maybe_publish(got)
        boots.append(m.fingerprint)
    assert len({mesh_free.fingerprint, *boots}) == 3
    for r in (1, 0):
        again = ColdStartManager(url, "m", ecfg, "cpu", work_dir=str(tmp_path / f"a{r}"),
                                 mesh_sig=sigs[r])
        got = again.acquire_params(lambda: pytest.fail("a rank's own snapshot must restore"))
        assert again.tracker.restored and torch.equal(got["w"], shards[r]["w"])
