"""LoRA adapters in kubeai_tpu_torch against the JAX package, on the CPU in
f32 at LlamaConfig.tiny() (the port's counterpart of tests/unit/
test_lora.py and of the adapter cases of test_prefix_cache.py and
test_engine_server.py).

- The math: `init_lora_buffers` (the JAX buffers carried across by
  `parity.lora_from_numpy`), `_lora_delta` on 2-D and 3-D inputs, and
  `prefill` (llama and qwen), `prefill_chunk`, `decode_step_paged` (both
  layouts) and `decode_verify_paged` with a mixed per-row adapter index:
  logits and pools within 1e-4 of the JAX functions.
- The weights: `lora_weights.load_peft_adapter` bit-equal to the JAX
  loader on PEFT directories written here (both key patterns, bf16 and
  f32 tensors, a missing layer) and the same refusals.
- The engine: greedy and seeded streams of a mix of base and adapter
  requests identical to the JAX engine's in the per_layer and fused
  layouts, with speculate=4, with chunked prefill and the prefix cache
  and on int8 pools, overlap on and off; merged weights, a mixed batch,
  capacity, the in-flight refusals and LoRA off; a reused adapter row
  never hits pages of the old weights; adapter handoffs cross from JAX to
  the port and back; a load, a reload and an unload write the buffers in
  place (the captured programs' addresses).
- The server: the adapter admin flow answers the JAX server's codes and
  bodies, and the operator's EngineClient drives it.

The JAX engines run each scenario once per module, with step_overlap off.
"""

import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from testutil import http_get, http_post
from torch_objstore_fakes import FakeS3

from kubeai_tpu.disagg import handoff as jhandoff
from kubeai_tpu.engine import Engine as JEngine
from kubeai_tpu.engine import EngineConfig as JEngineConfig
from kubeai_tpu.engine.lora_weights import load_peft_adapter as j_load_peft_adapter
from kubeai_tpu.engine.sampling import SamplingParams as JSamplingParams
from kubeai_tpu.engine.server import EngineServer as JEngineServer
from kubeai_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from kubeai_tpu.engine.weights import WeightLoadError as JWeightLoadError
from kubeai_tpu.models import llama as jl
from kubeai_tpu.operator.engine_client import EngineClient, EngineClientError
from kubeai_tpu_torch.disagg import handoff
from kubeai_tpu_torch.engine import Engine, EngineConfig, SamplingParams
from kubeai_tpu_torch.engine.lora_weights import load_peft_adapter
from kubeai_tpu_torch.engine.server import EngineServer
from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
from kubeai_tpu_torch.engine.weights import WeightLoadError, save_safetensors
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.models.registry import get_model_family
from kubeai_tpu_torch.parity import lora_from_numpy, params_from_numpy

TOK = ByteTokenizer()
# f32 on both sides through two layers, sums in different orders.
ATOL = 1e-4
BASE = dict(num_slots=4, max_seq_len=128, page_size=16, decode_chunk=4,
            max_adapters=2, max_lora_rank=8)
SCENARIOS = {
    "per_layer": {},
    "fused": dict(decode_kernel="fused"),
    "speculate": dict(speculate=4, spec_adaptive=False),
    "prefix": dict(prefill_chunk=16, prefix_cache=True),
    "int8": dict(kv_dtype="int8"),
}
SAMPLING = {
    "greedy": dict(temperature=0.0, max_tokens=10),
    "seeded": dict(temperature=0.8, top_k=16, top_p=0.9, max_tokens=10, seed=5),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs thousands of tiny ops: one intra-op thread
    keeps them from spinning against the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=TOK.vocab_size),
                               dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=TOK.vocab_size),
                               dtype=torch.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _weights(cfg, seed: int, targets, r: int, scale: float = 0.3) -> dict:
    """An adapter weight tree {target: (A [NL, in, r], B [NL, r, out])} in
    f32, drawn with numpy from `seed`."""
    rng = np.random.default_rng(seed)
    dims = tl.lora_dims(cfg)
    return {t: ((rng.standard_normal((cfg.num_layers, dims[t][0], r)) * scale).astype(np.float32),
                (rng.standard_normal((cfg.num_layers, r, dims[t][1])) * scale).astype(np.float32))
            for t in targets}


@pytest.fixture(scope="module")
def adapters(models):
    tcfg = models[2]
    return {"a1": _weights(tcfg, 1, ("wq", "wv"), 4),
            "a2": _weights(tcfg, 2, ("wk", "wo"), 8),
            "a3": _weights(tcfg, 3, tl.LORA_TARGETS, 8)}


# ---- the math --------------------------------------------------------------------


def test_init_lora_buffers_match_jax(models):
    jcfg, _, tcfg, _ = models
    for jc, tc, jdt, tdt in ((jcfg, tcfg, jnp.float32, torch.float32),
                             (jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny(),
                              jnp.bfloat16, torch.bfloat16)):
        want = jl.init_lora_buffers(jc, 3, 8)
        got = tl.init_lora_buffers(tc, 3, 8, device="cpu")
        assert tuple(got) == tl.LORA_TARGETS == jl.LORA_TARGETS
        assert set(got) == set(want)
        for t in tl.LORA_TARGETS:
            for name in ("A", "B"):
                w, g = want[t][name], got[t][name]
                assert w.dtype == jdt and g.dtype == tdt
                # Layer-major in the port: [NL, n, ...] against [n, NL, ...].
                assert tuple(g.shape) == (w.shape[1], w.shape[0], *w.shape[2:])
                assert g.is_contiguous() and not g.any()
        carried = lora_from_numpy(jax.tree.map(np.asarray, want), "cpu", tdt)
        for t in tl.LORA_TARGETS:
            for name in ("A", "B"):
                assert carried[t][name].shape == got[t][name].shape
                assert carried[t][name].dtype == tdt


@pytest.mark.parametrize("ndim", [2, 3])
def test_lora_delta_matches_jax(ndim):
    rng = np.random.default_rng(10 + ndim)
    B, S, n, din, r, dout = 5, 7, 3, 24, 8, 40
    x = rng.standard_normal((B, S, din) if ndim == 3 else (B, din)).astype(np.float32)
    A = rng.standard_normal((n, din, r)).astype(np.float32)
    Bw = rng.standard_normal((n, r, dout)).astype(np.float32)
    idx = np.array([0, 2, 1, 2, 0])
    want = np.asarray(jl._lora_delta(jnp.asarray(x), jnp.asarray(A), jnp.asarray(Bw),
                                     jnp.asarray(idx)))
    got = tl._lora_delta(torch.from_numpy(x), torch.from_numpy(A), torch.from_numpy(Bw),
                         torch.from_numpy(idx))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _family_models(family: str):
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32,
                               attention_bias=(family == "qwen"))
    tcfg = dataclasses.replace(get_model_family(family).tiny_config(), dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(1)))
    if family == "qwen":
        rng = np.random.default_rng(2)
        for b in ("bq", "bk", "bv"):  # non-zero biases: the delta comes after them
            tree["layers"][b] = (rng.standard_normal(tree["layers"][b].shape) * 0.1
                                 ).astype(np.float32)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tree, "cpu")


def _lora_pair(jcfg, seed: int = 6):
    """Random JAX adapter buffers (3 rows, rank 8; row 0 stays zero, "no
    adapter") and the port's copy of them."""
    rng = np.random.default_rng(seed)
    bufs = jax.tree.map(np.asarray, jl.init_lora_buffers(jcfg, 3, 8))
    for ab in bufs.values():
        for name in ("A", "B"):
            ab[name] = ab[name].copy()
            ab[name][1:] = rng.standard_normal(ab[name][1:].shape) * 0.2
    return jax.tree.map(jnp.asarray, bufs), lora_from_numpy(bufs, "cpu")


PAGE, MP = 8, 6


def _pools(jcfg, rng, B, positions, window_tokens):
    """Random stacked pools and block tables: slots 0..B-2 hold pages for
    positions + window_tokens, the last slot is free."""
    NL, KVH, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_size
    P = 1 + B * MP
    kp = rng.standard_normal((NL, P, PAGE, KVH, D)).astype(np.float32)
    vp = rng.standard_normal((NL, P, PAGE, KVH, D)).astype(np.float32)
    perm = rng.permutation(np.arange(1, P))
    bt = np.full((B, MP), -1, np.int32)
    for s in range(B - 1):
        need = min(-(-(int(positions[s]) + window_tokens) // PAGE), MP)
        bt[s, :need] = perm[s * MP:s * MP + need]
    return kp, vp, bt


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("family", ["llama", "qwen"])
def test_prefill_with_adapters_matches_jax(family):
    jcfg, jp, tcfg, tp = _family_models(family)
    jlora, tlora = _lora_pair(jcfg)
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, jcfg.vocab_size, (4, 16)).astype(np.int32)
    lengths = np.array([16, 5, 11, 9], np.int32)
    idx = np.array([1, 0, 2, 1], np.int32)
    want = jl.prefill(jp, jcfg, jnp.asarray(tokens), jnp.asarray(lengths), lora=jlora,
                      lora_idx=jnp.asarray(idx))
    got = tl.prefill(tp, tcfg, torch.from_numpy(tokens).long(), torch.from_numpy(lengths),
                     lora=tlora, lora_idx=torch.from_numpy(idx).long())
    for g, w in zip(got, want):
        _close(g, w)
    base = jl.prefill(jp, jcfg, jnp.asarray(tokens), jnp.asarray(lengths))
    # The adapters change the rows that use them, and only those.
    moved = np.abs(np.asarray(base[0]) - np.asarray(want[0])).max(axis=1)
    assert (moved[idx > 0] > 1e-2).all() and (moved[idx == 0] < 1e-5).all()


def test_prefill_chunk_with_adapter_matches_jax():
    jcfg, jp, tcfg, tp = _family_models("llama")
    jlora, tlora = _lora_pair(jcfg)
    rng = np.random.default_rng(4)
    NL, KVH, D, L, C = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_size, 64, 16
    ks = rng.standard_normal((NL, L, KVH, D)).astype(np.float32)
    vs = rng.standard_normal((NL, L, KVH, D)).astype(np.float32)
    tokens = rng.integers(1, jcfg.vocab_size, (1, C)).astype(np.int32)
    for start, length, adapter in ((0, 40, 2), (16, 40, 1), (24, 40, 0)):
        want = jl.prefill_chunk(jp, jcfg, jnp.asarray(tokens), jnp.int32(start),
                                jnp.int32(length), jnp.asarray(ks), jnp.asarray(vs),
                                want_logits=True, lora=jlora, lora_idx=jnp.asarray([adapter]))
        tk, tv = torch.from_numpy(ks.copy()), torch.from_numpy(vs.copy())
        got = tl.prefill_chunk(tp, tcfg, torch.from_numpy(tokens).long(), torch.tensor(start),
                               torch.tensor(length), tk, tv, want_logits=True, lora=tlora,
                               lora_idx=torch.tensor([adapter]))
        for g, w in zip(got, want):
            _close(g, w)


@pytest.mark.parametrize("layout", ["per_layer", "fused"])
def test_decode_step_with_adapters_matches_jax(layout):
    jcfg, jp, tcfg, tp = _family_models("llama")
    jlora, tlora = _lora_pair(jcfg)
    rng = np.random.default_rng(5)
    positions = np.array([17, 0, 40, 9], np.int32)
    kp, vp, bt = _pools(jcfg, rng, 4, positions, 1)
    tokens = rng.integers(1, jcfg.vocab_size, 4).astype(np.int32)
    idx = np.array([2, 1, 0, 1], np.int32)
    jlog, jk, jv = jl.decode_step_paged(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(bt), lora=jlora, lora_idx=jnp.asarray(idx),
        attn_kernel=layout)
    tlog, tk, tv = tl.decode_step_paged(
        tp, tcfg, torch.from_numpy(tokens).long(), torch.from_numpy(positions).long(),
        torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()), torch.from_numpy(bt),
        lora=tlora, lora_idx=torch.from_numpy(idx).long(), attn_kernel=layout)
    _close(tlog, jlog)
    # Page 0 is scratch (the free slot writes there).
    _close(tk[:, 1:], np.asarray(jk)[:, 1:])
    _close(tv[:, 1:], np.asarray(jv)[:, 1:])


def test_decode_verify_with_adapters_matches_jax():
    jcfg, jp, tcfg, tp = _family_models("llama")
    jlora, tlora = _lora_pair(jcfg)
    rng = np.random.default_rng(6)
    K = 3
    positions = np.array([12, 0, 30, 5], np.int32)
    kp, vp, bt = _pools(jcfg, rng, 4, positions, K)
    tokens = rng.integers(1, jcfg.vocab_size, (4, K)).astype(np.int32)
    idx = np.array([1, 2, 2, 0], np.int32)
    jlog, jk, jv = jl.decode_verify_paged(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(bt), lora=jlora, lora_idx=jnp.asarray(idx))
    tlog, tk, tv = tl.decode_verify_paged(
        tp, tcfg, torch.from_numpy(tokens).long(), torch.from_numpy(positions).long(),
        torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()), torch.from_numpy(bt),
        lora=tlora, lora_idx=torch.from_numpy(idx).long())
    _close(tlog, jlog)
    _close(tk[:, 1:], np.asarray(jk)[:, 1:])
    _close(tv[:, 1:], np.asarray(jv)[:, 1:])


# ---- the weights -----------------------------------------------------------------

HF_NAMES = {"wq": "q_proj", "wk": "k_proj", "wv": "v_proj", "wo": "o_proj"}


def write_peft(path: str, weights: dict, r: int, alpha: float, prefix: str,
               dtype=torch.float32, skip_layers=()) -> str:
    """A PEFT adapter directory: adapter_config.json and the tensors of
    `weights` (alpha/r not folded) under `prefix` ("base_model.model." or
    "") in `dtype`, leaving out `skip_layers`."""
    tensors = {}
    for target, (A, B) in weights.items():
        for i in range(A.shape[0]):
            if i in skip_layers:
                continue
            name = f"{prefix}model.layers.{i}.self_attn.{HF_NAMES[target]}"
            tensors[f"{name}.lora_A.weight"] = torch.from_numpy(A[i].T.copy()).to(dtype)
            tensors[f"{name}.lora_B.weight"] = torch.from_numpy(B[i].T.copy()).to(dtype)
    save_safetensors(path, tensors, {})
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": r, "lora_alpha": alpha,
                   "target_modules": [HF_NAMES[t] for t in weights]}, f)
    return path


@pytest.mark.parametrize("prefix,dtype,skip", [
    ("base_model.model.", torch.bfloat16, (1,)),
    ("", torch.float32, ()),
    ("base_model.model.", torch.float16, ()),
], ids=["peft-bf16-missing-layer", "short-f32", "peft-f16"])
def test_load_peft_adapter_bit_equal_to_jax(tmp_path, models, adapters, prefix, dtype, skip):
    jcfg, _, tcfg, _ = models
    path = write_peft(str(tmp_path / "a"), adapters["a1"], 4, 12.0, prefix, dtype, skip)
    got = load_peft_adapter(path, tcfg)
    want = j_load_peft_adapter(path, jcfg)
    assert set(got) == set(want) == {"wq", "wv"}
    for t in got:
        for g, w in zip(got[t], want[t]):
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
            assert np.array_equal(g.view(np.uint32), np.asarray(w).view(np.uint32))
    if skip:
        assert not got["wq"][0][1].any() and not got["wq"][1][1].any()
    # The alpha / r scaling is folded into B.
    A, B = adapters["a1"]["wq"]
    layer = 0
    ref = (torch.from_numpy(B[layer]).to(dtype).float().numpy() * 3.0)
    np.testing.assert_array_equal(got["wq"][1][layer], ref)


def test_load_peft_adapter_refusals_match_jax(tmp_path, models, adapters):
    jcfg, _, tcfg, _ = models
    cases = {
        "rank": write_peft(str(tmp_path / "rank"), adapters["a1"], 32, 32.0, ""),
        "no-target": str(tmp_path / "none"),
        "no-config": str(tmp_path / "noconfig"),
    }
    save_safetensors(cases["no-target"], {"model.embed.lora_A.weight": torch.zeros(2, 2)}, {})
    with open(os.path.join(cases["no-target"], "adapter_config.json"), "w") as f:
        json.dump({"r": 4}, f)
    save_safetensors(cases["no-config"], {"x": torch.zeros(1)}, {})
    for case, path in cases.items():
        with pytest.raises(WeightLoadError) as got:
            load_peft_adapter(path, tcfg)
        with pytest.raises(JWeightLoadError) as want:
            j_load_peft_adapter(path, jcfg)
        assert str(got.value) == str(want.value), case
    # An s3:// adapter (refused, naming ROADMAP A item 9, until the port
    # took the object store) loads as the JAX package loads it.
    src = write_peft(str(tmp_path / "s3src"), adapters["a1"], 4, 8.0, "")
    fake = FakeS3()
    try:
        for fname in os.listdir(src):
            with open(os.path.join(src, fname), "rb") as f:
                fake.objects[("bucket", f"adapters/a1/{fname}")] = f.read()
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("AWS_ENDPOINT_URL", fake.endpoint)
            mp.setenv("KUBEAI_WEIGHTS_CACHE", str(tmp_path / "cache"))
            got = load_peft_adapter("s3://bucket/adapters/a1", tcfg)
            want = j_load_peft_adapter("s3://bucket/adapters/a1", jcfg)
    finally:
        fake.close()
    local = load_peft_adapter(src, tcfg)
    assert set(got) == set(want) == set(local)
    for t in got:
        for g, w, loc in zip(got[t], want[t], local[t]):
            assert np.array_equal(g.view(np.uint32), np.asarray(w).view(np.uint32))
            assert np.array_equal(g, loc)


# ---- the engine ------------------------------------------------------------------


def _prompts():
    rng = np.random.default_rng(7)
    system = rng.integers(1, 256, 18).tolist()
    # One prefill bucket (17-32 tokens): fewer JAX programs to compile.
    return [system + rng.integers(1, 256, 5).tolist(),
            system + rng.integers(1, 256, 9).tolist(),
            rng.integers(1, 256, 20).tolist(),
            rng.integers(1, 256, 24).tolist(),
            rng.integers(1, 256, 30).tolist()]


# (prompt, adapter, sampling): base, a1 and a2 rows share one prefill
# batch and every decode batch, and a fifth request queues for a slot;
# prompt 0 runs base and with a1; the prefix scenario's a1 request on
# prompt 1 hits a1's own pages of the shared system prompt, never base's.
REQUESTS = [
    (0, None, "greedy"), (0, "a1", "greedy"), (1, "a1", "seeded"), (2, "a2", "seeded"),
    (3, None, "seeded"),
]


def _run(eng, sp_cls, requests=REQUESTS) -> list[list[int]]:
    prompts = _prompts()
    rids = [eng.add_request(prompts[p], sp_cls(**SAMPLING[mode]), adapter=a)
            for p, a, mode in requests]
    out = {rid: [] for rid in rids}
    while eng.has_work():
        for ev in eng.step():
            out[ev.rid].append(ev.token)
    return [out[rid] for rid in rids]


def _jax_engine(models, adapters, **kw):
    jcfg, jparams, _, _ = models
    eng = JEngine("llama", jcfg, jparams, cfg=JEngineConfig(
        cache_dtype=jnp.float32, step_overlap="off", **{**BASE, **kw}),
        eos_token_ids=TOK.eos_token_ids)
    eng.load_adapter("a1", adapters["a1"])
    eng.load_adapter("a2", adapters["a2"])
    return eng


def _port_engine(models, adapters=None, **kw):
    _, _, tcfg, tparams = models
    eng = Engine("llama", tcfg, tparams, cfg=EngineConfig(
        cache_dtype=torch.float32, **{**BASE, **kw}),
        eos_token_ids=TOK.eos_token_ids, device="cpu")
    for name in ("a1", "a2") if adapters is not None else ():
        eng.load_adapter(name, adapters[name])
    return eng


HANDOFF_PROMPT = 1


@pytest.fixture(scope="module")
def jax_side(models, adapters):
    """Each scenario's JAX streams and prefix_stats; the per_layer
    engine's adapter handoffs (greedy a1, seeded a2) and the engine."""
    out = {}
    for name, kw in SCENARIOS.items():
        eng = _jax_engine(models, adapters, **kw)
        out["streams", name] = _run(eng, JSamplingParams)
        out["prefix_stats", name] = dict(eng.prefix_stats)
        if name == "per_layer":
            prompt = _prompts()[HANDOFF_PROMPT]
            for adapter, mode in (("a1", "greedy"), ("a2", "seeded")):
                sp = JSamplingParams(**SAMPLING[mode])
                out["handoff", adapter] = eng.export_handoff(prompt, sp, adapter=adapter)
                rid = eng.add_request(prompt, sp, adapter=adapter)
                toks = []
                while eng.has_work():
                    toks += [ev.token for ev in eng.step() if ev.rid == rid]
                out["unified", adapter] = toks
            out["engine"] = eng
    return out


@pytest.mark.parametrize("overlap", ["on", "off"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_mixed_adapter_streams_identical_to_jax(models, adapters, jax_side, scenario, overlap):
    eng = _port_engine(models, adapters, step_overlap=overlap, **SCENARIOS[scenario])
    assert eng._overlap == (overlap == "on")
    got = _run(eng, SamplingParams)
    assert got == jax_side["streams", scenario]
    # Prompt 0 with a1 is not prompt 0 on the base model.
    assert got[1] != got[0]
    assert eng.prefix_stats == jax_side["prefix_stats", scenario]
    if scenario == "prefix":
        assert eng.prefix_stats["hit_tokens"] > 0
    assert eng._alloc.free_pages == eng._n_pages - 1 or eng._prefix_cache
    assert not eng.has_work()


def test_adapter_matches_merged_weights(models, adapters):
    """A request with an adapter on wq gives the stream of a base model
    whose wq holds the merged weights (tests/unit/test_lora.py)."""
    _, _, tcfg, tparams = models
    A, B = adapters["a1"]["wq"]
    eng = _port_engine(models)
    eng.load_adapter("fin", {"wq": (A, B)})
    merged = dict(tparams, layers=dict(tparams["layers"]))
    merged["layers"]["wq"] = tparams["layers"]["wq"] + torch.einsum(
        "ler,lrh->leh", torch.from_numpy(A), torch.from_numpy(B))
    eng_merged = Engine("llama", tcfg, merged, cfg=EngineConfig(
        cache_dtype=torch.float32, **{**BASE, "max_adapters": 0}), device="cpu")
    prompt = [5, 6, 7, 8]
    sp = SamplingParams(temperature=0.0, max_tokens=6)
    with_adapter = eng.generate([prompt], sp, adapter="fin")[0]
    assert with_adapter == eng_merged.generate([prompt], sp)[0]
    assert with_adapter != eng.generate([prompt], sp)[0]


def test_mixed_batch_equals_solo(models, adapters):
    """One decode batch serving base and adapter rows gives each its solo
    stream (tests/unit/test_lora.py)."""
    eng = _port_engine(models, adapters)
    prompt = [5, 6, 7, 8]
    sp = SamplingParams(temperature=0.0, max_tokens=6)
    base_solo = eng.generate([prompt], sp)[0]
    a1_solo = eng.generate([prompt], sp, adapter="a1")[0]
    r1 = eng.add_request(prompt, sp)
    r2 = eng.add_request(prompt, sp, adapter="a1")
    out = {r1: [], r2: []}
    while eng.has_work():
        for ev in eng.step():
            out[ev.rid].append(ev.token)
    assert out[r1] == base_solo and out[r2] == a1_solo != base_solo


def _raises_alike(fn, jfn, exc):
    with pytest.raises(exc) as got:
        fn()
    with pytest.raises(exc) as want:
        jfn()
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)
    return str(got.value)


def test_admin_refusals_match_jax(models, adapters):
    """Capacity, an unknown adapter, an unknown target, a rank past
    max_lora_rank, a reload or unload while a request waits or decodes,
    and LoRA off: the JAX engine's exception types and messages."""
    jcfg, jparams, tcfg, tparams = models
    kw = dict(BASE, max_adapters=1)
    eng = _port_engine(models, **kw)
    jeng = JEngine("llama", jcfg, jparams, cfg=JEngineConfig(cache_dtype=jnp.float32, **kw))
    w = adapters["a1"]
    for e in (eng, jeng):
        e.load_adapter("a1", w)
    assert eng.loaded_adapters() == jeng.loaded_adapters() == ["a1"]
    msg = _raises_alike(lambda: eng.load_adapter("a2", w), lambda: jeng.load_adapter("a2", w),
                        RuntimeError)
    assert "capacity (1) exhausted" in msg
    sp = SamplingParams(temperature=0.0, max_tokens=30)
    jsp = JSamplingParams(temperature=0.0, max_tokens=30)
    _raises_alike(lambda: eng.add_request([1, 2], sp, adapter="ghost"),
                  lambda: jeng.add_request([1, 2], jsp, adapter="ghost"), KeyError)
    # Queued: a reload and an unload refuse.
    eng.add_request([1, 2, 3], sp, adapter="a1")
    jeng.add_request([1, 2, 3], jsp, adapter="a1")
    assert eng.adapter_in_use("a1") and jeng.adapter_in_use("a1")
    msg = _raises_alike(lambda: eng.unload_adapter("a1"), lambda: jeng.unload_adapter("a1"),
                        RuntimeError)
    assert "in-flight" in msg
    _raises_alike(lambda: eng.load_adapter("a1", w), lambda: jeng.load_adapter("a1", w),
                  RuntimeError)
    # Decoding: still refused; drained: fine.
    eng.step()
    assert eng.num_active == 1
    with pytest.raises(RuntimeError, match="in-flight"):
        eng.unload_adapter("a1")
    while eng.has_work():
        eng.step()
    assert not eng.adapter_in_use("a1")
    assert eng.unload_adapter("a1") and not eng.unload_adapter("a1")
    # Targets and ranks are checked before a row is taken.
    _raises_alike(lambda: eng.load_adapter("x", {"w_up": w["wq"]}),
                  lambda: JEngine("llama", jcfg, jparams, cfg=JEngineConfig(**kw)).load_adapter(
                      "x", {"w_up": w["wq"]}), KeyError)
    wide = {"wq": (np.zeros((2, 64, 16), np.float32), np.zeros((2, 16, 64), np.float32))}
    jfresh = JEngine("llama", jcfg, jparams, cfg=JEngineConfig(**kw))
    _raises_alike(lambda: eng.load_adapter("x", wide), lambda: jfresh.load_adapter("x", wide),
                  ValueError)
    eng.load_adapter("a3", adapters["a3"])  # the failed loads took no row
    # LoRA off.
    off = _port_engine(models, max_adapters=0)
    joff = JEngine("llama", jcfg, jparams, cfg=JEngineConfig(num_slots=2, max_seq_len=64))
    _raises_alike(lambda: off.load_adapter("x", w), lambda: joff.load_adapter("x", w), ValueError)
    _raises_alike(lambda: off.add_request([1, 2], sp, adapter="x"),
                  lambda: joff.add_request([1, 2], jsp, adapter="x"), ValueError)
    assert off.loaded_adapters() == [] and not off.adapter_in_use("x")
    assert not off.unload_adapter("x")


@pytest.mark.parametrize("entry", ["add_request", "export_handoff"])
def test_adapter_row_is_read_under_the_engine_lock(models, adapters, entry):
    """An unload of a2 and a load of a3 into the row it frees, started
    between a request's lookup of a2 and its queuing (or its prefill),
    wait for the request: it keeps a2's weights, and a queued request
    makes the unload refuse."""
    eng = _port_engine(models, adapters)
    prompt = _prompts()[2]
    sp = SamplingParams(**SAMPLING["greedy"])
    if entry == "add_request":
        want = eng.generate([prompt], sp, adapter="a2")[0]
    else:
        want = eng.export_handoff(prompt, sp, adapter="a2")
    refused, swapped_in_call = [], []

    def swap():
        try:
            eng.unload_adapter("a2")
            eng.load_adapter("a3", adapters["a3"])
        except RuntimeError as e:
            refused.append(str(e))

    swapper = threading.Thread(target=swap)
    lookup = eng._adapter_index

    def racing_lookup(name):
        row = lookup(name)
        swapper.start()
        swapper.join(timeout=0.5)
        swapped_in_call.append(not swapper.is_alive())
        return row

    eng._adapter_index = racing_lookup
    if entry == "add_request":
        rid = eng.add_request(prompt, sp, adapter="a2")
        swapper.join()
        assert swapped_in_call == [False]
        assert len(refused) == 1 and "in-flight" in refused[0]
        assert eng._adapter_slots == {"a1": 1, "a2": 2}
        toks = []
        while eng.has_work():
            toks += [ev.token for ev in eng.step() if ev.rid == rid]
        assert toks == want
    else:
        got = eng.export_handoff(prompt, sp, adapter="a2")
        swapper.join()
        assert swapped_in_call == [False] and refused == []
        assert eng._adapter_slots == {"a1": 1, "a3": 2}
        assert got.adapter == "a2" and got.first_token == want.first_token
        for have, ref in zip(got.contiguous_kv(), want.contiguous_kv()):
            np.testing.assert_array_equal(have, ref)


def test_prefix_cache_adapter_generation_invalidation(models):
    """New weights hot-swapped into a reused adapter row never hit K/V
    cached under the old ones (tests/unit/test_prefix_cache.py)."""
    tcfg = models[2]
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, 256, 64).tolist()
    sp = SamplingParams(temperature=0.0, max_tokens=8)
    kw = dict(max_adapters=1, prefill_chunk=32, prefix_cache=True)
    eng = _port_engine(models, **kw)
    w1, w2 = _weights(tcfg, 11, ("wq",), 8, 8.0), _weights(tcfg, 12, ("wq",), 8, -8.0)
    eng.load_adapter("a", w1)
    chain_1 = eng._prefix_hashes(prompt, 1)
    out1 = eng.generate([prompt], sp, adapter="a")
    eng.generate([prompt], sp, adapter="a")  # a warm hit under w1
    assert eng.prefix_stats["hit_tokens"] > 0
    eng.unload_adapter("a")
    eng.load_adapter("a", w2)
    assert eng._adapter_gen[1] == 3 and eng._prefix_hashes(prompt, 1) != chain_1
    hits = eng.prefix_stats["hit_tokens"]
    out2 = eng.generate([prompt], sp, adapter="a")
    assert eng.prefix_stats["hit_tokens"] == hits  # nothing of w1 was adopted
    fresh = _port_engine(models, max_adapters=1)
    fresh.load_adapter("a", w2)
    assert out2 == fresh.generate([prompt], sp, adapter="a")
    assert out1 != out2


@pytest.mark.parametrize("overlap", ["on", "off"])
def test_adapter_handoffs_cross_between_jax_and_port(models, adapters, jax_side, overlap):
    jeng = jax_side["engine"]
    eng = _port_engine(models, adapters, step_overlap=overlap)
    prompt = _prompts()[HANDOFF_PROMPT]
    for adapter, mode in (("a1", "greedy"), ("a2", "seeded")):
        want = jax_side["unified", adapter]
        # JAX prefill, port decode.
        jh = jax_side["handoff", adapter]
        th = handoff.deserialize(jhandoff.serialize(jh))
        assert th.adapter == adapter
        rid, ev = eng.import_handoff(th)
        assert eng._requests[rid].adapter_idx == eng._adapter_slots[adapter]
        toks = [ev.token]
        while eng.has_work():
            toks += [e.token for e in eng.step() if e.rid == rid]
        assert toks == want
        # Port prefill, JAX decode: the same header as the JAX export.
        mine = eng.export_handoff(prompt, SamplingParams(**SAMPLING[mode]), adapter=adapter)
        assert mine.adapter == adapter and mine.prefix_hashes == jh.prefix_hashes
        assert mine.first_token == jh.first_token
        rid, ev = jeng.import_handoff(jhandoff.deserialize(handoff.serialize(mine)))
        toks = [ev.token]
        while jeng.has_work():
            toks += [e.token for e in jeng.step() if e.rid == rid]
        assert toks == want
    # An adapter this engine has not loaded: the JAX engine's refusal.
    other = _port_engine(models)
    with pytest.raises(KeyError, match="not loaded here"):
        other.import_handoff(handoff.deserialize(jhandoff.serialize(jax_side["handoff", "a1"])))


def test_adapter_rows_are_written_in_place(models, adapters):
    """A load, a reload, an unload and a load into the freed row write the
    buffers the device programs read, at their addresses, and a request
    admitted after each sees the new weights."""
    eng = _port_engine(models, step_overlap="on")
    bufs = {(t, n): eng._lora[t][n] for t in eng._lora for n in ("A", "B")}
    ptrs = {k: b.data_ptr() for k, b in bufs.items()}
    prompt = [9, 8, 7, 6, 5]
    sp = SamplingParams(temperature=0.0, max_tokens=6)

    def check(name, weights, row):
        for t in tl.LORA_TARGETS:
            A, B = (weights or {}).get(t, (np.zeros((2, 1, 0)), np.zeros((2, 0, 1))))
            r = A.shape[-1]
            got_a, got_b = eng._lora[t]["A"][:, row], eng._lora[t]["B"][:, row]
            if weights is None or t not in weights:
                assert not got_a.any() and not got_b.any()
                continue
            assert torch.equal(got_a[..., :r], torch.from_numpy(A))
            assert torch.equal(got_b[:, :r], torch.from_numpy(B))
            assert not got_a[..., r:].any() and not got_b[:, r:].any()
        for k, b in bufs.items():
            assert eng._lora[k[0]][k[1]] is b and b.data_ptr() == ptrs[k]

    eng.load_adapter("x", adapters["a1"])
    check("x", adapters["a1"], 1)
    first = eng.generate([prompt], sp, adapter="x")[0]
    eng.load_adapter("x", adapters["a3"])  # a reload: same row, new weights
    check("x", adapters["a3"], 1)
    reloaded = eng.generate([prompt], sp, adapter="x")[0]
    assert eng.unload_adapter("x")
    check("x", None, 1)
    eng.load_adapter("y", adapters["a2"])  # the freed row, pop(0) order
    assert eng._adapter_slots == {"y": 2}
    eng.load_adapter("z", adapters["a1"])
    assert eng._adapter_slots == {"y": 2, "z": 1}
    check("z", adapters["a1"], 1)
    fresh = _port_engine(models)
    fresh.load_adapter("x", adapters["a3"])
    assert reloaded == fresh.generate([prompt], sp, adapter="x")[0]
    assert eng.generate([prompt], sp, adapter="z")[0] == first


# ---- the server ------------------------------------------------------------------

ADAPTER_URLS = {"hf://org/fin-lora": "a1", "hf://org/fin-lora-v2": "a3"}


@pytest.fixture(scope="module")
def servers(models, adapters):
    """A JAX and a port EngineServer on the same f32 weights, each with an
    adapter_fetcher over ADAPTER_URLS (an unknown URL raises)."""
    jcfg, jparams, tcfg, tparams = models

    def fetcher(name, url):
        return adapters[ADAPTER_URLS[url]]

    kw = dict(BASE, max_adapters=2)
    jeng = JEngine("llama", jcfg, jparams, cfg=JEngineConfig(cache_dtype=jnp.float32, **kw),
                   eos_token_ids=TOK.eos_token_ids)
    teng = _port_engine(models, **kw)
    jsrv = JEngineServer(jeng, JByteTokenizer(), "tiny-llama", host="127.0.0.1", port=0,
                         adapter_fetcher=fetcher)
    tsrv = EngineServer(teng, TOK, "tiny-llama", host="127.0.0.1", port=0,
                        adapter_fetcher=fetcher)
    jsrv.start()
    tsrv.start()
    yield jsrv, tsrv
    jsrv.stop()
    tsrv.stop()


def _answer(status, body):
    data = json.loads(body)
    if "choices" in data:  # ids and timestamps differ between servers
        return status, [c["text"] for c in data["choices"]], data["model"]
    return status, data


def test_admin_flow_matches_jax_server(servers):
    """tests/unit/test_engine_server.py's adapter admin flow on both
    servers: every status and body equal."""
    steps = [
        ("POST", "/v1/load_lora_adapter", {"lora_name": "fin", "lora_url": "hf://org/fin-lora"}),
        ("POST", "/v1/load_lora_adapter", {"lora_name": "fin", "lora_url": "hf://org/fin-lora"}),
        ("GET", "/v1/models", None),
        ("POST", "/v1/completions", {"model": "tiny-llama", "prompt": "hello", "max_tokens": 6,
                                     "temperature": 0}),
        ("POST", "/v1/completions", {"model": "fin", "prompt": "hello", "max_tokens": 6,
                                     "temperature": 0}),
        ("POST", "/v1/completions", {"model": "ghost", "prompt": "hello", "max_tokens": 6}),
        ("POST", "/v1/load_lora_adapter", {"lora_name": "fin", "lora_url": "hf://org/fin-lora-v2"}),
        ("POST", "/v1/completions", {"model": "fin", "prompt": "hello", "max_tokens": 6,
                                     "temperature": 0}),
        ("POST", "/v1/load_lora_adapter", {"lora_url": "hf://org/fin-lora"}),
        ("POST", "/v1/load_lora_adapter", {"lora_name": "bad", "lora_url": "hf://org/none"}),
        ("POST", "/v1/unload_lora_adapter", {"lora_name": "fin"}),
        ("POST", "/v1/unload_lora_adapter", {"lora_name": "fin"}),
        ("POST", "/v1/unload_lora_adapter", {}),
        ("GET", "/v1/models", None),
    ]
    answers = []
    for method, path, body in steps:
        pair = []
        for srv in servers:
            addr = f"127.0.0.1:{srv.port}"
            got = http_get(addr, path) if method == "GET" else http_post(addr, path, body)
            pair.append(_answer(*got))
            if path == "/v1/load_lora_adapter" and body.get("lora_name") == "fin":
                pair[-1] += (json.loads(http_get(addr, "/v1/state")[1])["adapters"],)
        assert pair[0] == pair[1], (path, body)
        answers.append(pair[1])
    codes = [a[0] for a in answers]
    assert codes == [200, 200, 200, 200, 200, 404, 200, 200, 400, 400, 200, 404, 400, 200]
    assert answers[0][1] == {"status": "loaded", "lora_name": "fin"} and answers[0][2] == ["fin"]
    assert b"already" in json.dumps(answers[1][1]).encode()
    assert [m["id"] for m in answers[2][1]["data"]] == ["tiny-llama", "fin"]
    base, fin, fin_v2 = answers[3][1], answers[4][1], answers[7][1]
    assert fin != base and fin_v2 != fin and answers[4][2] == "fin"
    assert answers[6][1]["status"] == "loaded"
    assert [m["id"] for m in answers[13][1]["data"]] == ["tiny-llama"]


def test_operator_engine_client_drives_port_server(models, adapters):
    """The operator's EngineClient loads, lists and unloads adapters on the
    port's server, with its idempotency rules."""
    srv = EngineServer(_port_engine(models), TOK, "tiny-llama", port=0,
                       adapter_fetcher=lambda name, url: adapters[ADAPTER_URLS[url]])
    srv.start()
    try:
        addr, client = f"http://127.0.0.1:{srv.port}", EngineClient(timeout=10)
        client.load_lora_adapter(addr, "fin", lora_url="hf://org/fin-lora")
        client.load_lora_adapter(addr, "fin", lora_url="hf://org/fin-lora",
                                 ignore_already_loaded=True)
        assert client.list_lora_adapters(addr, "tiny-llama") == ["fin"]
        with pytest.raises(EngineClientError) as e:
            client.load_lora_adapter(addr, "other", lora_url="hf://org/none")
        assert e.value.status == 400
        client.unload_lora_adapter(addr, "fin")
        client.unload_lora_adapter(addr, "fin", ignore_not_found=True)
        with pytest.raises(EngineClientError) as e:
            client.unload_lora_adapter(addr, "fin")
        assert e.value.status == 404
        assert client.list_lora_adapters(addr, "tiny-llama") == []
    finally:
        srv.stop()
