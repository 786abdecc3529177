"""Gemma 1 and 2 in kubeai_tpu_torch against the JAX package, on the CPU
in f32 (the port's counterpart of the gemma cases of tests/unit/
test_model_families.py and test_prefix_cache.py).

Three tiny configs: Gemma-1 (`GemmaConfig.tiny()`), Gemma-2 (sandwich
norms, attention softcap 50, final softcap 30, query_pre_attn_scalar 16,
sliding window 8 on even layers) and Gemma-2 with explicit `layer_types`
(the window on the odd layer instead). The weights are the JAX
`init_params` draw with wq and wk scaled to std 0.5, the embedding to 0.2
and the norms drawn near 0, so that the softcaps, the window and the
zero-centred norms each move the output. Prompts are longer than the
window.

- The model: `prefill` logits and K/V, `decode_step_paged` logits and
  pools (per_layer and fused, and per_layer on int8 pools) and
  `prefill_chunk` (against the JAX chunk and against whole-prompt
  prefill) within 1e-4 of the JAX functions.
- The engine: greedy and seeded streams identical to the JAX engine's in
  the per_layer and fused layouts, on int8 pools, with chunked prefill
  and the prefix cache (hits), with speculate=4 (both sides fall back to
  vanilla decode: gemma has no verify forward) and in a pool that forces
  preemption.
- The weights: a Gemma and a Gemma-2 checkpoint written with HF names
  load bit-equal through both packages' loaders.
- The card's refusals (a device argument, no card): a head dim no
  kernel on the path takes, and a speculating engine at head_dim 256
  (B3), each at construction; Gemma-1 and Gemma-2 on bf16 and int8 pools
  pass them (B1, B2, B4 and B1-int8 have head_dim-256 builds).
- Fault C10: the JAX engine loads an adapter on gemma and serves the base
  model under its name; the port refuses the load, and its route answers
  400.

The JAX engines run each scenario once per module, with step_overlap off.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from testutil import http_post
from torch_gemma_checkpoint import hf_config, write_gemma_checkpoint

from kubeai_tpu.engine import Engine as JEngine
from kubeai_tpu.engine import EngineConfig as JEngineConfig
from kubeai_tpu.engine import weights as jweights
from kubeai_tpu.engine.sampling import SamplingParams as JSamplingParams
from kubeai_tpu.models import gemma as jg
from kubeai_tpu.ops import kv_quant as jkq
from kubeai_tpu_torch.engine import Engine, EngineConfig, SamplingParams
from kubeai_tpu_torch.engine import weights
from kubeai_tpu_torch.engine.engine import refuse_kernel_head_dims
from kubeai_tpu_torch.engine.server import EngineServer
from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
from kubeai_tpu_torch.models import gemma as tg
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.models.registry import get_model_family
from kubeai_tpu_torch.ops import kv_quant as tkq
from kubeai_tpu_torch.ops import paged_attention as tpa
from kubeai_tpu_torch.ops.flash_attention import _check_prefill_args, flash_causal_prefill
from kubeai_tpu_torch.parity import params_from_numpy

TOK = ByteTokenizer()
# f32 on both sides through two layers, sums in different orders.
ATOL = 1e-4
GEMMA2 = dict(sandwich_norms=True, attn_logit_softcapping=50.0,
              final_logit_softcapping=30.0, query_pre_attn_scalar=16.0,
              sliding_window=8)
CONFIGS = {
    "gemma1": {},
    "gemma2": GEMMA2,
    "gemma2-layer-types": {**GEMMA2, "layer_types": ("full_attention",
                                                     "sliding_attention")},
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs thousands of tiny ops: one intra-op thread
    keeps them from spinning against the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_config(jcfg) -> tg.GemmaConfig:
    return tg.GemmaConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(jcfg) if f.name != "dtype"},
                          dtype=torch.float32)


def _models(kind: str):
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
    return jcfg, jax.tree.map(jnp.asarray, tree), _port_config(jcfg), params_from_numpy(tree)


@pytest.fixture(scope="module")
def models():
    return {kind: _models(kind) for kind in CONFIGS}


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


# ---- the config and the parameter tree --------------------------------------------


def test_config_matches_jax():
    assert _port_config(jg.GemmaConfig.tiny()) == dataclasses.replace(
        tg.GemmaConfig.tiny(), dtype=torch.float32)
    for d in (hf_config(False), hf_config(True),
              hf_config(True, layer_types=["full_attention", "sliding_attention"]),
              hf_config(True, query_pre_attn_scalar=None, num_hidden_layers=5)):
        jcfg, tcfg = jg.GemmaConfig.from_hf_dict(d), tg.GemmaConfig.from_hf_dict(d)
        assert dataclasses.replace(_port_config(jcfg), dtype=torch.bfloat16) == tcfg
        assert tcfg.layer_windows() == np.asarray(jcfg.layer_windows()).tolist()
        assert all(type(w) is int for w in tcfg.layer_windows())
        assert tg._q_scale(tcfg) == jg._q_scale(jcfg)
    assert tg.GemmaConfig.from_hf_dict(hf_config(True)).layer_windows() == [8, 0]


def test_params_from_numpy_carries_the_gemma_tree(models):
    jcfg, jp, _, tp = models["gemma2"]
    tree = jax.tree.map(np.asarray, jp)
    assert {"post_attn_norm", "pre_mlp_norm", "post_mlp_norm"} <= set(tp["layers"])
    assert set(tp["layers"]) == set(tree["layers"])
    for name, w in tree["layers"].items():
        assert torch.equal(tp["layers"][name], torch.from_numpy(w)), name
    assert torch.equal(tp["embed"], torch.from_numpy(tree["embed"]))
    assert torch.equal(tp["final_norm"], torch.from_numpy(tree["final_norm"]))
    # bf16 trees come across bit for bit.
    bf = jax.tree.map(np.asarray, jg.init_params(
        dataclasses.replace(jg.GemmaConfig.tiny(), **GEMMA2), jax.random.PRNGKey(2)))
    got = params_from_numpy(bf)
    for name, w in bf["layers"].items():
        assert got["layers"][name].dtype == torch.bfloat16
        assert np.array_equal(got["layers"][name].view(torch.int16).numpy(),
                              w.view(np.int16)), name


def test_init_params_layout():
    cfg = dataclasses.replace(tg.GemmaConfig.tiny(), **GEMMA2)
    p = tg.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    j = jg.init_params(dataclasses.replace(jg.GemmaConfig.tiny(), **GEMMA2))
    assert set(p["layers"]) == set(j["layers"]) and "lm_head" not in p
    for name, w in p["layers"].items():
        assert tuple(w.shape) == j["layers"][name].shape and w.dtype == torch.bfloat16
        if name.endswith("norm"):
            assert not w.any()  # zero-centred: a scale of 1


# ---- the model functions ----------------------------------------------------------


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_prefill_matches_jax(models, kind):
    jcfg, jp, tcfg, tp = models[kind]
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, jcfg.vocab_size, (3, 24)).astype(np.int32)
    lengths = np.array([24, 10, 17], np.int32)
    want = jg.prefill(jp, jcfg, jnp.asarray(tokens), jnp.asarray(lengths))
    got = tg.prefill(tp, tcfg, torch.from_numpy(tokens).long(), torch.from_numpy(lengths))
    for g, w in zip(got, want):
        _close(g, w)
    if kind != "gemma1":  # the window masks keys of the 24-token prompt
        plain = jg.prefill(jp, dataclasses.replace(jcfg, sliding_window=None),
                           jnp.asarray(tokens), jnp.asarray(lengths))
        assert np.abs(np.asarray(plain[0]) - np.asarray(want[0])).max() > 1e-2


PAGE, MP = 8, 6


def _pools(jcfg, rng, B, positions):
    """Random stacked pools and block tables: slots 0..B-2 hold pages for
    positions + 1, the last slot is free."""
    NL, KVH, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_size
    P = 1 + B * MP
    kp = rng.standard_normal((NL, P, PAGE, KVH, D)).astype(np.float32)
    vp = rng.standard_normal((NL, P, PAGE, KVH, D)).astype(np.float32)
    perm = rng.permutation(np.arange(1, P))
    bt = np.full((B, MP), -1, np.int32)
    for s in range(B - 1):
        need = min(-(-(int(positions[s]) + 1) // PAGE), MP)
        bt[s, :need] = perm[s * MP:s * MP + need]
    return kp, vp, bt


@pytest.mark.parametrize("layout", ["per_layer", "fused"])
@pytest.mark.parametrize("kind", list(CONFIGS))
def test_decode_step_matches_jax(models, kind, layout):
    jcfg, jp, tcfg, tp = models[kind]
    rng = np.random.default_rng(5)
    positions = np.array([17, 0, 40, 9], np.int32)  # past the window of 8
    kp, vp, bt = _pools(jcfg, rng, 4, positions)
    tokens = rng.integers(1, jcfg.vocab_size, 4).astype(np.int32)
    jlog, jk, jv = jg.decode_step_paged(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(bt), attn_kernel=layout)
    tlog, tk, tv = tg.decode_step_paged(
        tp, tcfg, torch.from_numpy(tokens).long(), torch.from_numpy(positions).long(),
        torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()), torch.from_numpy(bt),
        attn_kernel=layout)
    _close(tlog, jlog)
    # Page 0 is scratch (the free slot writes there).
    _close(tk[:, 1:], np.asarray(jk)[:, 1:])
    _close(tv[:, 1:], np.asarray(jv)[:, 1:])


@pytest.mark.parametrize("kind", ["gemma1", "gemma2"])
def test_decode_step_on_int8_pools_matches_jax(models, kind):
    jcfg, jp, tcfg, tp = models[kind]
    rng = np.random.default_rng(6)
    positions = np.array([17, 0, 40, 9], np.int32)
    kp, vp, bt = _pools(jcfg, rng, 4, positions)
    pools = [tuple(np.asarray(a) for a in jkq.quantize_kv(jnp.asarray(x))) for x in (kp, vp)]
    jpools = [{"q8": jnp.asarray(q8), "scale": jnp.asarray(s)} for q8, s in pools]
    tpools = [tkq.QuantizedPool(torch.from_numpy(q8.copy()), torch.from_numpy(s.copy()))
              for q8, s in pools]
    tokens = rng.integers(1, jcfg.vocab_size, 4).astype(np.int32)
    jlog, jk, jv = jg.decode_step_paged(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions), *jpools, jnp.asarray(bt),
        attn_kernel="per_layer")
    args = (tp, tcfg, torch.from_numpy(tokens).long(), torch.from_numpy(positions).long(),
            *tpools, torch.from_numpy(bt))
    tlog, tk, tv = tg.decode_step_paged(*args, attn_kernel="per_layer")
    _close(tlog, jlog)
    for t, j in ((tk, jk), (tv, jv)):
        # The new rows quantize alike (ROADMAP C6 allows one step on a
        # rare value: none here).
        assert np.array_equal(t.q8[:, 1:].numpy(), np.asarray(j["q8"])[:, 1:])
        _close(t.scale[:, 1:], np.asarray(j["scale"])[:, 1:])
    with pytest.raises(ValueError) as want:
        jg.decode_step_paged(jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
                             *jpools, jnp.asarray(bt), attn_kernel="fused")
    with pytest.raises(ValueError, match="per_layer") as got:
        tg.decode_step_paged(*args, attn_kernel="fused")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_prefill_chunk_matches_jax_and_whole_prompt(models, kind):
    """21 tokens in chunks of 8 into a 32-token staging cache: each chunk
    against the JAX chunk, the last chunk's logits and the cache against
    whole-prompt prefill."""
    jcfg, jp, tcfg, tp = models[kind]
    rng = np.random.default_rng(7)
    NL, KVH, D, L, C, n = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_size, 32, 8, 21
    prompt = rng.integers(1, jcfg.vocab_size, n).astype(np.int32)
    padded = np.zeros(24, np.int32)
    padded[:n] = prompt
    stale = rng.standard_normal((2, NL, L, KVH, D)).astype(np.float32)  # masked junk
    jk, jv = jnp.asarray(stale[0]), jnp.asarray(stale[1])
    tk, tv = torch.from_numpy(stale[0].copy()), torch.from_numpy(stale[1].copy())
    for start in range(0, n, C):
        last = start + C >= n
        chunk = padded[None, start:start + C]
        jlog, jk, jv = jg.prefill_chunk(jp, jcfg, jnp.asarray(chunk), jnp.int32(start),
                                        jnp.int32(n), jk, jv, want_logits=last)
        tlog, tk, tv = tg.prefill_chunk(tp, tcfg, torch.from_numpy(chunk).long(),
                                        torch.tensor(start), torch.tensor(n), tk, tv,
                                        want_logits=last)
        _close(tk, jk)
        _close(tv, jv)
        assert (tlog is None) == (not last)
    _close(tlog, jlog)
    whole, k_all, v_all = tg.prefill(tp, tcfg, torch.from_numpy(prompt[None]).long(),
                                     torch.tensor([n]))
    np.testing.assert_allclose(tlog.numpy(), whole.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tk[:, :n].numpy(), k_all[:, 0].numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv[:, :n].numpy(), v_all[:, 0].numpy(), atol=ATOL, rtol=0)


# ---- the engine ------------------------------------------------------------------

BASE = dict(num_slots=4, max_seq_len=64, page_size=8, decode_chunk=4)
# (model, EngineConfig extras). "tight" holds 10 pages for 4 slots of up
# to 5 pages each: decode preempts.
SCENARIOS = {
    "per_layer": ("gemma2", {}),
    "fused": ("gemma2", dict(decode_kernel="fused")),
    "int8": ("gemma2", dict(kv_dtype="int8")),
    "prefix": ("gemma2", dict(prefill_chunk=16, prefix_cache=True)),
    "speculate": ("gemma2", dict(speculate=4, spec_adaptive=False)),
    "tight": ("gemma2", dict(num_pages=1 + 10)),
}
SAMPLING = {
    "greedy": dict(temperature=0.0, max_tokens=10),
    "seeded": dict(temperature=0.8, top_k=16, top_p=0.9, max_tokens=10, seed=5),
}


def _prompts():
    """Five prompts past the window of 8, two over one 18-token system
    prompt (the prefix scenario's hit), more prompts than slots, all in
    the 32-token prefill bucket (one JAX prefill program an engine)."""
    rng = np.random.default_rng(8)
    system = rng.integers(1, 256, 18).tolist()
    return [system + rng.integers(1, 256, 5).tolist(),
            system + rng.integers(1, 256, 9).tolist(),
            rng.integers(1, 256, 20).tolist(),
            rng.integers(1, 256, 27).tolist(),
            rng.integers(1, 256, 19).tolist()]


MODES = ["greedy", "seeded", "greedy", "seeded", "greedy"]


def _run(eng, sp_cls) -> list[list[int]]:
    rids = [eng.add_request(p, sp_cls(**SAMPLING[m])) for p, m in zip(_prompts(), MODES)]
    out = {rid: [] for rid in rids}
    while eng.has_work():
        for ev in eng.step():
            out[ev.rid].append(ev.token)
    return [out[rid] for rid in rids]


@pytest.fixture(scope="module")
def jax_streams(models):
    out = {}
    for name, (kind, kw) in SCENARIOS.items():
        jcfg, jp, _, _ = models[kind]
        eng = JEngine("gemma", jcfg, jp, cfg=JEngineConfig(
            cache_dtype=jnp.float32, step_overlap="off", **{**BASE, **kw}),
            eos_token_ids=TOK.eos_token_ids)
        out[name] = (_run(eng, JSamplingParams), dict(eng.prefix_stats))
    return out


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_streams_identical_to_jax(models, jax_streams, scenario, caplog):
    kind, kw = SCENARIOS[scenario]
    _, _, tcfg, tp = models[kind]
    with caplog.at_level(logging.WARNING):
        eng = Engine("gemma", tcfg, tp, cfg=EngineConfig(
            cache_dtype=torch.float32, **{**BASE, **kw}),
            eos_token_ids=TOK.eos_token_ids, device="cpu")
    assert eng._overlap
    preempted = []
    eng.on_preempt = lambda rid, client: preempted.append(rid)
    got = _run(eng, SamplingParams)
    streams, prefix_stats = jax_streams[scenario]
    assert got == streams
    assert all(len(s) == 10 for s in got)
    assert eng.prefix_stats == prefix_stats
    if scenario == "prefix":
        assert eng.prefix_stats["hit_tokens"] > 0
    if scenario == "speculate":  # no verify forward: vanilla decode
        assert eng._spec == 0 and "no verify forward" in caplog.text
    if scenario == "tight":
        assert preempted, "the tight pool must force a preemption"
    if scenario == "int8":
        assert isinstance(eng.cache.k_pages, tkq.QuantizedPool)
    assert eng._alloc.free_pages == eng._n_pages - 1 or eng._prefix_cache


# ---- the weights ---------------------------------------------------------------


@pytest.mark.parametrize("gemma2", [False, True], ids=["gemma", "gemma2"])
def test_load_params_bit_equal_to_jax_loader(tmp_path, gemma2):
    model_dir = write_gemma_checkpoint(tmp_path, hf_config(gemma2), seed=4)
    hf = weights.load_hf_config(model_dir)
    jcfg, tcfg = jg.GemmaConfig.from_hf_dict(hf), tg.GemmaConfig.from_hf_dict(hf)
    assert get_model_family(hf["architectures"][0]).name == "gemma"
    want = jax.tree.map(np.asarray, jweights.load_gemma_params(model_dir, jcfg))
    got = weights.load_params("gemma", model_dir, tcfg, device="cpu")
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    assert ("post_mlp_norm" in got["layers"]) is gemma2
    leaves = [(k, got[k], want[k]) for k in ("embed", "final_norm")]
    leaves += [(k, got["layers"][k], want["layers"][k]) for k in want["layers"]]
    for name, g, w in leaves:
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape, name
        assert np.array_equal(g.view(torch.int16).numpy(), w.view(np.int16)), name


def test_mixtral_and_whisper_stay_refused():
    for family in ("mixtral", "whisper"):
        with pytest.raises(weights.WeightLoadError, match="ROADMAP A item 10"):
            weights.load_params(family, "/nonexistent", None, device="cpu")
    assert "Gemma2ForCausalLM" not in weights.UNPORTED_ARCHITECTURES


# ---- the card's refusals, at construction -------------------------------------------


CUDA, CPU = torch.device("cuda"), torch.device("cpu")


def _refusal(model_cfg, family="gemma", device=CUDA, speculate=0, **kw):
    """refuse_kernel_head_dims' message, or None when it passes."""
    cfg = EngineConfig(**kw)
    layout = cfg.decode_kernel or "per_layer"
    try:
        refuse_kernel_head_dims(get_model_family(family), model_cfg, cfg, layout,
                                speculate, device)
    except NotImplementedError as e:
        return str(e)
    return None


def test_card_refusals():
    g1 = tg.GemmaConfig()  # Gemma-2B: head_dim 256, B2's path
    g7 = dataclasses.replace(g1, hidden_size=3072, intermediate_size=24576,
                             num_layers=28, num_heads=16, num_kv_heads=16)  # Gemma-7B
    g2 = tg.GemmaConfig.from_hf_dict(hf_config(True, head_dim=256))
    # Gemma-1 takes B2, B1 and B4 at 256, and B1-int8 on int8 pools.
    for cfg in (g1, g7):
        assert get_model_family("gemma").prefill_uses_flash(cfg)
        assert _refusal(cfg) is None and _refusal(cfg, decode_kernel="fused") is None
    for cfg in (g1, g7, g2):
        assert _refusal(cfg, kv_dtype="int8") is None
    # Gemma-2 at 256 takes B1 and B4, and no B2 (its prefill is plain).
    assert _refusal(g2) is None and _refusal(g2, decode_kernel="fused") is None
    # A llama whose head_dim no kernel takes: refused, not left to capture.
    odd = tl.LlamaConfig(hidden_size=768, num_heads=8, num_kv_heads=8, head_dim=96)
    assert "head_dim 96" in _refusal(odd, family="llama")
    assert _refusal(tl.LlamaConfig(), family="llama", speculate=4) is None
    # B3 takes 64 and 128 (a family with a verify forward at 256 would
    # need it): the refusal names its ROADMAP item.
    wide = tl.LlamaConfig(hidden_size=4096, num_heads=16, head_dim=256)
    msg = _refusal(wide, family="llama", speculate=4)
    assert "paged_verify_attention" in msg and "ROADMAP B, B3 at head_dim 256" in msg, msg
    assert _refusal(wide, family="llama") is None
    # The CPU runs the plain versions, which take any head_dim.
    for cfg in (g1, g2):
        assert _refusal(cfg, device=CPU, kv_dtype="int8") is None


def test_engine_refuses_before_building(monkeypatch):
    """The refusal comes before the pools and the programs: the engine
    builds nothing for a model it would refuse."""
    from kubeai_tpu_torch.engine import engine as teng

    def no_cache(*a, **kw):
        raise AssertionError("the engine built its pools")

    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    monkeypatch.setattr(teng, "resolve_device", lambda device=None: CUDA)
    monkeypatch.setattr(teng.PagedKVCache, "create", no_cache)
    wide = dataclasses.replace(cfg, head_dim=256)
    with pytest.raises(NotImplementedError, match="ROADMAP B, B3 at head_dim 256"):
        Engine("llama", wide, params, cfg=EngineConfig(num_slots=2, max_seq_len=32,
                                                       speculate=4))


def test_kernel_wrappers_take_head_dim_256_where_built():
    for kernel in (tpa.paged_decode_attention, tpa.paged_decode_attention_fused,
                   tpa.paged_decode_attention_int8, flash_causal_prefill):
        assert 256 in kernel.head_dims, kernel.__name__
    assert 256 not in tpa.paged_verify_attention.head_dims
    B, H, KVH, D = 2, 16, 8, 256
    q = torch.zeros(B, H, D, dtype=torch.bfloat16)
    pool = torch.zeros(3, 8, KVH, D, dtype=torch.bfloat16)
    bt, n = torch.zeros(B, 2, dtype=torch.int32), torch.zeros(B, dtype=torch.int32)
    tpa._check_decode_args(q, pool, pool, bt, n, window=4096)
    new = torch.zeros(B, KVH, D, dtype=torch.bfloat16)
    tpa._check_fused_args(q, pool[None], pool[None], new, new, bt, n, 0, 4096)
    with pytest.raises(ValueError, match="head_dim 256"):
        tpa._check_verify_args(q[:, None], pool, pool, bt, n, window=None)
    # Gemma-2-9B's heads, Gemma-7B's (16 over 16) and Gemma-2B's (8 over 1)
    # on int8 pools.
    for h, kvh in ((H, KVH), (16, 16), (8, 1)):
        q8 = tkq.QuantizedPool(torch.zeros(3, 8, kvh, D, dtype=torch.int8),
                               torch.zeros(3, 8, kvh))
        qh = torch.zeros(B, h, D, dtype=torch.bfloat16)
        tpa._check_decode_int8_args(qh, q8, q8, bt, n, window=4096)
    # Gemma-7B's prefill: 16 q heads over 16 kv heads, and Gemma-2B's 8
    # over 1.
    for h, kvh in ((16, 16), (8, 1)):
        qf = torch.zeros(1, 128, h, D, dtype=torch.bfloat16)
        kf = torch.zeros(1, 128, kvh, D, dtype=torch.bfloat16)
        _check_prefill_args(qf, kf, kf)
    with pytest.raises(ValueError, match="head_dim 96"):
        x = torch.zeros(1, 128, 8, 96, dtype=torch.bfloat16)
        _check_prefill_args(x, x, x)


@pytest.mark.parametrize("shape,d,want", [
    ((8, 8, 128, 64), 256, (16, 8)),   # Gemma-2-9B at 8,192 tokens: 512-token splits
    ((8, 8, 128, 64), 128, (8, 16)),   # head_dim 128 keeps its choice
    ((8, 8, 32, 64), 256, (8, 4)),     # short tables: the choice was already small
    ((1, 8, 256, 64), 256, (64, 4)),
    ((8, 8, 512, 16), 256, (16, 32)),  # 16-token pages: 32 a split
])
def test_fused_split_at_head_dim_256(shape, d, want):
    """B1 and B4 split a head_dim-256 walk into at most 512 tokens: one
    CTA fits an SM there, and a split's serial walk is the critical path
    of a long slot."""
    assert tpa.fused_split(*shape, d) == want
    num_splits, per = want
    assert num_splits * per >= shape[2] > (num_splits - 1) * per


def test_init_params_needs_a_card_unless_told(monkeypatch):
    from kubeai_tpu_torch.device import NoCudaDevice

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        tg.init_params(tg.GemmaConfig.tiny())


# ---- fault C10: adapters on a family that takes none ---------------------------------


def _adapter(cfg, seed=11):
    """An adapter on wq in llama's shapes, the buffers the JAX engine
    builds for gemma (tl.lora_dims reads only the config's widths)."""
    rng = np.random.default_rng(seed)
    e, o = tl.lora_dims(cfg)["wq"]
    return {"wq": ((rng.standard_normal((cfg.num_layers, e, 4)) * 0.5).astype(np.float32),
                   (rng.standard_normal((cfg.num_layers, 4, o)) * 0.5).astype(np.float32))}


def test_adapters_refused_on_gemma(models):
    """C10: with max_adapters 4 (the CLI default) the JAX engine loads an
    adapter on gemma and serves the base model under its name; the port
    builds no adapter buffers, refuses the load with ValueError naming the
    family, and its route answers 400 before fetching any weights."""
    jcfg, jp, tcfg, tp = models["gemma2"]
    kw = dict(num_slots=2, max_seq_len=64, page_size=8, max_adapters=4)
    jeng = JEngine("gemma", jcfg, jp, cfg=JEngineConfig(cache_dtype=jnp.float32,
                                                        step_overlap="off", **kw))
    jeng.load_adapter("a1", _adapter(jcfg))
    prompt, sp = _prompts()[2], JSamplingParams(**SAMPLING["greedy"])
    assert jeng.generate([prompt], sp, adapter="a1") == jeng.generate([prompt], sp)

    eng = Engine("gemma", tcfg, tp, cfg=EngineConfig(cache_dtype=torch.float32, **kw),
                 device="cpu")
    assert eng._lora is None and "gemma family" in eng.adapter_refusal
    with pytest.raises(ValueError, match="gemma family takes no LoRA adapters"):
        eng.load_adapter("a1", _adapter(jcfg))
    with pytest.raises(ValueError, match="C10"):
        eng.add_request(prompt, SamplingParams(**SAMPLING["greedy"]), adapter="a1")
    assert eng.loaded_adapters() == [] and not eng.unload_adapter("a1")
    fetched = []
    server = EngineServer(eng, TOK, "gemma", port=0,
                          adapter_fetcher=lambda name, url: fetched.append(name))
    server.start()
    try:
        status, body = http_post(f"127.0.0.1:{server.port}", "/v1/load_lora_adapter",
                                 {"lora_name": "a1", "lora_path": "/adapters/a1"})
    finally:
        server.stop()
    assert status == 400 and b"gemma family takes no LoRA adapters" in body
    assert not fetched
