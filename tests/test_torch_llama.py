"""kubeai_tpu_torch.models.llama against kubeai_tpu.models.llama on the
same weights (carried across by kubeai_tpu_torch.parity): prefill logits
and K/V, and one paged decode step's logits and pools, for the llama and
qwen families on LlamaConfig.tiny() in f32. Tolerance atol 1e-4: f32 on
both sides through two layers, sums in different orders."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.models import llama as jl
from kubeai_tpu.ops import paged_attention as jpa
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.models.registry import get_model_family
from kubeai_tpu_torch.parity import params_from_numpy

ATOL = 1e-4
PAGE, MP = 8, 6


def _models(family):
    jcfg = dataclasses.replace(
        jl.LlamaConfig.tiny(), dtype=jnp.float32,
        attention_bias=(family == "qwen"),
    )
    tcfg = dataclasses.replace(
        get_model_family(family).tiny_config(), dtype=torch.float32
    )
    assert tcfg.attention_bias == (family == "qwen")
    tree = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(1)))
    if family == "qwen":
        rng = np.random.default_rng(2)
        for b in ("bq", "bk", "bv"):  # non-zero biases on every projection
            tree["layers"][b] = (
                rng.standard_normal(tree["layers"][b].shape) * 0.1
            ).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, jparams, tcfg, params_from_numpy(tree, "cpu")


@pytest.mark.parametrize("family", ["llama", "qwen"])
def test_prefill_matches_jax(family):
    jcfg, jp, tcfg, tp = _models(family)
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, jcfg.vocab_size, (3, 16)).astype(np.int32)
    lengths = np.array([16, 5, 11], np.int32)
    jlog, jk, jv = jl.prefill(jp, jcfg, jnp.asarray(tokens), jnp.asarray(lengths))
    tlog, tk, tv = tl.prefill(
        tp, tcfg, torch.from_numpy(tokens).long(), torch.from_numpy(lengths))
    assert tlog.dtype == torch.float32 and tuple(tlog.shape) == jlog.shape
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


def _pools(jcfg, rng, B, positions, window_tokens):
    """Random stacked pools and block tables: slots 0..B-2 hold pages for
    positions + window_tokens (bounded by MP), the last slot is free."""
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


@pytest.mark.parametrize("family", ["llama", "qwen"])
def test_decode_step_paged_matches_jax(family):
    jcfg, jp, tcfg, tp = _models(family)
    rng = np.random.default_rng(4)
    B = 4
    # Slots 0-2 live at ragged positions; slot 3 is free (row -1).
    positions = np.array([17, 0, 40, 9], np.int32)
    kp, vp, bt = _pools(jcfg, rng, B, positions, 1)
    tokens = rng.integers(1, jcfg.vocab_size, B).astype(np.int32)
    jlog, jk, jv = jl.decode_step_paged(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt))
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tlog, tk, tv = tl.decode_step_paged(
        tp, tcfg, torch.from_numpy(tokens).long(),
        torch.from_numpy(positions).long(), tkp, tvp, torch.from_numpy(bt))
    assert tk is tkp and tv is tvp  # pools updated in place
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
    # Page 0 is scratch (the free slot writes there).
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], atol=ATOL)
    np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:], atol=ATOL)


def test_bf16_logits_keep_the_f32_accumulator():
    """bf16 hidden states and lm_head give the f32 accumulator as logits,
    as JAX's einsum with preferred_element_type=float32 does, not the
    product rounded to bf16."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 256)).astype(np.float32)
    w = rng.standard_normal((64, 256)).astype(np.float32)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = np.array(jnp.einsum("be,ve->bv", jx, jw,
                                 preferred_element_type=jnp.float32))
    got = tl._logits(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    rounded = torch.from_numpy(want).bfloat16().float().numpy()
    assert np.abs(rounded - want).max() > 1e-3  # the check can tell them apart


def test_decode_positions_past_the_block_table_write_scratch():
    """A position past the table (the JAX gather would clamp into a live
    page) writes scratch page 0 and leaves every live page alone."""
    _, _, tcfg, tp = _models("llama")
    NL, KVH, D = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_size
    P = 1 + MP
    kp = torch.zeros((NL, P, PAGE, KVH, D))
    vp = torch.zeros((NL, P, PAGE, KVH, D))
    bt = torch.arange(1, 1 + MP, dtype=torch.int32)[None]
    logits, kp, vp = tl.decode_step_paged(
        tp, tcfg, torch.tensor([3]), torch.tensor([MP * PAGE + 2]), kp, vp, bt)
    assert torch.isfinite(logits).all()
    assert not kp[:, 1:].any() and kp[:, 0].any()


def test_from_hf_dict_and_unported_options():
    cfg = tl.LlamaConfig.from_hf_dict({
        "vocab_size": 100, "hidden_size": 64, "intermediate_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "model_type": "qwen2",
    })
    jcfg = jl.LlamaConfig.from_hf_dict({
        "vocab_size": 100, "hidden_size": 64, "intermediate_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "model_type": "qwen2",
    })
    for f in dataclasses.fields(tl.LlamaConfig):
        if f.name != "dtype":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    _, _, tcfg, tp = _models("llama")
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="LoRA"):
        tl.prefill(tp, tcfg, toks, torch.tensor([4]), lora={})
    with pytest.raises(NotImplementedError, match="A14"):
        tl.prefill(tp, tcfg, toks, torch.tensor([4]), mesh=object())


def test_init_params_shapes_and_tied_head():
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), tie_word_embeddings=True,
                              attention_bias=True)
    p = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp = jl.init_params(dataclasses.replace(
        jl.LlamaConfig.tiny(), tie_word_embeddings=True, attention_bias=True))
    assert p["lm_head"] is p["embed"]
    assert set(p["layers"]) == set(jp["layers"])
    for name, w in p["layers"].items():
        assert tuple(w.shape) == jp["layers"][name].shape, name
        assert w.dtype == torch.bfloat16
    again = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["layers"]["wq"], p["layers"]["wq"])


@pytest.mark.parametrize("family", ["llama", "qwen"])
def test_decode_verify_paged_matches_jax(family):
    """A 5-token verify window (gamma = 4) per slot: logits [B, K, V] and the
    pools it writes. Slot 2's window runs past the block table (positions
    45..49, MP * PAGE = 48); slot 3 is free."""
    jcfg, jp, tcfg, tp = _models(family)
    rng = np.random.default_rng(6)
    B, K = 4, 5
    positions = np.array([17, 0, 45, 9], np.int32)
    kp, vp, bt = _pools(jcfg, rng, B, positions, K)
    tokens = rng.integers(1, jcfg.vocab_size, (B, K)).astype(np.int32)
    jlog, jk, jv = jl.decode_verify_paged(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt))
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tlog, tk, tv = tl.decode_verify_paged(
        tp, tcfg, torch.from_numpy(tokens).long(),
        torch.from_numpy(positions).long(), tkp, tvp, torch.from_numpy(bt))
    assert tk is tkp and tv is tvp  # pools updated in place
    assert tlog.dtype == torch.float32 and tuple(tlog.shape) == jlog.shape
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
    # Page 0 is scratch (the free slot and the positions past the table).
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], atol=ATOL)
    np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:], atol=ATOL)


@pytest.mark.parametrize("family", ["llama", "qwen"])
def test_fused_decode_step_matches_jax_and_per_layer(family):
    jcfg, jp, tcfg, tp = _models(family)
    rng = np.random.default_rng(7)
    B = 4
    positions = np.array([17, 0, 40, 9], np.int32)
    kp, vp, bt = _pools(jcfg, rng, B, positions, 1)
    tokens = rng.integers(1, jcfg.vocab_size, B).astype(np.int32)
    jlog, jk, jv = jl.decode_step_paged(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt), attn_kernel="fused")
    out = {}
    for layout in ("fused", "per_layer"):
        tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
        out[layout] = tl.decode_step_paged(
            tp, tcfg, torch.from_numpy(tokens).long(),
            torch.from_numpy(positions).long(), tkp, tvp,
            torch.from_numpy(bt), attn_kernel=layout)
        assert out[layout][1] is tkp and out[layout][2] is tvp
    tlog, tk, tv = out["fused"]
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], atol=ATOL)
    np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:], atol=ATOL)
    # The free slot's row is junk in both layouts: its table maps every
    # position to scratch page 0, which the per_layer layout writes first.
    plog, pk, pv = out["per_layer"]
    np.testing.assert_allclose(tlog.numpy()[:3], plog.numpy()[:3], atol=ATOL)
    np.testing.assert_allclose(tk.numpy()[:, 1:], pk.numpy()[:, 1:], atol=ATOL)
    np.testing.assert_allclose(tv.numpy()[:, 1:], pv.numpy()[:, 1:], atol=ATOL)


@pytest.mark.parametrize("env,layout", [("fused", "fused"), ("per_layer", "per_layer"),
                                        ("bogus", "per_layer"), ("", "per_layer")])
def test_decode_step_paged_uses_the_layout_it_resolves(monkeypatch, env, layout):
    """No layout given: $KUBEAI_TPU_DECODE_KERNEL decides, in both
    packages alike, and the port's decode step runs the layout it
    resolved."""
    monkeypatch.setenv("KUBEAI_TPU_DECODE_KERNEL", env)
    assert jpa.resolve_decode_kernel(None) == layout
    from kubeai_tpu_torch.ops import paged_attention as tpa

    assert tpa.resolve_decode_kernel(None) == layout
    _, _, tcfg, tp = _models("llama")
    calls = {"fused": 0, "per_layer": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tl, "paged_decode_attention_fused",
                        spy("fused", tl.paged_decode_attention_fused))
    monkeypatch.setattr(tl, "paged_decode_attention",
                        spy("per_layer", tl.paged_decode_attention))
    NL, KVH, D = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_size
    kp = torch.zeros((NL, 1 + MP, PAGE, KVH, D))
    bt = torch.arange(1, 1 + MP, dtype=torch.int32)[None]
    tl.decode_step_paged(tp, tcfg, torch.tensor([3]), torch.tensor([5]), kp,
                         kp.clone(), bt)
    assert calls[layout] == NL and sum(calls.values()) == NL
