"""Mixtral in kubeai_tpu_torch against the JAX package, on the CPU in f32:
the model functions and the weights (the engine's streams are in
tests/test_torch_mixtral_engine.py).

The weights are tests/torch_mixtral_fixtures.py's `mixtral_models`: the
JAX `init_params` draw on `MixtralConfig.tiny()` (4 experts, top-2),
scaled so that the routing, the attention and the experts each move the
output.

- `_moe_ffn` within 1e-4 of the JAX function, the port's gate and up
  stacks being the JAX ones with the expert axis moved (`parity`); a
  router whose 2nd and 3rd logits tie for every token picks JAX's
  experts (the lower index), and the pick changes the output.
- `prefill`, `decode_step` (slot cache), `decode_step_paged` (per_layer
  and fused, and per_layer on int8 pools) and `prefill_chunk` (against
  the JAX chunk and against whole-prompt prefill): logits and caches
  within 1e-4.
- The weights: an HF-named checkpoint loads bit-equal through both
  packages' loaders (the gate and up stacks up to the axis order), and
  the native checkpoint round-trips the tree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_mixtral_fixtures import hf_config, mixtral_models, port_config, write_mixtral_checkpoint

from kubeai_tpu.engine import weights as jweights
from kubeai_tpu.models import mixtral as jm
from kubeai_tpu.ops import kv_quant as jkq
from kubeai_tpu_torch.engine import weights
from kubeai_tpu_torch.models import mixtral as tm
from kubeai_tpu_torch.models.registry import get_model_family
from kubeai_tpu_torch.ops import kv_quant as tkq
from kubeai_tpu_torch.parity import MIXTRAL_EXPERT_MINOR, params_from_numpy

# f32 on both sides through two layers, sums in different orders.
ATOL = 1e-4


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
    return mixtral_models()


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


# ---- the config and the parameter tree --------------------------------------------


def test_config_matches_jax():
    assert port_config(jm.MixtralConfig.tiny()) == dataclasses.replace(
        tm.MixtralConfig.tiny(), dtype=torch.float32)
    assert port_config(jm.MixtralConfig()) == dataclasses.replace(
        tm.MixtralConfig(), dtype=torch.float32)
    for d in (hf_config(), hf_config(num_local_experts=8, rope_theta=1e6),
              {k: v for k, v in hf_config().items()
               if k not in ("num_key_value_heads", "num_local_experts",
                            "num_experts_per_tok", "rope_theta")}):
        jcfg, tcfg = jm.MixtralConfig.from_hf_dict(d), tm.MixtralConfig.from_hf_dict(d)
        assert dataclasses.replace(port_config(jcfg), dtype=torch.bfloat16) == tcfg
        assert tcfg.head_size == jcfg.head_size
    family = get_model_family("MixtralForCausalLM")
    assert family.name == "mixtral" and family is get_model_family("mixtral")
    assert family.decode_verify_paged is None and family.init_lora_buffers is None
    assert family.hidden_states is None and not family.int8_weights
    assert family.prefill_chunk is tm.prefill_chunk and family.decode_step is tm.decode_step


def test_params_from_numpy_carries_the_mixtral_tree(models):
    jcfg, jp, _, tp = models
    tree = jax.tree.map(np.asarray, jp)
    assert set(tp["layers"]) == set(tree["layers"])
    for name, w in tree["layers"].items():
        want = np.swapaxes(w, 1, 2) if name in MIXTRAL_EXPERT_MINOR else w
        assert tp["layers"][name].is_contiguous(), name
        assert torch.equal(tp["layers"][name], torch.from_numpy(np.array(want))), name
    for name in ("embed", "final_norm", "lm_head"):
        assert torch.equal(tp[name], torch.from_numpy(np.array(tree[name]))), name
    # bf16 trees come across bit for bit.
    bf = jax.tree.map(np.asarray, jm.init_params(jm.MixtralConfig.tiny(),
                                                 jax.random.PRNGKey(2)))
    got = params_from_numpy(bf)
    for name, w in bf["layers"].items():
        want = np.swapaxes(w, 1, 2) if name in MIXTRAL_EXPERT_MINOR else w
        assert got["layers"][name].dtype == torch.bfloat16
        assert np.array_equal(got["layers"][name].view(torch.int16).numpy(),
                              want.view(np.int16)), name


def test_init_params_layout():
    cfg = tm.MixtralConfig.tiny()
    p = tm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    j = jm.init_params(jm.MixtralConfig.tiny())
    assert set(p) == set(j) and set(p["layers"]) == set(j["layers"])
    for name, w in p["layers"].items():
        want = j["layers"][name].shape
        if name in MIXTRAL_EXPERT_MINOR:  # [NL, X, E, M] -> [NL, E, X, M]
            want = (want[0], want[2], want[1], want[3])
        assert tuple(w.shape) == want and w.dtype == torch.bfloat16, name
        if name.endswith("norm"):
            assert bool((w == 1).all())
    assert tuple(p["lm_head"].shape) == j["lm_head"].shape


def test_init_params_needs_a_card_unless_told(monkeypatch):
    from kubeai_tpu_torch.device import NoCudaDevice

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        tm.init_params(tm.MixtralConfig.tiny())


# ---- the mixture of experts ---------------------------------------------------------


def _port_layer(tp, i: int = 0) -> dict:
    return {name: w[i] for name, w in tp["layers"].items()}


def _jax_layer(jp, i: int = 0) -> dict:
    return {name: w[i] for name, w in jp["layers"].items()}


@pytest.mark.parametrize("shape", [(3, 5), (4,)], ids=["prefill", "decode"])
def test_moe_ffn_matches_jax(models, shape):
    jcfg, jp, tcfg, tp = models
    x = np.random.default_rng(9).standard_normal((*shape, jcfg.hidden_size)).astype(np.float32)
    for i in range(jcfg.num_layers):
        jx = jnp.asarray(x if len(shape) == 2 else x[:, None])
        want = jm._moe_ffn(jx, _jax_layer(jp, i), jcfg)
        got = tm._moe_ffn(torch.from_numpy(x), _port_layer(tp, i), tcfg)
        _close(got, want if len(shape) == 2 else np.asarray(want)[:, 0])


def _tied_router(jcfg, rng) -> np.ndarray:
    """A router whose logits order the experts 0 first, then 2 and 3 tied
    (identical columns), then 1, for every token whose feature 0 is at
    least 1 (the other features reach the logits through weights of std
    0.01)."""
    E = jcfg.hidden_size
    router = np.zeros((E, jcfg.num_experts), np.float32)
    router[0] = [4.0, -4.0, 1.0, 1.0]
    router[1:, 0] = rng.standard_normal(E - 1) * 0.01
    router[1:, 1] = rng.standard_normal(E - 1) * 0.01
    router[1:, 2] = router[1:, 3] = rng.standard_normal(E - 1) * 0.01
    return router


def test_moe_ffn_ties_pick_the_jax_experts(models):
    """The 2nd and 3rd router logits tie exactly for every token: JAX's
    top_k takes the lower index (expert 2), and so must the port; taking
    expert 3 instead gives another output."""
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(10)
    router = _tied_router(jcfg, rng)
    x = rng.standard_normal((2, 6, jcfg.hidden_size)).astype(np.float32)
    x[..., 0] = 1.0 + rng.random((2, 6))
    logits = x @ router
    assert np.array_equal(logits[..., 2], logits[..., 3])
    assert (logits[..., 0] > logits[..., 2]).all() and (logits[..., 2] > logits[..., 1]).all()
    _, jidx = jax.lax.top_k(jnp.asarray(logits), 2)
    _, tidx = tm.top_k_stable(torch.from_numpy(logits), 2)
    assert np.array_equal(np.asarray(jidx), tidx.numpy())
    assert (tidx[..., 1] == 2).all()
    jl = dict(_jax_layer(jp), router=jnp.asarray(router))
    tl = dict(_port_layer(tp), router=torch.from_numpy(router))
    want = jm._moe_ffn(jnp.asarray(x), jl, jcfg)
    got = tm._moe_ffn(torch.from_numpy(x), tl, tcfg)
    _close(got, want)
    # The tie decides: with column 3 a hair ahead, JAX takes expert 3.
    nudged = router.copy()
    nudged[0, 3] += 1e-3
    other = jm._moe_ffn(jnp.asarray(x), dict(jl, router=jnp.asarray(nudged)), jcfg)
    assert np.abs(np.asarray(other) - np.asarray(want)).max() > 1e-2
    # Four tied values: the stable sort orders them by index (torch.topk
    # returns [3, 5, 2] for this row on the CPU).
    probe = torch.tensor([[0.5, 1.0, 1.0, 1.0, 0.25, 1.0]])
    assert tm.top_k_stable(probe, 3)[1].tolist() == [[1, 2, 3]]
    assert tm.top_k_stable(probe, 3)[0].tolist() == [[1.0, 1.0, 1.0]]


def test_moe_ffn_reads_the_weights_in_place(models, monkeypatch):
    """The expert products take the stacks as stored: every weight handed
    to a matmul or bmm is the stack's own memory (a view), so no product
    copies a weight."""
    _, _, tcfg, tp = models
    lp = _port_layer(tp)
    stores = {lp[n].untyped_storage().data_ptr() for n in ("w_gate", "w_up", "w_down")}
    seen = []
    real_mm, real_bmm = torch.matmul, torch.bmm

    def note(fn):
        def wrapped(a, b):
            seen.append(b.untyped_storage().data_ptr())
            return fn(a, b)
        return wrapped

    monkeypatch.setattr(torch, "matmul", note(real_mm))
    monkeypatch.setattr(torch, "bmm", note(real_bmm))
    tm._moe_ffn(torch.randn(5, tcfg.hidden_size), lp, tcfg)
    assert stores <= set(seen)


# ---- the model functions ----------------------------------------------------------


def test_prefill_matches_jax(models):
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, jcfg.vocab_size, (3, 24)).astype(np.int32)
    lengths = np.array([24, 10, 17], np.int32)
    want = jm.prefill(jp, jcfg, jnp.asarray(tokens), jnp.asarray(lengths))
    got = tm.prefill(tp, tcfg, torch.from_numpy(tokens).long(), torch.from_numpy(lengths))
    for g, w in zip(got, want):
        _close(g, w)


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
def test_decode_step_paged_matches_jax(models, layout):
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(5)
    positions = np.array([17, 0, 40, 9], np.int32)
    kp, vp, bt = _pools(jcfg, rng, 4, positions)
    tokens = rng.integers(1, jcfg.vocab_size, 4).astype(np.int32)
    jlog, jk, jv = jm.decode_step_paged(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(bt), attn_kernel=layout)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tlog, tk2, tv2 = tm.decode_step_paged(
        tp, tcfg, torch.from_numpy(tokens).long(), torch.from_numpy(positions).long(),
        tk, tv, torch.from_numpy(bt), attn_kernel=layout)
    assert tk2 is tk and tv2 is tv  # updated in place
    _close(tlog, jlog)
    # Page 0 is scratch (the free slot writes there).
    _close(tk[:, 1:], np.asarray(jk)[:, 1:])
    _close(tv[:, 1:], np.asarray(jv)[:, 1:])


def test_decode_step_on_int8_pools_matches_jax(models):
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(6)
    positions = np.array([17, 0, 40, 9], np.int32)
    kp, vp, bt = _pools(jcfg, rng, 4, positions)
    pools = [tuple(np.asarray(a) for a in jkq.quantize_kv(jnp.asarray(x))) for x in (kp, vp)]
    jpools = [{"q8": jnp.asarray(q8), "scale": jnp.asarray(s)} for q8, s in pools]
    tpools = [tkq.QuantizedPool(torch.from_numpy(q8.copy()), torch.from_numpy(s.copy()))
              for q8, s in pools]
    tokens = rng.integers(1, jcfg.vocab_size, 4).astype(np.int32)
    jlog, jk, jv = jm.decode_step_paged(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions), *jpools, jnp.asarray(bt),
        attn_kernel="per_layer")
    args = (tp, tcfg, torch.from_numpy(tokens).long(), torch.from_numpy(positions).long(),
            *tpools, torch.from_numpy(bt))
    tlog, tk, tv = tm.decode_step_paged(*args, attn_kernel="per_layer")
    _close(tlog, jlog)
    for t, j in ((tk, jk), (tv, jv)):
        assert np.array_equal(t.q8[:, 1:].numpy(), np.asarray(j["q8"])[:, 1:])
        _close(t.scale[:, 1:], np.asarray(j["scale"])[:, 1:])
    with pytest.raises(ValueError) as want:
        jm.decode_step_paged(jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
                             *jpools, jnp.asarray(bt), attn_kernel="fused")
    with pytest.raises(ValueError, match="per_layer") as got:
        tm.decode_step_paged(*args, attn_kernel="fused")
    assert str(got.value) == str(want.value)


def test_decode_step_matches_jax(models):
    """The slot-cache step: each slot's row written at its position in
    place, then the plain attention over the row."""
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(7)
    NL, KVH, D, B, L = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_size, 3, 32
    kc = rng.standard_normal((NL, B, L, KVH, D)).astype(np.float32)
    vc = rng.standard_normal((NL, B, L, KVH, D)).astype(np.float32)
    tokens = rng.integers(1, jcfg.vocab_size, B).astype(np.int32)
    positions = np.array([5, 0, 31], np.int32)
    jlog, jk, jv = jm.decode_step(jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
                                  jnp.asarray(kc), jnp.asarray(vc))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tlog, tk2, tv2 = tm.decode_step(tp, tcfg, torch.from_numpy(tokens).long(),
                                    torch.from_numpy(positions).long(), tk, tv)
    assert tk2 is tk and tv2 is tv
    _close(tlog, jlog)
    _close(tk, jk)
    _close(tv, jv)


def test_prefill_chunk_matches_jax_and_whole_prompt(models):
    """21 tokens in chunks of 8 into a 32-token staging cache: each chunk
    against the JAX chunk, the last chunk's logits and the cache against
    whole-prompt prefill."""
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(8)
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
        jlog, jk, jv = jm.prefill_chunk(jp, jcfg, jnp.asarray(chunk), jnp.int32(start),
                                        jnp.int32(n), jk, jv, want_logits=last)
        tlog, tk, tv = tm.prefill_chunk(tp, tcfg, torch.from_numpy(chunk).long(),
                                        torch.tensor(start), torch.tensor(n), tk, tv,
                                        want_logits=last)
        _close(tk, jk)
        _close(tv, jv)
        assert (tlog is None) == (not last)
    _close(tlog, jlog)
    whole, k_all, v_all = tm.prefill(tp, tcfg, torch.from_numpy(prompt[None]).long(),
                                     torch.tensor([n]))
    np.testing.assert_allclose(tlog.numpy(), whole.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tk[:, :n].numpy(), k_all[:, 0].numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv[:, :n].numpy(), v_all[:, 0].numpy(), atol=ATOL, rtol=0)


# ---- the weights ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_load_params_bit_equal_to_jax_loader(tmp_path, dtype):
    """An HF-named checkpoint (stored bf16, or f32 that both loaders round
    to bf16) loads bit-equal through both packages: the router from
    `block_sparse_moe.gate`, w1 as gate, w3 as up, w2 as down."""
    model_dir = write_mixtral_checkpoint(tmp_path, hf_config(), seed=4, dtype=dtype)
    hf = weights.load_hf_config(model_dir)
    jcfg, tcfg = jm.MixtralConfig.from_hf_dict(hf), tm.MixtralConfig.from_hf_dict(hf)
    assert get_model_family(hf["architectures"][0]).name == "mixtral"
    want = jax.tree.map(np.asarray, jweights.load_mixtral_params(model_dir, jcfg))
    got = weights.load_params("mixtral", model_dir, tcfg, device="cpu")
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    leaves = [(k, got[k], want[k]) for k in ("embed", "final_norm", "lm_head")]
    leaves += [(k, got["layers"][k], want["layers"][k]) for k in want["layers"]]
    for name, g, w in leaves:
        if name in MIXTRAL_EXPERT_MINOR:
            w = np.swapaxes(w, 1, 2)
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape, name
        assert g.is_contiguous(), name
        assert np.array_equal(g.view(torch.int16).numpy(), w.view(np.int16)), name
    # The stacks hold the experts HF names: layer 1, expert 3.
    w1 = weights.LazyTensors(model_dir).stored(
        "model.layers.1.block_sparse_moe.experts.3.w1.weight").to(torch.bfloat16)
    assert torch.equal(got["layers"]["w_gate"][1, :, 3], w1.T)
    with pytest.raises(weights.WeightLoadError, match="missing tensor"):
        weights.load_params("mixtral", model_dir, dataclasses.replace(tcfg, num_experts=5),
                            device="cpu")


def test_native_checkpoint_round_trips_the_mixtral_tree(tmp_path, models):
    """The tree a restore-first boot snapshots (engine/coldstart.py)
    comes back bit for bit, in the port's layout."""
    _, _, _, tp = models
    bf = {k: ({n: w.to(torch.bfloat16) for n, w in v.items()} if k == "layers"
              else v.to(torch.bfloat16)) for k, v in tp.items()}
    weights.save_native_checkpoint(str(tmp_path), bf)
    back = weights.load_native_checkpoint(str(tmp_path), device="cpu")
    assert set(back) == set(bf) and set(back["layers"]) == set(bf["layers"])
    for name, w in bf["layers"].items():
        assert back["layers"][name].shape == w.shape and back["layers"][name].is_contiguous()
        assert torch.equal(back["layers"][name].view(torch.int16), w.view(torch.int16)), name
    for name in ("embed", "final_norm", "lm_head"):
        assert torch.equal(back[name].view(torch.int16), bf[name].view(torch.int16)), name
