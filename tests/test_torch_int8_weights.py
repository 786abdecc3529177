"""Int8 weights in kubeai_tpu_torch against the JAX package, on the CPU (the
port's counterpart of tests/unit/test_engine.py's int8 engine and of the
quantizer cases of tests/unit/test_kv_quant.py).

- The quantizer: `quantize_tensor`, `quantize_params` and `dequantize`
  bit-equal to kubeai_tpu/engine/quantization.py on seeded numpy inputs
  (a dead channel, a negative-only channel, exact halves, bf16 input,
  stacked layers); the N-major layout the kernel reads, and JAX's own
  quantized tree packed into it unchanged.
- `int8_linear`: the plain version on CPU tensors; `check_weight` takes
  every llama-family shape of the catalog and refuses others by name; the
  CUDA kernel's fragment mapping (csrc/w8a16_gemm.cu), emulated in numpy,
  sums each product once and places each output once.
- The model: `prefill`, `prefill_chunk`, the slot `decode_step`,
  `decode_step_paged` in both layouts, `decode_verify_paged` and
  `hidden_states` on int8 weights within 1e-4 of the JAX functions in f32,
  for llama and for qwen with q/k/v biases.
- The engine: greedy and seeded streams identical to the JAX engine's
  with quantization="int8" per_layer, fused, with speculate=3, with
  chunked prefill and the prefix cache, on int8 KV pools, with one LoRA
  adapter, for qwen and with an unquantized draft model.
- Fault C15: the JAX engine takes int8 weights on gemma and its first
  generate raises; the port's engine and entry point refuse at
  construction and at boot.

The JAX engines run once per module, with step_overlap off.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from torch_gemma_checkpoint import hf_config, write_gemma_checkpoint

from kubeai_tpu.engine import Engine as JEngine
from kubeai_tpu.engine import EngineConfig as JEngineConfig
from kubeai_tpu.engine import quantization as jq
from kubeai_tpu.engine.sampling import SamplingParams as JSamplingParams
from kubeai_tpu.models import gemma as jg
from kubeai_tpu.models import llama as jl
from kubeai_tpu_torch.engine import Engine, EngineConfig, SamplingParams
from kubeai_tpu_torch.engine import quantization as tq
from kubeai_tpu_torch.engine.server import main
from kubeai_tpu_torch.models import gemma as tg
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.ops import int8_matmul
from kubeai_tpu_torch.ops.int8_matmul import check_weight, int8_linear
from kubeai_tpu_torch.parity import params_from_numpy, slot_cache_from_numpy

# f32 on both sides through two layers, sums in different orders.
ATOL = 1e-4
CSRC = int8_matmul._build.CSRC / "w8a16_gemm.cu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs thousands of tiny ops: one intra-op thread
    keeps them from spinning against the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the quantizer ---------------------------------------------------------------


def _weight(case: str) -> np.ndarray:
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "stacked":
        return (rng.standard_normal((3, 40, 24)) * 0.02).astype(np.float32)
    if case == "dead":  # tests/unit/test_kv_quant.py: a dead output channel
        w = rng.standard_normal((6, 4)).astype(np.float32)
        w[:, 2] = 0.0
        return w
    if case == "negative":  # a negative-only channel
        return -np.abs(rng.standard_normal((8, 3))).astype(np.float32) - 0.1
    if case == "halves":  # amax 127 -> scale 1: w / scale ends in .5
        w = np.array([[127.0, -127.0], [2.5, -3.5], [0.5, 1.5], [-0.5, 126.5]], np.float32)
        return w
    if case == "bf16":
        return (rng.standard_normal((2, 64, 48)) * 0.05).astype(ml_dtypes.bfloat16)
    return rng.standard_normal((32, 16)).astype(np.float32)


def _torch_weight(w: np.ndarray) -> torch.Tensor:
    if w.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(w.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(w.copy())


def _bits(t) -> np.ndarray:
    """The raw bits of a torch tensor or a JAX/numpy array."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16)
        a = t.contiguous().numpy()
    else:
        a = np.asarray(t)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


@pytest.mark.parametrize("case", ["normal", "stacked", "dead", "negative", "halves", "bf16"])
def test_quantize_tensor_bit_equal_to_jax(case):
    w = _weight(case)
    want = jq.quantize_tensor(jnp.asarray(w))
    got = tq.quantize_tensor(_torch_weight(w))
    assert tq.is_quantized(got) and jq.is_quantized(want)
    assert got["w8"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    assert tuple(got["w8"].shape) == want["w8"].shape
    assert tuple(got["scale"].shape) == want["scale"].shape
    np.testing.assert_array_equal(_bits(got["w8"]), _bits(want["w8"]))
    np.testing.assert_array_equal(_bits(got["scale"]), _bits(want["scale"]))
    np.testing.assert_array_equal(_bits(tq.dequantize(got)), _bits(jq.dequantize(want)))
    # Stored N-major: each [in, out] slice is a transposed contiguous [out, in].
    assert got["w8"].transpose(-1, -2).is_contiguous()
    if case == "dead":
        assert float(got["scale"][0, 2]) == np.float32(1e-8)
        assert not tq.dequantize(got)[:, 2].any()
    if case == "negative":
        assert int(got["w8"].max()) <= 0 and (tq.dequantize(got) <= 0).all()
    if case == "halves":  # round half to even, as numpy rounds
        assert got["w8"][1:].tolist() == [[2, -4], [0, 2], [0, 126]]


def test_quantize_params_bit_equal_to_jax():
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32, attention_bias=True)
    tree = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(3)))
    want = jq.quantize_params(jax.tree.map(jnp.asarray, tree))
    params = params_from_numpy(tree, "cpu")
    got = tq.quantize_params(params)
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    for name, leaf in got["layers"].items():
        if name in tq.QUANTIZABLE:
            for part in ("w8", "scale"):
                np.testing.assert_array_equal(_bits(leaf[part]), _bits(want["layers"][name][part]))
        else:  # biases and norms pass through, the same tensors
            assert leaf is params["layers"][name]
    assert not any(isinstance(w, dict) for w in params["layers"].values())  # left as it was
    assert got["embed"] is params["embed"] and got["lm_head"] is params["lm_head"]
    assert tq.QUANTIZABLE == jq.QUANTIZABLE


def test_jax_quantized_tree_packs_n_major_unchanged():
    """parity.params_from_numpy carries JAX's quantized leaves as int8 and
    f32, outside the dtype cast; quantize_params then only repacks them
    N-major, values unchanged, and packs a packed leaf as is."""
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32)
    jtree = jq.quantize_params(jl.init_params(jcfg, jax.random.PRNGKey(4)))
    carried = params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu", torch.bfloat16)
    leaf = carried["layers"]["w_up"]
    assert leaf["w8"].dtype == torch.int8 and leaf["scale"].dtype == torch.float32
    assert carried["layers"]["input_norm"].dtype == torch.bfloat16
    assert leaf["w8"].is_contiguous()  # JAX's [in, out] order
    packed = tq.quantize_params(carried)["layers"]["w_up"]
    assert packed["w8"].transpose(-1, -2).is_contiguous()
    assert torch.equal(packed["w8"], leaf["w8"]) and torch.equal(packed["scale"], leaf["scale"])
    again = tq.pack_n_major(packed)
    assert again["w8"] is packed["w8"]


def test_weight_bytes_counts_int8_and_scales():
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    q = tq.quantize_params(params)
    E, H, KVH, D, M, NL = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                           cfg.head_size, cfg.intermediate_size, cfg.num_layers)
    outs = {"wq": H * D, "wk": KVH * D, "wv": KVH * D, "wo": E, "w_gate": M, "w_up": M,
            "w_down": E}
    layer_vals = sum(w.numel() for n, w in params["layers"].items() if n in outs)
    saved = layer_vals * 2 - layer_vals - NL * sum(outs.values()) * 4
    assert tq.weight_bytes(params) - tq.weight_bytes(q) == saved


# ---- int8_linear and the kernel's spec ----------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_linear_plain_version(dtype):
    rng = np.random.default_rng(5)
    leaf = tq.quantize_tensor(torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((2, 3, 64)).astype(np.float32)).to(dtype)
    before = int8_linear.launches
    got = int8_linear(x, leaf)
    want = torch.matmul(x, int8_matmul.dequantize_as(leaf, dtype))
    assert got.dtype == dtype and tuple(got.shape) == (2, 3, 48)
    assert torch.equal(got, want)
    assert int8_linear.launches == before  # CPU tensors launch nothing
    deq = int8_matmul.dequantize_as(leaf, dtype)
    if dtype == torch.bfloat16:  # the kernel's weight: dequantize's, bit for bit
        assert torch.equal(deq.view(torch.int16), tq.dequantize(leaf).view(torch.int16))
    else:  # unrounded, as XLA forms it inside the JAX package's jitted dot
        want_f32 = leaf["w8"].float() * leaf["scale"].to(torch.bfloat16).float()
        assert torch.equal(deq, want_f32)
        assert not torch.equal(deq, tq.dequantize(leaf).float())


CATALOG_LLAMA = {
    "Llama-3-8B": dict(hidden_size=4096, intermediate_size=14336, num_attention_heads=32,
                       num_key_value_heads=8),
    "Mistral-7B": dict(hidden_size=4096, intermediate_size=14336, num_attention_heads=32,
                       num_key_value_heads=8),
    "Qwen2.5-0.5B": dict(hidden_size=896, intermediate_size=4864, num_attention_heads=14,
                         num_key_value_heads=2),
    "Llama-3.2-1B": dict(hidden_size=2048, intermediate_size=8192, num_attention_heads=32,
                         num_key_value_heads=8, head_dim=64),
}


@pytest.mark.parametrize("name", list(CATALOG_LLAMA))
def test_check_weight_takes_every_catalog_shape(name):
    cfg = tl.LlamaConfig.from_hf_dict(dict(CATALOG_LLAMA[name], vocab_size=1000,
                                           num_hidden_layers=1))
    E, M, H, KVH, D = (cfg.hidden_size, cfg.intermediate_size, cfg.num_heads,
                       cfg.num_kv_heads, cfg.head_size)
    for k, n in ((E, H * D), (E, KVH * D), (H * D, E), (E, M), (M, E)):
        check_weight({"w8": torch.empty(k, n, dtype=torch.int8, device="meta")})


@pytest.mark.parametrize("k,n", [(100, 64), (64, 40)])
def test_check_weight_names_a_shape_it_does_not_take(k, n):
    with pytest.raises(ValueError, match=rf"\[{k}, {n}\]"):
        check_weight({"w8": torch.empty(k, n, dtype=torch.int8, device="meta")}, "wq")


def _source_int(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", CSRC.read_text()).group(1))


def test_byte_to_float_is_exact():
    """csrc's int8 -> f32: the byte (biased by 128) in the mantissa of
    2^23, minus 2^23 + 128."""
    b = np.arange(-128, 128).astype(np.int8)
    biased = (b.view(np.uint8) ^ 0x80).astype(np.uint32)
    f = (np.uint32(0x4B000000) | biased).view(np.float32) - np.float32(8388736.0)
    np.testing.assert_array_equal(f, b.astype(np.float32))


def _emulate(x: np.ndarray, w8t: np.ndarray, deq_t: np.ndarray, n0: int, m0: int,
             chunks, mt_tiles: int) -> np.ndarray:
    """The kernel's products for 16 channels from n0 and 8 * mt_tiles rows
    from m0 over `chunks`, lane by lane as csrc/w8a16_gemm.cu assigns them:
    lane (g, t) in k16 step j of a chunk holds channel rows g and g + 8 at
    bytes 16t + 4j .. + 3 (A slots 2t, 2t+1, 2t+8, 2t+9) and x's row g at
    the same four k (B). Returns the [16, 8 * mt_tiles] accumulator."""
    chunk = _source_int("kChunk")
    acc = np.zeros((16, 8 * mt_tiles))
    for c in chunks:
        for j in range(4):
            for mt in range(mt_tiles):
                A, B = np.zeros((16, 16)), np.zeros((16, 8))
                for g in range(8):
                    for t in range(4):
                        ks = c * chunk + 16 * t + 4 * j + np.arange(4)
                        slots = [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]
                        A[g, slots] = deq_t[n0 + g, ks]
                        A[g + 8, slots] = deq_t[n0 + g + 8, ks]
                        m = m0 + mt * 8 + g
                        B[slots, g] = x[m, ks] if m < x.shape[0] else 0.0
                acc[:, mt * 8:(mt + 1) * 8] += A @ B
    return acc


def test_kernel_fragment_mapping_sums_each_product_once():
    rng = np.random.default_rng(8)
    M, N, K = 13, 32, 2 * _source_int("kChunk")
    w = rng.standard_normal((K, N)).astype(np.float32)
    leaf = tq.quantize_tensor(torch.from_numpy(w))
    deq_t = tq.dequantize(leaf).float().numpy().T.astype(np.float64)  # [N, K]
    w8t = leaf["w8"].t().numpy()
    x = rng.standard_normal((M, K))
    want = x @ deq_t.T  # [M, N]
    for n0 in (0, 16):
        # Skinny: its warps take the chunks in any split; tiled: in order.
        got = _emulate(x, w8t, deq_t, n0, 0, [1, 0], 2)
        np.testing.assert_allclose(got[:, :M].T, want[:, n0:n0 + 16], rtol=1e-12, atol=1e-12)
    # The skinny kernel's reduction places each (lane, register) once.
    mt_tiles, seen = 8, set()
    for e in range(mt_tiles * 4 * 32):
        i, lane = e >> 5, e & 31
        n = (lane >> 2) + (8 if (i & 3) >= 2 else 0)
        m = (i >> 2) * 8 + 2 * (lane & 3) + (i & 1)
        seen.add((n, m))
    assert seen == {(n, m) for n in range(16) for m in range(8 * mt_tiles)}
    assert _source_int("kSkinnyMaxM") == int8_matmul.SKINNY_MAX_M
    assert _source_int("kTileN") == int8_matmul.TILE_N


def test_gemm_splits_fill_the_card_from_shapes():
    """The tiled kernel's K split: none for the skinny kernel or where the
    tiles fill two waves; for a 96- or 128-row prefill on Llama-3-8B's
    narrow weights, enough 64-row tiles for two CTAs an SM, each split at
    least MIN_SPLIT_CHUNKS chunks."""
    splits = int8_matmul.gemm_splits
    assert splits(64, 1024, 4096) == 1 and splits(4096, 14336, 4096) == 1
    for m, n, k in ((96, 4096, 4096), (128, 1024, 4096), (512, 1024, 4096),
                    (128, 4096, 14336)):
        z = splits(m, n, k)
        tiles = -(-n // int8_matmul.TILE_N) * -(-m // 64)
        assert 1 < z <= int8_matmul.MAX_SPLITS
        assert tiles * z <= 2 * int8_matmul.SMS
        assert k // 64 // z >= int8_matmul.MIN_SPLIT_CHUNKS
    assert splits(128, 128, 896) == 1  # Qwen2.5-0.5B's wk: 14 chunks


# ---- the model --------------------------------------------------------------------


def _family_models(family: str):
    """(JAX config, JAX int8 tree, port config, port int8 params) in f32,
    each side quantizing the same f32 weights with its own quantizer."""
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32,
                               attention_bias=(family == "qwen"))
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32,
                               attention_bias=(family == "qwen"))
    tree = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(1)))
    if family == "qwen":
        rng = np.random.default_rng(2)
        for b in ("bq", "bk", "bv"):
            tree["layers"][b] = (rng.standard_normal(tree["layers"][b].shape) * 0.1
                                 ).astype(np.float32)
    jp = jq.quantize_params(jax.tree.map(jnp.asarray, tree))
    return jcfg, jp, tcfg, tq.quantize_params(params_from_numpy(tree, "cpu"))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


PAGE, MP = 8, 6


def _pools(jcfg, rng, B, positions, window_tokens):
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


def _forward(fn: str, jcfg, jp, tcfg, tp, rng):
    """(port outputs, JAX outputs) of one model function on int8 weights."""
    T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    V = jcfg.vocab_size
    if fn == "prefill":
        tokens = rng.integers(1, V, (3, 16)).astype(np.int32)
        lengths = np.array([16, 5, 11], np.int32)
        return (tl.prefill(tp, tcfg, T(tokens).long(), T(lengths)),
                jl.prefill(jp, jcfg, jnp.asarray(tokens), jnp.asarray(lengths)))
    if fn == "hidden_states":
        tokens = rng.integers(1, V, (3, 16)).astype(np.int32)
        lengths = np.array([16, 5, 11], np.int32)
        return ((tl.hidden_states(tp, tcfg, T(tokens).long(), T(lengths)),),
                (jl.hidden_states(jp, jcfg, jnp.asarray(tokens), jnp.asarray(lengths)),))
    NL, KVH, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_size
    if fn == "prefill_chunk":
        ks = rng.standard_normal((NL, 64, KVH, D)).astype(np.float32)
        vs = rng.standard_normal((NL, 64, KVH, D)).astype(np.float32)
        tokens = rng.integers(1, V, (1, 16)).astype(np.int32)
        return (tl.prefill_chunk(tp, tcfg, T(tokens).long(), torch.tensor(16), torch.tensor(40),
                                 T(ks), T(vs), want_logits=True),
                jl.prefill_chunk(jp, jcfg, jnp.asarray(tokens), jnp.int32(16), jnp.int32(40),
                                 jnp.asarray(ks), jnp.asarray(vs), want_logits=True))
    if fn == "decode_step":
        ck = rng.standard_normal((NL, 4, 64, KVH, D)).astype(np.float32)
        cv = rng.standard_normal((NL, 4, 64, KVH, D)).astype(np.float32)
        tokens = rng.integers(1, V, 4).astype(np.int32)
        positions = np.array([10, 0, 63, 31], np.int32)
        cache = slot_cache_from_numpy(ck, cv)
        return (tl.decode_step(tp, tcfg, T(tokens).long(), T(positions).long(), cache.k,
                               cache.v),
                jl.decode_step(jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
                               jnp.asarray(ck), jnp.asarray(cv)))
    K = 3 if fn == "decode_verify_paged" else 1
    positions = np.array([17, 0, 30, 9], np.int32)
    kp, vp, bt = _pools(jcfg, rng, 4, positions, K)
    if fn == "decode_verify_paged":
        tokens = rng.integers(1, V, (4, K)).astype(np.int32)
        got = tl.decode_verify_paged(tp, tcfg, T(tokens).long(), T(positions).long(), T(kp),
                                     T(vp), T(bt))
        want = jl.decode_verify_paged(jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
                                      jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt))
    else:
        layout = fn.split(":")[1]
        tokens = rng.integers(1, V, 4).astype(np.int32)
        got = tl.decode_step_paged(tp, tcfg, T(tokens).long(), T(positions).long(), T(kp),
                                   T(vp), T(bt), attn_kernel=layout)
        want = jl.decode_step_paged(jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
                                    jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
                                    attn_kernel=layout)
    # Page 0 is scratch (the free slot writes there).
    return (got[0], got[1][:, 1:], got[2][:, 1:]), (want[0], want[1][:, 1:], want[2][:, 1:])


FUNCTIONS = ["prefill", "prefill_chunk", "decode_step", "decode_step_paged:per_layer",
             "decode_step_paged:fused", "decode_verify_paged", "hidden_states"]


@pytest.mark.parametrize("fn", FUNCTIONS)
@pytest.mark.parametrize("family", ["llama", "qwen"])
def test_model_on_int8_weights_matches_jax(family, fn):
    jcfg, jp, tcfg, tp = _family_models(family)
    got, want = _forward(fn, jcfg, jp, tcfg, tp, np.random.default_rng(9))
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.asarray(w).shape
        _close(g, w)
    if fn == "prefill":  # int8 moves the logits off the f32 model's
        bf = params_from_numpy(jax.tree.map(np.asarray, jl.init_params(
            jcfg, jax.random.PRNGKey(1))), "cpu")
        if family == "qwen":
            bf["layers"].update({b: tp["layers"][b] for b in ("bq", "bk", "bv")})
        rng = np.random.default_rng(9)
        tokens = torch.from_numpy(rng.integers(1, jcfg.vocab_size, (3, 16))).long()
        full = tl.prefill(bf, tcfg, tokens, torch.tensor([16, 5, 11]))[0]
        assert (full - got[0]).abs().max() > 1e-4


# ---- the engine -------------------------------------------------------------------

BASE = dict(num_slots=4, max_seq_len=128, page_size=16, decode_chunk=4,
            quantization="int8")
SAMPLING = {
    "greedy": dict(temperature=0.0, max_tokens=12),
    "seeded": dict(temperature=0.8, top_k=16, top_p=0.9, max_tokens=12, seed=5),
}
SCENARIOS = {
    "per_layer": {},
    "fused": dict(decode_kernel="fused"),
    "speculate": dict(speculate=3, spec_adaptive=False),
    "prefix": dict(prefill_chunk=16, prefix_cache=True),
    "kv_int8": dict(kv_dtype="int8"),
    "lora": dict(max_adapters=1, max_lora_rank=8),
    "qwen": {},
    "draft": dict(speculate=3, spec_adaptive=False),
}


def _prompts():
    rng = np.random.default_rng(7)
    system = rng.integers(1, 256, 18).tolist()
    # One prefill bucket (17-32 tokens): fewer JAX programs to compile; a
    # shared system prompt for the prefix cache; a repeat for prompt lookup.
    return [system + rng.integers(1, 256, 5).tolist(),
            system + rng.integers(1, 256, 9).tolist(),
            (rng.integers(1, 256, 6).tolist() * 4)[:22],
            rng.integers(1, 256, 30).tolist(),
            rng.integers(1, 256, 24).tolist()]


def _adapter(cfg):
    rng = np.random.default_rng(11)
    dims = tl.lora_dims(cfg)
    return {t: ((rng.standard_normal((cfg.num_layers, dims[t][0], 4)) * 0.3).astype(np.float32),
                (rng.standard_normal((cfg.num_layers, 4, dims[t][1])) * 0.3).astype(np.float32))
            for t in ("wq", "wv")}


@dataclasses.dataclass
class _Side:
    """One package's engine classes, f32 cache dtype, model and draft."""

    engine: type
    config: type
    sampling: type
    dtype: object
    models: dict


def _sides():
    jcfgs, tcfgs, jtrees, ttrees = {}, {}, {}, {}
    for name, kw in (("llama", {}), ("qwen", dict(attention_bias=True)),
                     ("draft", dict(num_layers=1, hidden_size=32, intermediate_size=64))):
        jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32, **kw)
        tree = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(len(name))))
        if name == "qwen":
            rng = np.random.default_rng(2)
            for b in ("bq", "bk", "bv"):
                tree["layers"][b] = (rng.standard_normal(tree["layers"][b].shape) * 0.1
                                     ).astype(np.float32)
        jcfgs[name], jtrees[name] = jcfg, jax.tree.map(jnp.asarray, tree)
        tcfgs[name] = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32, **kw)
        ttrees[name] = params_from_numpy(tree, "cpu")
    return (_Side(JEngine, JEngineConfig, JSamplingParams, jnp.float32,
                  {n: (jcfgs[n], jtrees[n]) for n in jcfgs}),
            _Side(Engine, EngineConfig, SamplingParams, torch.float32,
                  {n: (tcfgs[n], ttrees[n]) for n in tcfgs}))


def _run(side: _Side, scenario: str, **extra):
    """The scenario's engine on `side`, each prompt greedy then seeded (the
    LoRA scenario's odd requests on the adapter); returns (streams,
    spec_stats, prefix_stats, engine)."""
    family = "qwen" if scenario == "qwen" else "llama"
    cfg, params = side.models[family]
    kw = {}
    if scenario == "draft":
        kw["draft"] = side.models["draft"]
    if side.engine is Engine:
        kw["device"] = "cpu"
    eng = side.engine(family, cfg, params, cfg=side.config(
        cache_dtype=side.dtype, **{**BASE, **SCENARIOS[scenario], **extra}), **kw)
    if scenario == "lora":
        eng.load_adapter("a1", _adapter(side.models["llama"][0]))
    rids = []
    for i, prompt in enumerate(_prompts()):
        for mode in SAMPLING:
            adapter = "a1" if scenario == "lora" and len(rids) % 2 else None
            rids.append(eng.add_request(prompt, side.sampling(**SAMPLING[mode]),
                                        adapter=adapter))
    out = {rid: [] for rid in rids}
    while eng.has_work():
        for ev in eng.step():
            out[ev.rid].append(ev.token)
    return [out[r] for r in rids], dict(eng.spec_stats), dict(eng.prefix_stats), eng


@pytest.fixture(scope="module")
def sides():
    return _sides()


@pytest.fixture(scope="module")
def jax_runs(sides):
    return {name: _run(sides[0], name, step_overlap="off")[:3] for name in SCENARIOS}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_int8_streams_identical_to_jax(sides, jax_runs, scenario):
    streams, spec, prefix, eng = _run(sides[1], scenario)
    want_streams, want_spec, want_prefix = jax_runs[scenario]
    assert streams == want_streams
    assert spec == want_spec and prefix == want_prefix
    assert all(len(s) == 12 for s in streams)
    layers = eng.params["layers"]
    assert all(layers[n]["w8"].dtype == torch.int8 for n in tq.QUANTIZABLE)
    if scenario in ("speculate", "draft"):
        assert spec["windows"] > 0
    if scenario == "prefix":
        assert prefix["hit_tokens"] > 0
    if scenario == "lora":
        assert streams[1] != streams[0] or streams[3] != streams[2]
    if scenario == "draft":  # the draft stays unquantized, as in the JAX engine
        assert not any(isinstance(w, dict) for w in eng._draft_params["layers"].values())
    if scenario == "kv_int8":
        assert eng.kv_cache_info()["quantized"]


# ---- fault C15: gemma on int8 weights ---------------------------------------------


def test_gemma_int8_weights_fault_c15(tmp_path):
    """The JAX engine builds gemma on int8 weights and its first generate
    raises (the forwards read no quantized leaf); the port refuses at
    construction, and its entry point at boot."""
    jcfg = dataclasses.replace(jg.GemmaConfig.tiny(), dtype=jnp.float32)
    jeng = JEngine("gemma", jcfg, jg.init_params(jcfg, jax.random.PRNGKey(0)),
                   cfg=JEngineConfig(num_slots=2, max_seq_len=64, quantization="int8"))
    with pytest.raises(ValueError, match="Cannot determine the shape"):
        jeng.generate([[1, 2, 3]], JSamplingParams(temperature=0.0, max_tokens=2))
    tcfg = tg.GemmaConfig.tiny()
    params = tg.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="fault C15"):
        Engine("gemma", tcfg, params, cfg=EngineConfig(num_slots=2, max_seq_len=64,
                                                       quantization="int8"), device="cpu")
    write_gemma_checkpoint(tmp_path, hf_config(True), seed=3)
    with pytest.raises(SystemExit) as e:
        main(["--model-url", str(tmp_path), "--device", "cpu", "--quantization", "int8"])
    assert "fault C15" in str(e.value.code)
