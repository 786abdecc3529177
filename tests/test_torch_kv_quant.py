"""Int8 KV pools in kubeai_tpu_torch against the JAX package, on the CPU:
the port's counterpart of tests/unit/test_kv_quant.py.

- ops: `quantize_kv` gives the JAX package's int8 values bit for bit and
  its scales exactly (round half to even, a division by the scale), zero
  rows dequantize to exact zeros, `resolve_kv_dtype` and the capacity
  factor agree; the plain paged decode attention over int8 pages and
  scales matches JAX's reference at 1e-4 in f32, and so does the CPU
  emulation of B1's int8 read at the split edges; the three page writes
  (quantize-on-append for one token and for prefilled sequences, and the
  verbatim write of wire bytes) are bit-equal to JAX's.
- the engine: `Engine(kv_dtype="int8")` refuses speculation and the fused
  layout with the JAX engine's messages, and its greedy and seeded streams
  equal the JAX int8 engine's over a full pool, a tight pool that
  preempts, and chunked prefill with prefix-cache hits; overlap on and off.
  The pools after `generate` hold the JAX engine's int8 rows (pages 1..,
  every row the JAX engine wrote; scales within 1e-6 relative: f32 K/V in
  XLA and in torch differ by an ulp) and `kv_cache_info` is JAX's.
- the wire: a JAX int8 handoff continues in a port engine and a port
  handoff in a JAX engine, each import writing the blob's bytes; a peer
  page export and a spilled page cross in both directions and re-export
  byte for byte.
- HTTP: `/v1/state.kv_cache` and the two quantization gauges,
  `--kv-dtype int8` parsed into the EngineConfig, a bf16 handoff refused
  on an int8 server with the JAX server's status and body, and a bf16
  replica whose peer fetch from an int8 holder is refused and recomputes.

Weights: the same tiny f32 llama on both sides (params_from_numpy).
"""

import dataclasses
import http.client
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from testutil import http_get, http_post

from kubeai_tpu.disagg import handoff as jhandoff
from kubeai_tpu.engine import Engine as JEngine
from kubeai_tpu.engine import EngineConfig as JEngineConfig
from kubeai_tpu.engine import paged_cache as jpc
from kubeai_tpu.engine.sampling import SamplingParams as JSamplingParams
from kubeai_tpu.engine.server import EngineServer as JEngineServer
from kubeai_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from kubeai_tpu.models import llama as jl
from kubeai_tpu.objstore import KVSpillStore as JKVSpillStore
from kubeai_tpu.ops import kv_quant as jkq
from kubeai_tpu.ops import paged_attention as jpa
from kubeai_tpu_torch.disagg import handoff
from kubeai_tpu_torch.engine import Engine, EngineConfig, SamplingParams
from kubeai_tpu_torch.engine import paged_cache as tpc
from kubeai_tpu_torch.engine.server import EngineServer, engine_config, parse_args
from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.objstore import KVSpillStore
from kubeai_tpu_torch.ops import kv_quant as tkq
from kubeai_tpu_torch.ops import paged_attention as tpa
from kubeai_tpu_torch.parity import params_from_numpy
from torch_split_walk import constant, emulate_split_walk

TOK = ByteTokenizer()
PAGE = 16
BASE = dict(num_slots=4, max_seq_len=128, page_size=PAGE, decode_chunk=4)
CHUNKED = dict(prefill_chunk=16, prefix_cache=True)
SAMPLING = {
    "greedy": dict(temperature=0.0, max_tokens=12),
    "seeded": dict(temperature=0.8, top_k=16, top_p=0.9, max_tokens=12, seed=9),
}
PROMPT = "the quick brown fox jumps over the lazy dog, twice"
# f32 K/V in XLA and in torch differ by about an ulp, and so do their
# row maxima: the scales are held at this relative tolerance.
SCALE_RTOL = 1e-6
# The same ulp can carry row / scale across a .5 rounding edge, and the
# int8 value then lands one step over: the chunked pool's greedy waves
# flip 2 of 15,296 values (ROADMAP C6); the streams stay equal. Each
# value may be at most one step off, and at most this share of them.
FLIP_SHARE = 1e-3


def _q(x):
    """A torch QuantizedPool as numpy (q8, scale)."""
    return x.q8.numpy(), x.scale.numpy()


# ---- ops ------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 2, 32)).astype(np.float32) * 4
    # Exact halves: row max 127, scale 1, so x / scale lands on .5 and
    # both sides round half to even.
    x[0, 0, 0] = np.concatenate([[127.0], np.arange(31) - 15.5])
    x[0, 0, 1] = 0.0  # a zero row
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    want_q, want_s = (np.asarray(a) for a in jkq.quantize_kv(jnp.asarray(x, dtype)))
    got_q, got_s = tkq.quantize_kv(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    assert got_q[0, 0, 0, 1:].tolist() == list(np.round(np.arange(31) - 15.5).astype(int))
    for out in (torch.float32, torch.bfloat16):
        deq = tkq.dequantize_kv(got_q, got_s, out).float().numpy()
        jdeq = np.asarray(jkq.dequantize_kv(jnp.asarray(want_q), jnp.asarray(want_s),
                                            jnp.float32 if out == torch.float32 else jnp.bfloat16),
                          np.float32)
        np.testing.assert_array_equal(deq, jdeq)


def test_zero_rows_are_exact():
    q8, scale = tkq.quantize_kv(torch.zeros(2, 3, 16))
    assert not q8.any() and bool((scale == tkq.SCALE_FLOOR).all())
    assert not tkq.dequantize_kv(q8, scale, torch.float32).any()
    assert tkq.SCALE_FLOOR == jkq.SCALE_FLOOR and tkq.KV_DTYPES == jkq.KV_DTYPES


@pytest.mark.parametrize("name", ["", " INT8 ", "bfloat16", "int4", "bf16"])
def test_resolve_kv_dtype_matches_jax(name):
    try:
        want = jkq.resolve_kv_dtype(name)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tkq.resolve_kv_dtype(name)
        assert str(got.value) == str(e)
    else:
        assert tkq.resolve_kv_dtype(name) == want


@pytest.mark.parametrize("d", [16, 64, 128])
def test_capacity_factor_matches_jax(d):
    assert tkq.kv_capacity_factor(d) == jkq.kv_capacity_factor(d)
    assert tkq.kv_capacity_factor(128) == pytest.approx(1.9394, abs=1e-4)


B, KVH, G, D, MP = 3, 2, 4, 32, 4
H, P = KVH * G, 1 + B * MP


def _int8_setup(lengths, seed=0, mp=MP, d=D):
    """q, int8 pools with their scales (from quantize_kv of numpy values),
    block tables of `mp` entries with each slot's pages shuffled, lengths;
    head_dim `d`."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * mp
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    pools = []
    for _ in range(2):
        q8, scale = jkq.quantize_kv(jnp.asarray(rng.standard_normal((n_pages, 8, KVH, d)),
                                                jnp.float32))
        pools.append((np.asarray(q8), np.asarray(scale)))
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.full((B, mp), -1, np.int32)
    used = 0
    for s, ln in enumerate(lengths):
        need = min(-(-ln // 8), mp)
        bt[s, :need] = perm[used:used + need]
        used += need
    return q, pools, bt, np.asarray(lengths, np.int32)


def _pools(pools):
    t = [tkq.QuantizedPool(torch.from_numpy(q8.copy()), torch.from_numpy(s.copy()))
         for q8, s in pools]
    j = [{"q8": jnp.asarray(q8), "scale": jnp.asarray(s)} for q8, s in pools]
    return t, j


@pytest.mark.parametrize("lengths,cap,win", [
    ([5, 17, 32], None, None), ([1, 8, 9], 30.0, None), ([9, 26, 31], None, 12),
    ([32, 32, 31], 50.0, 7),
])
def test_plain_int8_attention_matches_jax_reference(lengths, cap, win):
    q, pools, bt, ln = _int8_setup(lengths, seed=sum(lengths))
    (tk, tv), (jk, jv) = _pools(pools)
    kw = dict(logit_softcap=cap, window=win)
    want = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(ln), **kw))
    tpa.paged_decode_attention_int8.launches = 0
    tpa.paged_decode_attention.launches = 0
    got = tpa.paged_decode_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(bt),
                                     torch.from_numpy(ln), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    # The CPU takes the plain version: no kernel launched, neither count moved.
    assert tpa.paged_decode_attention_int8.launches == tpa.paged_decode_attention.launches == 0


# A block table long enough that int8_split cuts it (4 splits of 8 pages).
INT8_SPLIT_MP = 32


@pytest.mark.parametrize("pages_per_split", [1, 2, 3, None])
@pytest.mark.parametrize("case,cap,win", [
    ("boundary", None, None), ("short", 30.0, 5), ("past", 50.0, 12),
])
def test_int8_split_walk_matches_jax_reference(pages_per_split, case, cap, win):
    """B1's int8 read, emulated: the int8 walk (K's scale after the dot,
    V's scale in P), at a split boundary and one either side, 0 and 1 and
    past two splits, and past the block table, against JAX's reference on
    the same int8 pages and scales. None is the wrapper's choice,
    int8_split, on a 32-entry table. Slots that keep no key are 0 in the
    walk (the reference averages every column there) and are checked
    apart."""
    mp = MP
    if pages_per_split is None:
        mp = INT8_SPLIT_MP
        num_splits, pages_per_split = tpa.int8_split(B, KVH, mp, 8)
        assert num_splits > 1
    e, L = pages_per_split * 8, mp * 8
    lengths = {"boundary": [e, e - 1, e + 1], "short": [0, 1, min(2 * e + 1, L)],
               "past": [L + 3, L + 17, e]}[case]
    q, pools, bt, ln = _int8_setup(lengths, seed=41 + pages_per_split, mp=mp)
    (tk, tv), (jk, jv) = _pools(pools)
    got = emulate_split_walk(q, tk, tv, bt, ln, pages_per_split, cap=cap, win=win)
    want = np.asarray(jpa.ref_paged_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(ln),
        logit_softcap=cap, window=win))
    keeps = np.array([n > 0 and (not win or n - win < L) for n in ln])
    assert not got[~keeps].any()
    np.testing.assert_allclose(got[keeps], want[keeps], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("pages_per_split", [1, 3, None])
@pytest.mark.parametrize("case,cap,win", [
    ("boundary", None, None), ("short", 50.0, 5), ("past", 50.0, 12),
])
def test_int8_split_walk_at_head_dim_256_matches_jax_reference(pages_per_split, case, cap,
                                                               win):
    """B1's int8 read at Gemma's head_dim 256, emulated with the D = 256
    split (None: int8_split(..., 256) on a 32-entry table), Gemma-2's
    softcap 50 and a window, against JAX's reference on the same int8
    pages and scales, at split edges and past the table."""
    mp, d = INT8_SPLIT_MP, 256
    if pages_per_split is None:
        num_splits, pages_per_split = tpa.int8_split(B, KVH, mp, 8, d)
        assert num_splits > 1
    e, L = pages_per_split * 8, mp * 8
    lengths = {"boundary": [e, e - 1, e + 1], "short": [0, 1, min(2 * e + 1, L)],
               "past": [L + 3, L + 17, e]}[case]
    q, pools, bt, ln = _int8_setup(lengths, seed=61 + pages_per_split, mp=mp, d=d)
    (tk, tv), (jk, jv) = _pools(pools)
    got = emulate_split_walk(q, tk, tv, bt, ln, pages_per_split, cap=cap, win=win)
    want = np.asarray(jpa.ref_paged_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(ln),
        logit_softcap=cap, window=win))
    keeps = np.array([n > 0 and (not win or n - win < L) for n in ln])
    assert not got[~keeps].any()
    np.testing.assert_allclose(got[keeps], want[keeps], atol=1e-4, rtol=1e-4)


# Shapes of the head_dim-256 int8 walk: Gemma-2-9B (8 kv heads), Gemma-7B
# (16) and Gemma-2B (1) at 8 slots of 8,192 tokens, one slot, 16- and
# 128-token pages, short and odd tables.
D256_SHAPES = [(8, 8, 128, 64), (8, 16, 128, 64), (8, 1, 128, 64), (1, 8, 128, 64),
               (8, 8, 512, 16), (2, 4, 1000, 128), (8, 8, 4, 64), (3, 2, 4, 8),
               (64, 8, 128, 64)]


@pytest.mark.parametrize("shape", D256_SHAPES)
def test_int8_split_at_head_dim_256_covers_every_entry_within_its_cap(shape):
    """At head_dim 256 every block-table entry falls in one split, a split
    holds at most _INT8_D256_MAX_SPLIT_TOKENS tokens (one page if a page
    is longer) and at most kMaxSplitPages entries, and at least one
    16-token tile a warp where the table allows; head_dim 128 keeps its
    own choice."""
    batch, kv_heads, max_pages, page = shape
    num_splits, per = tpa.int8_split(*shape, 256)
    bound = constant("paged_split_walk_int8.cuh", "kMaxSplitPages")
    assert 1 <= per <= min(max_pages, bound)
    assert per <= max(1, tpa._INT8_D256_MAX_SPLIT_TOKENS // page)
    assert num_splits * per >= max_pages > (num_splits - 1) * per
    assert per * page >= min(64, max_pages * page)
    assert tpa.int8_split(*shape) == tpa.int8_split(*shape, 128)
    if batch == 1:  # a lone slot: one wave of two CTAs an SM
        assert kv_heads * num_splits <= 2 * 132


# The fused_split values B1, B3 and B4 take at these shapes; int8_split
# leaves them as they are.
FUSED_SPLITS = {
    (8, 8, 32, 64): (8, 4), (1, 8, 256, 64): (64, 4), (64, 8, 32, 64): (1, 32),
    (3, 2, 4, 8): (1, 4), (1, 1, 1, 16): (1, 1), (256, 8, 4096, 16): (64, 64),
    (2, 4, 1000, 128): (63, 16), (4, 8, 8, 64): (8, 1),
}


@pytest.mark.parametrize("shape", sorted(FUSED_SPLITS))
def test_int8_split_covers_every_block_table_entry(shape):
    """Every block-table entry falls in one split, a split holds at most
    the int8 walk's kMaxSplitPages entries (read from its source), and
    fused_split's values for B1, B3 and B4 are unchanged."""
    batch, kv_heads, max_pages, page = shape
    num_splits, per = tpa.int8_split(*shape)
    bound = constant("paged_split_walk_int8.cuh", "kMaxSplitPages")
    assert 1 <= per <= min(max_pages, bound)
    assert num_splits * per >= max_pages > (num_splits - 1) * per
    assert per * page >= min(64, max_pages * page)  # a 16-token tile per warp at least
    assert tpa.fused_split(*shape) == FUSED_SPLITS[shape]


def _int8_ctas_per_sm() -> int:
    """CTAs of the int8 walk that fit one H100 SM at D = 128, G <= 4, from
    its shared memory (constants read from its source)."""
    src = "paged_split_walk_int8.cuh"
    warps, tile, stages, max_pages = (constant(src, n) for n in (
        "kWarps", "kTile", "kStages", "kMaxSplitPages"))
    ring = warps * stages * (2 * tile * 128 + 2 * tile * 4)
    smem = ring + warps * (tile + 1) * 4 * 4 + 4 * max_pages + 1024  # + the SM's reserve
    return 228 * 1024 // smem


def test_int8_split_at_the_serving_shapes():
    """The 8B serving shape (8 slots, 8 kv heads, 32 pages of 64): ragged
    lengths leave splits empty, so the split aims past the resident CTAs
    (fused_split's 4 pages; 8 were slower on the card). A lone slot at 16k:
    every split holds keys, so every CTA is resident at once, in one wave,
    with twice fused_split's pages."""
    assert _int8_ctas_per_sm() == 3
    assert tpa.int8_split(8, 8, 32, 64) == (8, 4)
    num_splits, per = tpa.int8_split(1, 8, 256, 64)
    assert per == 2 * tpa.fused_split(1, 8, 256, 64)[1]
    assert 132 < 8 * num_splits <= 132 * _int8_ctas_per_sm()


def test_int8_wrapper_splits_from_shapes():
    """The int8 wrapper takes int8_split, from shapes alone: it never copies
    a tensor to the host, so a CUDA graph can hold it."""
    import inspect

    src = inspect.getsource(tpa.paged_decode_attention_int8)
    cuda_path = src.split('if q.device.type != "cuda"', 1)[1]
    for reader in (".item(", ".tolist(", ".cpu(", ".numpy(", "int(lengths", "lengths.max"):
        assert reader not in cuda_path
    assert "int8_split(b, kvh, mp, page, d)" in cuda_path
    assert "fused_split" not in cuda_path


def test_scatters_bit_equal_to_jax():
    """Quantize-on-append for one token per slot and for padded prefilled
    sequences, and the verbatim write of already-quantized rows."""
    rng = np.random.default_rng(5)
    NL, S, A = 2, 20, 2
    shape = (NL, P, 8, KVH, D)
    tk = [tkq.make_quantized_pool(shape) for _ in range(2)]
    jk = [jkq.make_quantized_pool(shape) for _ in range(2)]
    bt = np.array([[3, 7, 2, -1], [5, 1, 9, 11]], np.int32)
    lengths = np.array([17, 20], np.int32)
    seq = [rng.standard_normal((NL, A, S, KVH, D)).astype(np.float32) for _ in range(2)]
    jids, joffs = jpa.batched_sequence_page_coords(jnp.asarray(bt), jnp.asarray(lengths), S, 8)
    tids, toffs = tpa.batched_sequence_page_coords(torch.from_numpy(bt),
                                                   torch.from_numpy(lengths), S, 8)
    jk = list(jpa.batched_scatter_sequence(*jk, *(jnp.asarray(s) for s in seq), jids, joffs))
    tpa.batched_scatter_sequence(*tk, *(torch.from_numpy(s) for s in seq), tids, toffs)
    # One token per slot at positions 20 and 21 (layer 1).
    new = [rng.standard_normal((A, KVH, D)).astype(np.float32) for _ in range(2)]
    pos = np.array([17, 20], np.int32)
    jp, jo = jpa.token_page_coords(jnp.asarray(bt), jnp.asarray(pos), 8)
    tp_, to = tpa.token_page_coords(torch.from_numpy(bt), torch.from_numpy(pos), 8)
    jl1 = jpa.scatter_decode_token(*({k: v[1] for k, v in p.items()} for p in jk),
                                   *(jnp.asarray(n) for n in new), jp, jo)
    tpa.scatter_decode_token(tk[0][1], tk[1][1], *(torch.from_numpy(n) for n in new), tp_, to)
    for i in range(2):
        jk[i] = {k: jk[i][k].at[1].set(jl1[i][k]) for k in ("q8", "scale")}
    # Wire rows, written verbatim at slot 0's first 12 positions.
    q8 = rng.integers(-127, 128, (NL, 12, KVH, D)).astype(np.int8)
    sc = rng.random((NL, 12, KVH)).astype(np.float32)
    ids, offs = jpa.sequence_page_coords(jnp.asarray(bt[0]), 12, 12, 8)
    jk = list(jpa.scatter_sequence_prequantized(*jk, jnp.asarray(q8), jnp.asarray(sc),
                                                jnp.asarray(-q8), jnp.asarray(sc * 2), ids, offs))
    tpa.scatter_sequence_prequantized(
        *tk, torch.from_numpy(q8), torch.from_numpy(sc), torch.from_numpy(-q8),
        torch.from_numpy(sc * 2), torch.from_numpy(np.array(ids)).long(),
        torch.from_numpy(np.array(offs)).long())
    for t, j in zip(tk, jk):
        # Page 0 is scratch: the padding rows of the batch all land there.
        np.testing.assert_array_equal(t.q8.numpy()[:, 1:], np.asarray(j["q8"])[:, 1:])
        np.testing.assert_array_equal(t.scale.numpy()[:, 1:], np.asarray(j["scale"])[:, 1:])
    # The dequantized views of every slot agree too.
    tcache = tpc.PagedKVCache(tk[0], tk[1], torch.from_numpy(bt))
    jcache = jpc.PagedKVCache(jk[0], jk[1], jnp.asarray(bt))
    assert tcache.quantized and jcache.quantized and tcache.pages_shape == jcache.pages_shape
    assert tcache.nbytes() == jcache.nbytes()
    for got, want in zip(tpc.gather_slot_kv(tcache), jpc.gather_slot_kv(jcache)):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_int8_wrapper_has_no_path_off_the_card_and_checks_its_inputs():
    import ctypes

    from kubeai_tpu_torch.ops import COUNTED_KERNELS, _build

    # Its own C entry (pointers and the stream as c_void_p) and its own
    # launch count, apart from bf16 B1's.
    sig = _build.SIGNATURES["kubeai_paged_decode_int8"]
    assert sig[:9] == (ctypes.c_void_p,) * 9 and sig[-1] is ctypes.c_void_p
    assert COUNTED_KERNELS["paged_decode_attention_int8"] is tpa.paged_decode_attention_int8
    meta = dict(device="meta")
    q = torch.empty(2, 8, 64, dtype=torch.bfloat16, **meta)
    pool = tkq.QuantizedPool(torch.empty(3, 8, 2, 64, dtype=torch.int8, **meta),
                             torch.empty(3, 8, 2, dtype=torch.float32, **meta))
    bt = torch.zeros(2, 1, dtype=torch.int32, **meta)
    ln = torch.ones(2, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="no path"):
        tpa.paged_decode_attention(q, pool, pool, bt, ln)
    # The checks the CUDA path runs before a launch.
    tpa._check_decode_int8_args(q, pool, pool, bt, ln, None)
    bad = tkq.QuantizedPool(pool.q8, torch.empty(3, 8, 2, dtype=torch.bfloat16, **meta))
    with pytest.raises(TypeError, match="float32 v_pages.scale"):
        tpa._check_decode_int8_args(q, pool, bad, bt, ln, None)
    with pytest.raises(ValueError, match="scales"):
        tpa._check_decode_int8_args(q, pool, tkq.QuantizedPool(pool.q8, pool.scale[:2]),
                                    bt, ln, None)
    with pytest.raises(TypeError, match="QuantizedPool"):
        tpa._check_decode_int8_args(q, pool.q8, pool, bt, ln, None)


# ---- the engine -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=TOK.vocab_size), dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=TOK.vocab_size), dtype=torch.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _port_engine(models, **kw):
    _, _, tcfg, tparams = models
    return Engine("llama", tcfg, tparams, cfg=EngineConfig(
        cache_dtype=torch.float32, kv_dtype="int8", **{**BASE, **kw}),
        eos_token_ids=TOK.eos_token_ids, device="cpu")


def _jax_engine(models, **kw):
    jcfg, jparams, _, _ = models
    return JEngine("llama", jcfg, jparams, cfg=JEngineConfig(
        cache_dtype=jnp.float32, kv_dtype="int8", step_overlap="off", **{**BASE, **kw}),
        eos_token_ids=TOK.eos_token_ids)


def _waves():
    """Two waves of prompts: six of mixed lengths (more than the slots),
    then three sharing the first's 40-token head (prefix hits when the
    cache is on)."""
    rng = np.random.default_rng(3)
    first = [rng.integers(1, 256, n).tolist() for n in (40, 5, 20, 70, 3, 33)]
    second = [first[0] + rng.integers(1, 256, n).tolist() for n in (4, 11, 30)]
    return [first, second]


POOLS = {"full": {}, "tight": {"num_pages": 1 + 9}, "chunked": CHUNKED}


@pytest.fixture(scope="module")
def jax_side(models):
    """Per pool, one JAX int8 engine: its streams for each sampling mode in
    turn (the two waves each), and after the greedy waves its pools,
    kv_cache_info and prefix stats. The engines serve the wire tests
    after."""
    out = {}
    for pool, kw in POOLS.items():
        eng = _jax_engine(models, **kw)
        for mode, sp in SAMPLING.items():
            out[pool, mode] = [eng.generate(w, JSamplingParams(**sp)) for w in _waves()]
            if mode == "greedy":
                out[pool, "pools"] = [
                    (np.asarray(p["q8"]), np.asarray(p["scale"]))
                    for p in (eng.cache.k_pages, eng.cache.v_pages)]
                out[pool, "info"] = eng.kv_cache_info()
        out[pool, "prefix"] = dict(eng.prefix_stats)
        out[pool, "engine"] = eng
    return out


def test_engine_refusals_match_jax(models):
    jcfg, jparams, tcfg, tparams = models
    for kw in (dict(speculate=2), dict(decode_kernel="fused")):
        with pytest.raises(ValueError) as want:
            JEngine("llama", jcfg, jparams,
                    cfg=JEngineConfig(num_slots=2, max_seq_len=64, kv_dtype="int8", **kw))
        with pytest.raises(ValueError) as got:
            Engine("llama", tcfg, tparams, device="cpu",
                   cfg=EngineConfig(num_slots=2, max_seq_len=64, kv_dtype="int8", **kw))
        assert str(got.value) == str(want.value)
    # The model refuses a quantized pool in the fused layout, as JAX's does.
    pool = tkq.make_quantized_pool((tcfg.num_layers, 2, PAGE, 2, 16))
    with pytest.raises(ValueError, match="attn_kernel='per_layer'"):
        tl.decode_step_paged(tparams, tcfg, torch.zeros(1, dtype=torch.long),
                             torch.zeros(1, dtype=torch.long), pool, pool,
                             torch.zeros(1, 1, dtype=torch.int32), attn_kernel="fused")


@pytest.mark.parametrize("overlap", ["off", "on"])
@pytest.mark.parametrize("pool", list(POOLS))
def test_streams_identical_to_jax(models, jax_side, pool, overlap):
    """Greedy then seeded, two waves each, on one engine as on the JAX
    side: every stream equal, the same preemptions and prefix hits."""
    eng = _port_engine(models, step_overlap=overlap, **POOLS[pool])
    assert isinstance(eng.cache.k_pages, tkq.QuantizedPool)
    preempted = []
    eng.on_preempt = lambda rid, client: preempted.append(rid)
    for mode, sp in SAMPLING.items():
        got = [eng.generate(w, SamplingParams(**sp)) for w in _waves()]
        assert got == jax_side[pool, mode], mode
        if mode == "greedy" and overlap == "off":
            assert eng.kv_cache_info() == jax_side[pool, "info"]
            # Every row the JAX engine wrote (pages 1..): int8 values
            # equal but for rare one-step flips, scales within an ulp's
            # worth. Page 0 is scratch.
            for tpool, (jq, js) in zip((eng.cache.k_pages, eng.cache.v_pages),
                                       jax_side[pool, "pools"]):
                tq, ts = _q(tpool)
                written = js[:, 1:] > 0
                assert written.any()
                step = np.abs(tq[:, 1:][written].astype(np.int32)
                              - jq[:, 1:][written].astype(np.int32))
                assert step.max() <= 1 and (step > 0).mean() <= FLIP_SHARE, (
                    f"{int((step > 0).sum())} of {step.size} int8 values differ")
                np.testing.assert_allclose(ts[:, 1:], js[:, 1:], rtol=SCALE_RTOL, atol=0)
    if pool == "tight":
        assert preempted, "the tight pool must force a preemption"
    # Hits attend over the dequantized prefix in both engines.
    assert eng.prefix_stats == jax_side[pool, "prefix"]
    if pool == "chunked":
        assert eng.prefix_stats["hit_tokens"] >= 2 * 3 * 2 * PAGE
    assert eng._alloc.free_pages == eng._n_pages - 1


def test_kv_cache_info_reports_quantization(models):
    info = _port_engine(models).kv_cache_info()
    bf16 = Engine("llama", models[2], models[3], cfg=EngineConfig(**BASE),
                  device="cpu").kv_cache_info()
    assert info["dtype"] == "int8" and info["quantized"] is True
    assert bf16["dtype"] == "bfloat16" and bf16["quantized"] is False
    assert info["capacity_factor"] == tkq.kv_capacity_factor(16) and bf16["capacity_factor"] == 1.0
    assert info["pool_bytes"] / bf16["pool_bytes"] == pytest.approx((16 + 4) / (2 * 16))


def _drain(eng, rid, first) -> list[int]:
    out = [first]
    while eng.has_work():
        out += [e.token for e in eng.step() if e.rid == rid]
    return out


@pytest.mark.parametrize("mode", list(SAMPLING))
def test_handoffs_cross_between_jax_and_port(models, jax_side, mode):
    """A JAX int8 handoff continues in a port engine, whose pool then holds
    the blob's int8 rows and scales, and a port handoff continues in a JAX
    engine; both streams are the JAX engine's unified stream."""
    ids = TOK.encode(PROMPT)
    sp = dict(SAMPLING[mode], max_tokens=10)
    jeng = jax_side["full", "engine"]
    unified = jeng.generate([ids], JSamplingParams(**sp))[0]
    jh = jeng.export_handoff(ids, JSamplingParams(**sp))
    assert jh.dtype == "int8" and jh.quantized
    port = _port_engine(models)
    th = handoff.deserialize(jhandoff.serialize(jh))
    rid, ev = port.import_handoff(th)
    pages = torch.as_tensor(port._alloc.pages_for(port._requests[rid].slot))
    (kq, vq), (ks, vs) = th.contiguous_kv(), th.contiguous_scales()
    for pool, q8, sc in ((port.cache.k_pages, kq, ks), (port.cache.v_pages, vq, vs)):
        held = pool[:, pages]
        nl, _, _, kvh, d = held.shape
        np.testing.assert_array_equal(held.q8.reshape(nl, -1, kvh, d)[:, :th.plen].numpy(), q8)
        np.testing.assert_array_equal(held.scale.reshape(nl, -1, kvh)[:, :th.plen].numpy(), sc)
    assert _drain(port, rid, ev.token) == unified
    # The reverse: the port exports, the JAX engine imports and continues.
    back = _port_engine(models).export_handoff(ids, SamplingParams(**sp))
    assert back.dtype == "int8" and back.quantized and back.first_token == jh.first_token
    rid, ev = jeng.import_handoff(jhandoff.deserialize(handoff.serialize(back)))
    assert _drain(jeng, rid, ev.token) == unified


def _chain(eng, ids):
    return eng.compute_prefix_chain(ids)[: (len(ids) - 1) // PAGE]


def test_page_exports_and_spills_cross_byte_for_byte(models, jax_side):
    """Peer page exports, JAX to port and port to JAX, and spills, each
    side's spill hook to the other side's fill (source="spill"): the
    importer's re-export of the chain is the exporter's blob byte for
    byte."""
    jeng = jax_side["chunked", "engine"]
    sp = SamplingParams(temperature=0.0, max_tokens=2)

    def blob(eng, chain):
        wire = handoff if isinstance(eng, Engine) else jhandoff
        return wire.serialize_pages(eng.export_prefix_pages(chain))

    # JAX to port: pages the JAX engine holds from its waves.
    chain = _chain(jeng, _waves()[1][0])
    assert len(chain) >= 2 and jeng.cached_prefix_depth(chain) == len(chain)
    port = _port_engine(models, **CHUNKED)
    assert port.import_prefix_pages(handoff.deserialize_pages(blob(jeng, chain))) == len(chain)
    assert blob(port, chain) == blob(jeng, chain)
    # Port to JAX: a prompt the JAX engine has not seen.
    ids = TOK.encode("peer pages from the port: " + PROMPT)
    port.generate([ids], sp)
    chain = _chain(port, ids)
    assert jeng.import_prefix_pages(jhandoff.deserialize_pages(blob(port, chain))) == len(chain)
    assert blob(jeng, chain) == blob(port, chain)
    # Spills, each way, of a page the filler does not hold.
    for spiller, filler, store, text in (
        (port, jeng, KVSpillStore(), "spilled by the port: "),
        (jeng, _port_engine(models, **CHUNKED), JKVSpillStore(), "spilled by jax: "),
    ):
        ids = TOK.encode(text + PROMPT)
        if isinstance(spiller, Engine):
            spiller.generate([ids], sp)
        else:
            spiller.generate([ids], JSamplingParams(temperature=0.0, max_tokens=2))
        chain = _chain(spiller, ids)[:1]
        spiller.enable_kv_spill(store)
        h = bytes.fromhex(chain[0])
        spiller._alloc.on_evict(spiller._alloc.lookup([h])[0], h)
        spiller._alloc.on_evict = None
        spilled = store.get(chain[0])
        wire = handoff if isinstance(filler, Engine) else jhandoff
        export = wire.deserialize_pages(spilled)
        assert export.quantized and export.dtype == "int8"
        assert filler.import_prefix_pages(export, source="spill") == 1
        assert filler.kv_share_stats["filled_pages"] >= 1
        assert blob(filler, chain) == spilled


# ---- HTTP -------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def servers(models, jax_side):
    """A port int8 replica with KV sharing and a spill store, a port bf16
    replica with KV sharing, and a JAX int8 server over the chunked JAX
    engine."""
    out = {
        "a8": EngineServer(_port_engine(models, **CHUNKED), TOK, "tiny", port=0,
                           kv_sharing=True, kv_spill_store=KVSpillStore()),
        "bf16": EngineServer(
            Engine("llama", models[2], models[3], device="cpu",
                   cfg=EngineConfig(cache_dtype=torch.float32, **BASE, **CHUNKED)),
            TOK, "tiny", port=0, kv_sharing=True),
        "jax8": JEngineServer(jax_side["chunked", "engine"], JByteTokenizer(),
                              "tiny", host="127.0.0.1", port=0),
    }
    for srv in out.values():
        srv.start()
    yield out
    for srv in out.values():
        srv.stop()


def _addr(srv) -> str:
    return f"127.0.0.1:{srv.port}"


def _gen(srv, req, headers=None) -> dict:
    status, body = http_post(_addr(srv), "/v1/completions", req, headers=headers)
    assert status == 200, body
    return json.loads(body)["choices"][0]


def test_state_and_gauges_report_quantization(servers):
    state = json.loads(http_get(_addr(servers["a8"]), "/v1/state")[1])
    want = json.loads(http_get(_addr(servers["jax8"]), "/v1/state")[1])
    assert state["kv_cache"] == want["kv_cache"]
    assert state["kv_cache"]["dtype"] == "int8" and state["kv_cache"]["quantized"]
    text = http_get(_addr(servers["a8"]), "/metrics")[1].decode()
    assert "kubeai_engine_kv_quant_enabled 1" in text
    assert "kubeai_engine_kv_quant_capacity_factor 1.6" in text
    assert "kubeai_engine_kv_quant_enabled 0" in http_get(
        _addr(servers["bf16"]), "/metrics")[1].decode()


def test_kv_dtype_flag_is_parsed():
    args = parse_args(["--model-url", "x", "--kv-dtype", "int8"])
    assert engine_config(args).kv_dtype == "int8"
    assert engine_config(parse_args(["--model-url", "x"])).kv_dtype == ""


def _post_blob(addr: str, blob: bytes, headers=None) -> tuple[int, bytes]:
    host, _, port = addr.partition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    conn.request("POST", "/v1/kv/import", body=blob,
                 headers={"Content-Length": str(len(blob)), **(headers or {})})
    resp = conn.getresponse()
    out = resp.status, resp.read()
    conn.close()
    return out


def test_bf16_handoff_refused_on_an_int8_server_as_jax(servers):
    shape = (2, 1, PAGE, 2, 16)
    bf16 = jhandoff.serialize(jhandoff.KVHandoff(
        token_ids=list(range(1, 9)), first_token=5, first_finish="", page_size=PAGE,
        dtype="bfloat16", k_pages=np.ones(shape, ml_dtypes.bfloat16),
        v_pages=np.ones(shape, ml_dtypes.bfloat16), seed=1, temperature=0.0,
        top_k=0, top_p=1.0, max_tokens=4))
    answers = []
    for name in ("a8", "jax8"):
        status, body = _post_blob(_addr(servers[name]), bf16, {"X-Handoff-Id": "bf16"})
        assert status == 200, body
        answers.append(http_post(_addr(servers[name]), "/v1/completions",
                                 {"model": "tiny", "prompt": "x"},
                                 headers={"X-Disagg-Handoff": "bf16"}))
    assert answers[0][0] == answers[1][0] == 400
    assert json.loads(answers[0][1]) == json.loads(answers[1][1])
    assert b"dtype" in answers[0][1]


def test_cross_dtype_peer_fetch_recomputes(models, servers):
    """A bf16 replica pointed at an int8 holder: the fetch is refused, the
    failure is counted, nothing is imported, and the answer is the bf16
    engine's own."""
    req = {"model": "tiny", "prompt": "a wholly distinct saga of dtype disagreement",
           "max_tokens": 8, "temperature": 0}
    _gen(servers["a8"], req)  # the int8 holder serves and holds the prefix
    bf = servers["bf16"]
    fails = bf.metrics.kv_fetch_failures.get(source="peer")
    imported = bf.engine.kv_share_stats["imported_pages"]
    got = _gen(bf, req, headers={"X-KV-Source": _addr(servers["a8"])})
    assert bf.metrics.kv_fetch_failures.get(source="peer") > fails
    assert bf.engine.kv_share_stats["imported_pages"] == imported
    ref = Engine("llama", models[2], models[3], device="cpu", eos_token_ids=TOK.eos_token_ids,
                 cfg=EngineConfig(cache_dtype=torch.float32, **BASE)).generate(
        [TOK.encode(req["prompt"])], SamplingParams(temperature=0.0, max_tokens=8))[0]
    assert got["text"] == TOK.decode(ref)
