"""kubeai_tpu_torch.ops.flash_attention against kubeai_tpu's Pallas flash
prefill kernel (interpret mode, force=True): on CPU tensors the port's
flash_causal_prefill is its plain version. Tolerance rtol/atol 2e-3, the
JAX kernel test's own.

The CUDA kernel (csrc/flash_prefill.cu) runs only on the card. Its
algorithm is emulated here in f32 in its own tile order, with its block
sizes read from the source, and held against the JAX kernel and the plain
version, at each head_dim the kernel builds (64, 128 and 256, whose
build walks 64-key tiles). Every build's CTA owns 128 query rows, 64 to
each of its two consumer warpgroups, which hold O whole."""

import functools
import inspect
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.ops.attention import causal_prefill_attention as j_causal
from kubeai_tpu.ops.pallas_attention import flash_causal_prefill as j_flash
from kubeai_tpu_torch.ops import flash_attention as tfa
from kubeai_tpu_torch.ops.attention import NEG_INF, causal_prefill_attention

_SRC = (Path(tfa.__file__).resolve().parent.parent / "csrc" / "flash_prefill.cu").read_text()
# Query rows per CTA (`kBQ = 128`) and keys per K/V tile, a constant of
# the head_dim (`kBK<D> = D == 256 ? 64 : 128`).
_BQ = int(re.search(r"constexpr int kBQ = (\d+);", _SRC).group(1))
_BK = re.search(r"constexpr int kBK = D == (\d+) \? (\d+) : (\d+);", _SRC)
STAGES = int(re.search(r"constexpr int kStages = (\d+);", _SRC).group(1))
ROWS = 64  # query rows per consumer warpgroup (one wgmma's M)


def BQ(d):
    """The kernel's query rows per CTA at head_dim d: 64 per consumer
    warpgroup, two consumers, at every head_dim."""
    return _BQ


def BK(d):
    """The kernel's keys per K/V tile at head_dim d."""
    return int(_BK.group(2)) if d == int(_BK.group(1)) else int(_BK.group(3))


def tiles_needed(r0, s, bk):
    """The key tiles a consumer whose rows start at r0 computes: up to its
    last row below S, none if it has none (the kernel's n_mine)."""
    return -(-min(r0 + ROWS, s) // bk) if r0 < s else 0
# The card's limit for the kernel against the plain version (chip_smoke.py
# FLASH_ATOL / FLASH_RTOL): the kernel also rounds P to bf16.
FLASH_TOL = 2e-2


def _mk(B, S, H, KVH, D, seed):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D))
    )


@functools.lru_cache(maxsize=None)
def _jax_case(S, group, D, block=128):
    """Inputs and the JAX Pallas kernel's output (interpret mode, q and k
    blocks of `block`, which must divide S)."""
    KVH = 2
    q, k, v = _mk(1, S, KVH * group, KVH, D, seed=S + group + D)
    want = np.asarray(j_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block=block, interpret=True,
        force=True))
    return q, k, v, want


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs thousands of tiny ops: one intra-op thread
    keeps them from spinning against the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_prefill_matches_jax_interpret_kernel(S, group, D):
    q, k, v, want = _jax_case(S, group, D)
    got = tfa.flash_causal_prefill(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def _masked_tile(t, r0, bk):
    """The kernel's rule: a consumer's 64 rows from r0 mask key tile t of
    bk keys only if the tile's last key lies past r0 (the tile crosses
    the diagonal)."""
    return (t + 1) * bk - 1 > r0


def emulate_kernel(q, k, v, *, bf16_p=False, walk=None):
    """csrc/flash_prefill.cu's algorithm in f32 on the CPU.

    Per (batch row, head) and BQ(D)-row block, the producer loads the
    BK(D)-key tiles up to the block's causal frontier (tiles past it are
    never read), and each consumer's 64 rows from r0 compute the tiles
    up to their own last row below S (`tiles_needed`), with O whole: the
    other tiles it only releases. So every score is computed once, and
    each loaded tile serves both consumers' rows. Per tile: raw scores,
    the q_pos >= k_pos mask only on a tile that crosses the diagonal, the
    row max taken on the raw scores, P = exp2(s * scale * log2(e) - m)
    and alpha in the log2 domain, P rounded to bf16 before P.V when
    `bf16_p`. Rows and keys past S read as zeros (TMA's fill); the rows
    past S are not written. Out = acc / max(l, 1e-30). `walk`, a list,
    gets (q0, r0, t) for each tile a consumer computes."""
    q, k, v = (torch.as_tensor(a).float() for a in (q, k, v))
    b, s, h, d = q.shape
    bq, bk = BQ(d), BK(d)
    g = h // k.shape[2]
    sl2 = d ** -0.5 * math.log2(math.e)
    n_qb = -(-s // bq)
    pad = n_qb * bq - s
    qh = torch.nn.functional.pad(q.permute(0, 2, 1, 3), (0, 0, 0, pad))
    kh, vh = (torch.nn.functional.pad(
        x.permute(0, 2, 1, 3).repeat_interleave(g, dim=1), (0, 0, 0, pad)) for x in (k, v))
    out = torch.zeros(b, h, s, d)
    for qb in range(n_qb):
        q0 = qb * bq
        for r0 in range(q0, q0 + bq, ROWS):
            m = torch.full((b, h, 64), NEG_INF)
            l = torch.zeros(b, h, 64)
            acc = torch.zeros(b, h, 64, d)
            for t in range(tiles_needed(r0, s, bk)):
                if walk is not None:
                    walk.append((q0, r0, t))
                keys = slice(t * bk, (t + 1) * bk)
                sc = qh[:, :, r0:r0 + 64] @ kh[:, :, keys].transpose(-1, -2)
                if _masked_tile(t, r0, bk):
                    q_pos = torch.arange(r0, r0 + 64)[:, None]
                    k_pos = torch.arange(t * bk, (t + 1) * bk)[None, :]
                    sc = torch.where(q_pos >= k_pos, sc, NEG_INF)
                m_new = torch.maximum(m, sc.amax(-1) * sl2)
                p = torch.exp2(sc * sl2 - m_new[..., None])
                alpha = torch.exp2(m - m_new)
                l = l * alpha + p.sum(-1)
                if bf16_p:
                    p = p.bfloat16().float()
                acc = acc * alpha[..., None] + p @ vh[:, :, keys]
                m = m_new
            rows = min(64, s - r0)
            if rows > 0:
                o = acc / torch.clamp(l, min=1e-30)[..., None]
                out[:, :, r0:r0 + rows] = o[:, :, :rows]
    return out.permute(0, 2, 1, 3)


def test_kernel_tiles_read_from_source():
    """A block is 64 rows per consumer warpgroup at every head_dim, each
    consumer's rows its own (r0 = q0 + 64 c) with O whole, and a consumer
    computes only the tiles its rows need; the key tile is whole k16
    steps of the P.V product, 128 keys at D 64 and 128 and 64 at 256,
    where the K/V ring of 128-key tiles would pass the 227 KB of shared
    memory a block may have; each build's Q, ring and barriers fit."""
    assert [BQ(d) for d in (64, 128, 256)] == [128, 128, 128]
    assert [BK(d) for d in (64, 128, 256)] == [128, 128, 64]
    assert "constexpr int kConsumers = 2;" in _SRC
    assert "const int r0 = q0 + 64 * c;" in _SRC
    assert "const int n_mine = r0 < S ? (min(r0 + 64, S) + BK - 1) / BK : 0;" in _SRC
    assert "kSplitD" not in _SRC
    # O whole: D / kPVN column groups of kPVN / 2 f32 a thread.
    assert "float o[D / PVN][PVN / 2];" in _SRC
    assert "constexpr int kPVN = D < 128 ? D : 128;" in _SRC
    # The consumers take turns issuing Q K^T at D = 256 only.
    assert "constexpr bool kPingPong = D == 256;" in _SRC
    bars = 8 * (1 + 3 * STAGES)
    smem = lambda d, bq, bk: 2 * d * (bq + STAGES * 2 * bk) + bars + 1024  # noqa: E731
    for d in (64, 128, 256):
        assert smem(d, BQ(d), BK(d)) <= 232448, d
    assert smem(256, BQ(256), BK(256)) == 197688
    assert smem(256, BQ(256), 128) > 232448
    # Every build the dispatch takes, and no other.
    assert re.findall(r"if \(D == (\d+)\) return launch<(\d+)>", _SRC) == [
        ("256", "256"), ("128", "128"), ("64", "64")]
    assert tfa.flash_causal_prefill.head_dims == (64, 128, 256)


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_kernel_emulation_matches_jax_interpret_kernel(S, group, D):
    q, k, v, want = _jax_case(S, group, D)
    got = emulate_kernel(q, k, v).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("S", [32, 200, 384])
@pytest.mark.parametrize("D", [128, 256])
def test_kernel_emulation_with_bf16_p_within_card_limit(S, D):
    """With P rounded to bf16, as the kernel feeds it to P.V, the
    emulation stays within the card's limit of the plain version, also for
    a ragged tail (32: less than one block; 200: a partial second block)
    and three blocks of tiles (384); at D = 256 in its 64-key tiles."""
    q, k, v = _mk(2, S, 8, 2, D, seed=S)
    want = causal_prefill_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    got = emulate_kernel(q, k, v, bf16_p=True)
    err = (got - want).abs()
    assert bool((err <= FLASH_TOL + FLASH_TOL * want.abs()).all()), float(err.max())
    # The rounding of P is visible, yet well inside the limit.
    assert 1e-4 < float(err.max()) < FLASH_TOL / 2


@pytest.mark.parametrize("D", [64, 256])
def test_kernel_emulation_never_reads_past_the_frontier(D):
    """The first block's rows read only the first BQ keys: K/V past them
    may hold anything (NaN here) without reaching those rows."""
    bq = BQ(D)
    S = 2 * bq
    q, k, v = _mk(1, S, 4, 2, D, seed=5)
    k[:, bq:], v[:, bq:] = np.nan, np.nan
    got = emulate_kernel(q, k, v)
    want = causal_prefill_attention(
        *(torch.from_numpy(x[:, :bq]).contiguous() for x in (q, k, v)))
    assert torch.isfinite(got[:, :bq]).all() and not torch.isfinite(got[:, bq:]).all()
    torch.testing.assert_close(got[:, :bq], want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("S", [32, 200, 1000])
@pytest.mark.parametrize("D", [128, 256])
def test_only_diagonal_tiles_need_the_mask(S, D):
    """For every consumer's rows and key tile the kernel computes, a tile
    it does not mask has no key past any of its valid rows, and a tile it
    masks has one: the mask is applied exactly where causality needs it.
    Every tile a consumer skips lies wholly past its valid rows, and the
    block loads no tile past its frontier."""
    bq, bk = BQ(D), BK(D)
    walked = 0
    for q0 in range(0, S, bq):
        n_kt = -(-min(q0 + bq, S) // bk)
        for r0 in range(q0, q0 + bq, ROWS):
            q_pos = torch.arange(r0, max(r0, min(r0 + ROWS, S)))[:, None]
            mine = tiles_needed(r0, S, bk)
            assert mine <= n_kt
            for t in range(n_kt):
                k_pos = torch.arange(t * bk, (t + 1) * bk)[None, :]
                if t < mine:
                    assert _masked_tile(t, r0, bk) == bool((k_pos > q_pos).any())
                    walked += 1
                else:
                    assert bool((k_pos > q_pos).all())
        # Tiles past the frontier hold no key at or before any row.
        assert n_kt * bk > min(q0 + bq, S) - 1 >= (n_kt - 1) * bk
    assert walked >= -(-S // 64)


@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("S", [160, 200])
def test_d256_second_consumer_with_few_or_no_rows(S, group):
    """At D = 256, S = 160 leaves the second block's second consumer (rows
    192-255) no row below S, and S = 200 eight: the first computes no
    tile and writes nothing, the second computes the block's every tile.
    Held against the JAX kernel in interpret mode (40-row blocks, which
    divide both S) and the plain version."""
    q, k, v, want = _jax_case(S, group, 256, block=40)
    walk = []
    got = emulate_kernel(q, k, v, walk=walk)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    plain = causal_prefill_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    torch.testing.assert_close(got, plain, atol=2e-5, rtol=2e-5)
    second = [t for q0, r0, t in walk if r0 == 192]
    assert second == ([] if S == 160 else [0, 1, 2, 3])
    # Consumer 0 of that block needs keys up to row 191: three of the
    # four tiles the block loads at S = 200.
    assert [t for q0, r0, t in walk if r0 == 128] == [0, 1, 2]


@pytest.mark.parametrize("S", [160, 1000, 8192])
def test_d256_scores_once_and_tiles_serve_128_rows(S):
    """At D = 256 every consumer computes each of its tiles once, and
    only tiles with a key at or before one of its rows below S; every
    tile the block loads serves its 128 rows. At Gemma-7B's heads, B=1,
    S=8192: 66,560 K/V tiles loaded (4.36 GB from L2, half of a 64-row
    block's 132,096) and 5.54e11 flops issued for the 5.50e11 the causal
    product needs (1.5x that before)."""
    bq, bk, d, heads = BQ(256), BK(256), 256, 16
    loads, computed = 0, set()
    for q0 in range(0, S, bq):
        loads += -(-min(q0 + bq, S) // bk)
        for r0 in range(q0, q0 + bq, ROWS):
            for t in range(tiles_needed(r0, S, bk)):
                assert (r0, t) not in computed
                assert t * bk <= min(r0 + ROWS, S) - 1
                computed.add((r0, t))
    # Every (rows, tile) pair causality needs is computed.
    need = {(r0, t) for r0 in range(0, S, ROWS) for t in range(-(-S // bk))
            if t * bk <= min(r0 + ROWS, S) - 1}
    assert computed == need
    if S <= 1000:
        q, k, v = _mk(1, S, 1, 1, d, seed=S)
        walk = []
        emulate_kernel(q, k, v, walk=walk)
        assert {(r0, t) for _, r0, t in walk} == computed and len(walk) == len(computed)
    if S == 8192:
        assert heads * loads == 66_560
        assert heads * loads * 2 * bk * d * 2 == pytest.approx(4.36e9, rel=1e-3)
        issued = heads * len(computed) * 2 * (2 * ROWS * bk * d)
        needed = 4.0 * heads * d * S * (S + 1) / 2
        assert issued == pytest.approx(5.54e11, rel=1e-3)
        assert issued / needed < 1.01


def _turns(c, n_kt):
    """Consumer c's named-barrier operations over a block of n_kt tiles,
    as the kernel issues them at D = 256: consumer 1 first hands consumer
    0 the turn; at every tile each waits for its turn (bar.sync on
    kTurnBar + c) and, once its Q K^T is issued, passes it on (bar.arrive
    on kTurnBar + 1 - c), but for consumer 1's last tile."""
    ops = [("arrive", 0)] if c == 1 else []
    for t in range(n_kt):
        ops.append(("sync", c))
        if c == 0 or t + 1 < n_kt:
            ops.append(("arrive", 1 - c))
    return ops


@pytest.mark.parametrize("n_kt", [1, 2, 3, 8])
def test_ping_pong_turns_never_deadlock(n_kt):
    """The turn protocol on two 256-thread named barriers, run as the
    hardware counts them (a generation completes once 256 threads have
    arrived or synced; bar.sync blocks until it does) under many random
    interleavings of the two consumers: both finish, every generation of
    barrier c holds consumer c's bar.sync (two arrivals never complete one
    alone), and the Q K^T turns alternate 0, 1, 0, 1, ..."""
    assert 'asm volatile("bar.sync %0, 256;" ::"r"(kTurnBar + c)' in _SRC
    assert "if (kPingPong<D> && (c == 0 || t + 1 < n_kt))" in _SRC
    assert "if (kPingPong<D> && c == 1)" in _SRC
    rng = np.random.default_rng(n_kt)
    for _ in range(200):
        ops = [_turns(0, n_kt), _turns(1, n_kt)]
        pc, waiting = [0, 0], [None, None]
        count, synced, gen = [0, 0], [False, False], [0, 0]
        turns = []
        while pc[0] < len(ops[0]) or pc[1] < len(ops[1]):
            ready = [c for c in (0, 1) if pc[c] < len(ops[c]) and waiting[c] is None]
            assert ready, "deadlock"
            c = int(rng.choice(ready))
            op, bar = ops[c][pc[c]]
            count[bar] += 128
            if op == "sync":
                synced[bar] = True
                waiting[c] = (bar, gen[bar])
            if count[bar] == 256:
                assert synced[bar], "two arrivals completed a generation"
                turns.append(bar)  # only consumer `bar` syncs on barrier `bar`
                count[bar], synced[bar] = 0, False
                gen[bar] += 1
                waiting = [None if w == (bar, gen[bar] - 1) else w for w in waiting]
            pc[c] += 1
        assert count == [0, 0] and waiting == [None, None]
        assert gen == [n_kt, n_kt]
        assert turns == [0, 1] * n_kt


def test_flash_wrapper_reads_no_device_value():
    """The wrapper passes shapes and pointers only (the kernel builds its
    TMA maps on the host from them): it never copies a tensor to the
    host, so a CUDA graph can hold it; its output comes from torch.empty;
    a CUDA tensor never takes the plain version."""
    src = inspect.getsource(tfa.flash_causal_prefill)
    cuda_path = src.split('if q.device.type != "cuda"', 1)[1]
    for reader in (".item(", ".tolist(", ".cpu(", ".numpy(", "int(q[", "float(q["):
        assert reader not in cuda_path
    assert "torch.empty" in cuda_path
    assert "causal_prefill_attention" not in cuda_path
    assert "kubeai_flash_prefill_bf16" in cuda_path


@pytest.mark.parametrize("S", [100, 200])
def test_ragged_length_matches_causal_reference(S):
    """S not a multiple of 128: the TPU kernel refuses it, the port's
    kernel takes it; both are held to causal_prefill_attention."""
    q, k, v = _mk(2, S, 4, 2, 64, seed=S)
    want = np.asarray(j_causal(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    tfa.flash_causal_prefill.launches = 0
    got = tfa.flash_causal_prefill(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    assert tfa.flash_causal_prefill.launches == 0  # CPU: plain version
