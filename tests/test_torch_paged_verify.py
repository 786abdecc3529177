"""The port's speculative-verify attention (kernel B3's wrapper and plain
version) against kubeai_tpu's: the plain version against the JAX Pallas
kernel in interpret mode and against its reference, over ragged
positions, softcap, a sliding window and a window that reaches past the
block table. Tolerance atol/rtol 1e-4 in f32, the JAX verify test's own
(online vs one-shot softmax). Then B3's algorithm (split page walk,
64-token tiles, P in two bf16 parts, fixed-order combine) emulated on the
CPU against the same JAX kernel."""

import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.ops import paged_attention as jpa
from kubeai_tpu_torch.ops import paged_attention as tpa

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs thousands of tiny ops: one intra-op thread
    keeps them from spinning against the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, KVH, G, D, PAGE, MP = 3, 2, 4, 32, 8, 4
H = KVH * G
P = 1 + B * MP
K = 3  # window tokens: the last emitted token and 2 proposals


def _setup(positions, seed):
    """Pools with each slot's pages shuffled over the pool, covering its
    window (positions + K, bounded by the block table); q [B, K, H, D]."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, K, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, PAGE, KVH, D)).astype(np.float32)
    vp = rng.standard_normal((P, PAGE, KVH, D)).astype(np.float32)
    perm = rng.permutation(np.arange(1, P))
    bt = np.full((B, MP), -1, np.int32)
    used = 0
    for s, pos in enumerate(positions):
        need = min(-(-(pos + K) // PAGE), MP)
        bt[s, :need] = perm[used:used + need]
        used += need
    return q, kp, vp, bt, np.asarray(positions, np.int32)


def _three(q, kp, vp, bt, positions, **kw):
    """(port plain, JAX interpret kernel, JAX reference)."""
    args = [jnp.asarray(a) for a in (q, kp, vp, bt, positions)]
    j_kernel = np.asarray(jpa.paged_verify_attention(
        *args, use_pallas=True, interpret=True, **kw))
    j_ref = np.asarray(jpa.ref_paged_verify_attention(*args, **kw))
    got = tpa.paged_verify_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, bt, positions)), **kw).numpy()
    return got, j_kernel, j_ref


# The last case puts slot 2's window past the block table (positions 30,
# 31, 32 with MP * PAGE = 32): the keys there do not exist.
@pytest.mark.parametrize("positions", [[5, 17, 28], [0, 8, 13], [7, 2, 30]])
@pytest.mark.parametrize("cap,win", [(None, None), (40.0, None), (None, 9), (25.0, 6)])
def test_plain_matches_jax_kernel_and_reference(positions, cap, win):
    got, j_kernel, j_ref = _three(
        *_setup(positions, seed=sum(positions)), logit_softcap=cap, window=win)
    assert got.shape == (B, K, H, D)
    np.testing.assert_allclose(got, j_kernel, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, j_ref, atol=1e-4, rtol=1e-4)


def test_window_changes_the_result():
    q, kp, vp, bt, pos = (torch.from_numpy(a) for a in _setup([5, 17, 28], seed=2))
    full = tpa.ref_paged_verify_attention(q, kp, vp, bt, pos)
    win = tpa.ref_paged_verify_attention(q, kp, vp, bt, pos, window=6)
    # Slot 0's row 0 at position 5 sees 6 keys either way; slot 2's do not.
    assert torch.allclose(full[0, 0], win[0, 0], atol=1e-6)
    assert (full[2] - win[2]).abs().max() > 1e-3


def test_row0_matches_decode():
    """Row 0 of the window is the token vanilla decode would attend with
    (positions = lengths - 1); it must equal decode attention."""
    rng = np.random.default_rng(16)
    q, kp, vp, bt, _ = (torch.from_numpy(a) for a in _setup([6, 14, 27], seed=15))
    lengths = torch.tensor([6, 14, 27], dtype=torch.int32)
    qk = torch.from_numpy(rng.standard_normal((B, 2, H, D)).astype(np.float32))
    ver = tpa.paged_verify_attention(qk, kp, vp, bt, lengths - 1)
    dec = tpa.paged_decode_attention(qk[:, 0].contiguous(), kp, vp, bt, lengths)
    np.testing.assert_allclose(ver[:, 0].numpy(), dec.numpy(), atol=1e-5)


def test_cpu_tensors_take_the_plain_version_without_launching():
    tpa.paged_verify_attention.launches = 0
    args = [torch.from_numpy(a) for a in _setup([4, 4, 4], seed=1)]
    got = tpa.paged_verify_attention(*args, logit_softcap=30.0)
    assert torch.equal(got, tpa.ref_paged_verify_attention(*args, logit_softcap=30.0))
    assert tpa.paged_verify_attention.launches == 0


def _bf16_args(k=K, h=H, d=64):
    q = torch.zeros(B, k, h, d, dtype=torch.bfloat16)
    pool = torch.zeros(P, PAGE, KVH, d, dtype=torch.bfloat16)
    return q, pool, pool, torch.zeros(B, MP, dtype=torch.int32), torch.zeros(B, dtype=torch.int32)


def test_kernel_argument_checks():
    tpa._check_verify_args(*_bf16_args(), window=None)  # what the kernel takes
    with pytest.raises(ValueError, match="rows"):  # 9 tokens x group 8 = 72 > 64
        tpa._check_verify_args(*_bf16_args(k=9, h=8 * KVH), window=None)
    with pytest.raises(ValueError, match="head_dim"):
        tpa._check_verify_args(*_bf16_args(d=32), window=None)
    q, kp, vp, bt, pos = _bf16_args()
    with pytest.raises(TypeError, match="bf16 q"):
        tpa._check_verify_args(q.float(), kp, vp, bt, pos, window=None)
    with pytest.raises(TypeError, match="int32 positions"):
        tpa._check_verify_args(q, kp, vp, bt, pos.long(), window=None)
    with pytest.raises(ValueError, match="contiguous q"):
        tpa._check_verify_args(q.transpose(1, 2), kp, vp, bt, pos, window=None)
    with pytest.raises(ValueError, match="do not match batch"):
        tpa._check_verify_args(q, kp, vp, bt[:2], pos, window=None)
    with pytest.raises(TypeError, match="Python int"):
        tpa._check_verify_args(q, kp, vp, bt, pos, window=torch.tensor(4))


# ---- the kernel's split page walk, emulated on the CPU ------------------------

_SRC = (Path(tpa.__file__).resolve().parent.parent / "csrc" / "paged_verify.cu").read_text()
# The kernel's tokens per tile, shared by its warps, read from its source.
_TILE = int(re.search(r"constexpr int kTile = (\d+);", _SRC).group(1))


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _p_for_pv(pr, p_parts):
    """P as the P.V product sees it: the kernel's two bf16 parts, bf16
    alone, or f32."""
    if p_parts == "f32":
        return pr
    hi = _bf16(pr)
    return hi if p_parts == "hi" else hi + _bf16(pr - hi)


def _emulate_kernel(arrays, pages_per_split, *, cap=None, win=None, p_parts="hi+lo"):
    """B3's algorithm in f32: split s of a slot walks the keys of its
    block-table entries [s * pps, (s + 1) * pps) from query 0's window edge
    to the last window token (inside the table) in _TILE-token tiles, with
    one online softmax per split (its warps share each tile), a causal and
    a window edge per row, scores scaled after the product and P to the
    P.V product as p_parts says; the partials merge in split order, a
    split where a row keeps no key adds nothing to it, and a row masked in
    every split writes 0."""
    q, kp, vp, bt, pos = (torch.from_numpy(a) for a in arrays)
    bt, pos = bt.long(), pos.long()
    b, kq, h, d = q.shape
    kvh, page, mp = kp.shape[2], kp.shape[1], bt.shape[1]
    g = h // kvh
    rows = kq * g
    num_splits = -(-mp // pages_per_split)
    out = torch.empty(b, kq, h, d)
    for s in range(b):
        p = int(pos[s])
        lo = max(p + 1 - win, 0) if win else 0
        q_abs = p + torch.arange(rows) // g  # row r: window token r // g
        for kh in range(kvh):
            qr = q[s, :, kh * g:(kh + 1) * g].reshape(rows, d)
            parts = []
            for split in range(num_splits):
                m = torch.full((rows,), tpa.NEG_INF)
                l = torch.zeros(rows)
                acc = torch.zeros(rows, d)
                t_lo = max(split * pages_per_split * page, lo)
                t_hi = min((split + 1) * pages_per_split * page, p + kq, mp * page)
                for t0 in range(t_lo, t_hi, _TILE):
                    toks = torch.arange(t0, min(t0 + _TILE, t_hi))
                    pages = bt[s, toks // page].clamp(min=0)
                    k = kp[pages, toks % page, kh]
                    v = vp[pages, toks % page, kh]
                    sc = (qr @ k.T) * d ** -0.5
                    if cap is not None:
                        sc = torch.tanh(sc / cap) * cap
                    valid = toks[None, :] <= q_abs[:, None]
                    if win:
                        valid &= toks[None, :] > q_abs[:, None] - win
                    sc = torch.where(valid, sc, tpa.NEG_INF)
                    m_new = torch.maximum(m, sc.max(-1).values)
                    pr = torch.where(valid, torch.exp(sc - m_new[:, None]), 0.0)
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + pr.sum(-1)
                    acc = acc * alpha[:, None] + _p_for_pv(pr, p_parts) @ v
                    m = m_new
                parts.append((m, l, acc))
            mx = torch.full((rows,), tpa.NEG_INF)
            for m, l, _ in parts:
                mx = torch.where(l > 0, torch.maximum(mx, m), mx)
            ll = torch.zeros(rows)
            aa = torch.zeros(rows, d)
            for m, l, a in parts:
                w = torch.where(l > 0, torch.exp(m - mx), 0.0)
                ll = ll + l * w
                aa = aa + a * w[:, None]
            o = aa / ll.clamp(min=1e-30)[:, None]
            out[s, :, kh * g:(kh + 1) * g] = o.reshape(kq, g, d)
    return out.numpy()


def _jax_kernel(arrays, **kw):
    return np.asarray(jpa.paged_verify_attention(
        *(jnp.asarray(a) for a in arrays), use_pallas=True, interpret=True, **kw))


def _edge_positions(pages_per_split):
    """Slot 0's window crosses a split boundary after its row 0, slot 1's
    before its last row; slot 2's runs past the 4-page block table."""
    e = pages_per_split * PAGE
    return [e - 1, e - K + 1, MP * PAGE - 2]


@pytest.mark.parametrize("pages_per_split", [1, 2, 3])
@pytest.mark.parametrize("cap,win", [(None, None), (30.0, None), (None, 5), (25.0, 9)])
def test_split_walk_matches_jax_kernel(pages_per_split, cap, win):
    """The split-and-combine algorithm, with P in f32 and in the kernel's
    two bf16 parts, against the JAX Pallas kernel in interpret mode; window
    5 masks every split below the last live one."""
    arrays = _setup(_edge_positions(pages_per_split), seed=31 + pages_per_split)
    want = _jax_kernel(arrays, logit_softcap=cap, window=win)
    for p_parts in ("f32", "hi+lo"):
        got = _emulate_kernel(arrays, pages_per_split, cap=cap, win=win, p_parts=p_parts)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4, err_msg=p_parts)


def test_split_walk_with_p_in_bf16_is_within_the_chip_limits():
    """P rounded to bf16 alone moves the output by up to 2^-8 of each
    weight: held at the card's limits (atol 2e-3, rtol 1e-2), not at 1e-4,
    which the kernel's two-part P meets above."""
    arrays = _setup([5, 17, 28], seed=37)
    want = _jax_kernel(arrays)
    got = _emulate_kernel(arrays, 1, p_parts="hi")
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-2)
    assert np.abs(got - want).max() > 1e-6  # the rounding is really there


def test_split_walk_writes_zero_for_a_row_masked_everywhere():
    """Window 1 past the block table: slot 2's last row (position 32) has
    no key in any split and writes 0, as the JAX kernel's zero_masked_p."""
    arrays = _setup([5, 17, 30], seed=41)
    want = _jax_kernel(arrays, window=1)
    got = _emulate_kernel(arrays, 2, win=1)
    assert np.all(want[2, 2] == 0) and np.all(got[2, 2] == 0)
    assert np.abs(got[2, :2]).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_verify_wrapper_reads_no_device_value():
    """The split comes from shapes: the wrapper never copies a tensor to
    the host, so it does not wait for the card and a CUDA graph can hold
    it; its scratch comes from torch.empty."""
    src = inspect.getsource(tpa.paged_verify_attention)
    cuda_path = src.split('if q.device.type != "cuda"', 1)[1]
    for reader in (".item(", ".tolist(", ".cpu(", ".numpy(", "int(positions", "positions.max"):
        assert reader not in cuda_path
    assert "fused_split(b, kvh, mp, page)" in cuda_path
    assert "torch.empty(" in cuda_path
    assert "ref_paged_verify_attention" not in cuda_path  # no fallback on the card


def _setup_long(positions, seed, kq=5, kvh=2, g=4, d=32, page=16, mp=24):
    """Two slots over several of the kernel's tiles (384 tokens), a
    gamma = 4 window (K = 5) and 20 rows per kv head, as at the 8B shapes."""
    rng = np.random.default_rng(seed)
    b, n_pages = len(positions), 1 + len(positions) * mp
    q = rng.standard_normal((b, kq, kvh * g, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages, page, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, kvh, d)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.full((b, mp), -1, np.int32)
    for s, pos in enumerate(positions):
        need = min(-(-(pos + kq) // page), mp)
        bt[s, :need] = perm[s * mp:s * mp + need]
    return q, kp, vp, bt, np.asarray(positions, np.int32)


@pytest.mark.parametrize("pages_per_split", [5, 24])
@pytest.mark.parametrize("cap,win", [(None, None), (None, 100)])
def test_split_walk_over_many_tiles_matches_jax_kernel(pages_per_split, cap, win):
    """Splits of 80 and 384 tokens walk two and six tiles with one online
    softmax: the rescale between tiles, against the JAX kernel."""
    arrays = _setup_long([300, 61], seed=43)
    assert (300 + 5) // _TILE >= 4  # several tiles in slot 0
    want = _jax_kernel(arrays, logit_softcap=cap, window=win)
    got = _emulate_kernel(arrays, pages_per_split, cap=cap, win=win)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
