"""kubeai_tpu_torch.ops.paged_attention against kubeai_tpu's: the port's
plain paged decode attention and the CPU emulation of kernel B1's split
page walk against the JAX Pallas kernel (interpret mode) and its
reference, and the page scatter/coordinate helpers bit for bit. Kernel
tolerance atol/rtol 1e-4, the JAX kernel test's own (f32, online vs
one-shot softmax)."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.ops import paged_attention as jpa
from kubeai_tpu_torch.ops import paged_attention as tpa
from torch_split_walk import emulate_split_walk

B, KVH, G, D, PAGE, MP = 3, 2, 4, 32, 8, 4
H = KVH * G
P = 1 + B * MP


def _setup(lengths, seed=0):
    """Pools with each slot's tokens on shuffled pages; -1 past its
    pages. A slot longer than the table holds all MP of its entries."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, PAGE, KVH, D)).astype(np.float32)
    vp = rng.standard_normal((P, PAGE, KVH, D)).astype(np.float32)
    perm = rng.permutation(np.arange(1, P))
    bt = np.full((B, MP), -1, np.int32)
    used = 0
    for s, ln in enumerate(lengths):
        need = min(-(-ln // PAGE), MP)
        bt[s, :need] = perm[used:used + need]
        used += need
    return q, kp, vp, bt, np.asarray(lengths, np.int32)


def _both(q, kp, vp, bt, lengths, **kw):
    j_ref = np.asarray(jpa.ref_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lengths), **kw))
    j_kernel = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lengths), use_pallas=True, interpret=True, **kw))
    got = tpa.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt), torch.from_numpy(lengths), **kw).numpy()
    return got, j_kernel, j_ref


@pytest.mark.parametrize("lengths", [[5, 17, 32], [1, 8, 9], [32, 32, 31]])
def test_plain_matches_jax_kernel_and_reference(lengths):
    got, j_kernel, j_ref = _both(*_setup(lengths, seed=sum(lengths)))
    np.testing.assert_allclose(got, j_kernel, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, j_ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("cap,win", [(30.0, None), (None, 12), (50.0, 7)])
def test_softcap_and_window_match_jax(cap, win):
    got, j_kernel, j_ref = _both(
        *_setup([9, 26, 31], seed=3), logit_softcap=cap, window=win)
    np.testing.assert_allclose(got, j_kernel, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, j_ref, atol=1e-4, rtol=1e-4)


def test_cpu_tensors_take_the_plain_version_without_launching():
    tpa.paged_decode_attention.launches = 0
    q, kp, vp, bt, lengths = (torch.from_numpy(a) for a in _setup([4, 4, 4]))
    got = tpa.paged_decode_attention(q, kp, vp, bt, lengths)
    want = tpa.ref_paged_decode_attention(q, kp, vp, bt, lengths)
    assert torch.equal(got, want)
    assert tpa.paged_decode_attention.launches == 0


# ---- kernel B1's split page walk, emulated on the CPU -------------------------


def _jax_kernel(arrays, **kw):
    return np.asarray(jpa.paged_decode_attention(
        *(jnp.asarray(a) for a in arrays), use_pallas=True, interpret=True, **kw))


def _walk_lengths(pages_per_split, case):
    """Lengths (the new token included) at a split boundary and one either
    side; 0, 1 and past two splits; and past the 4-page block table."""
    e, L = pages_per_split * PAGE, MP * PAGE
    return {"boundary": [e, e - 1, e + 1], "short": [0, 1, min(2 * e + 1, L)],
            "past": [L + 3, L + 2 * PAGE + 1, e]}[case]


@pytest.mark.parametrize("pages_per_split", [1, 2, 3])
@pytest.mark.parametrize("case,cap,win", [
    ("boundary", None, None), ("short", None, None), ("boundary", 30.0, None),
    ("short", None, 5), ("past", None, None), ("past", 50.0, 12),
])
def test_split_walk_matches_jax_kernel(pages_per_split, case, cap, win):
    """B1's split-and-combine algorithm against the JAX Pallas kernel in
    interpret mode. Window 5 masks every split but the last live one. Past
    the table only the table's keys count, and with window 12 the slot at
    L + 17 keeps none and is 0, as in the JAX kernel."""
    arrays = _setup(_walk_lengths(pages_per_split, case), seed=29 + pages_per_split)
    got = emulate_split_walk(*arrays, pages_per_split, cap=cap, win=win)
    want = _jax_kernel(arrays, logit_softcap=cap, window=win)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_split_walk_writes_zero_where_no_key_is_kept():
    """Length 0, and a window wholly past the table: the output is 0
    exactly, as the JAX kernel's (its reference averages every column)."""
    arrays = _setup([0, 9, MP * PAGE + 20], seed=31)
    got = emulate_split_walk(*arrays, 1, win=2)
    want = _jax_kernel(arrays, window=2)
    assert not got[0].any() and not got[2].any()
    assert got[1].any()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_decode_wrapper_reads_no_device_value():
    """B1's split comes from shapes: the wrapper never copies a tensor to
    the host, so it does not wait for the card and a CUDA graph can hold
    it."""
    src = inspect.getsource(tpa.paged_decode_attention)
    cuda_path = src.split('if q.device.type != "cuda"', 1)[1]
    for reader in (".item(", ".tolist(", ".cpu(", ".numpy(", "int(lengths", "lengths.max"):
        assert reader not in cuda_path
    assert "fused_split(b, kvh, mp, page)" in cuda_path
    assert "torch.empty(" in cuda_path


def test_resolve_decode_kernel(monkeypatch):
    monkeypatch.delenv(tpa.DECODE_KERNEL_ENV, raising=False)
    assert tpa.DECODE_KERNEL_ENV == jpa.DECODE_KERNEL_ENV
    for requested in (None, "", "per_layer", "fused"):
        assert tpa.resolve_decode_kernel(requested) == jpa.resolve_decode_kernel(requested)
    assert tpa.resolve_decode_kernel(None) == "per_layer"
    assert tpa.resolve_decode_kernel("fused") == "fused"
    with pytest.raises(ValueError):
        tpa.resolve_decode_kernel("bogus")
    # An explicit layout wins over the env var.
    monkeypatch.setenv(tpa.DECODE_KERNEL_ENV, "fused")
    assert tpa.resolve_decode_kernel("per_layer") == "per_layer"
    assert tpa.resolve_decode_kernel(None) == "fused"


def test_token_page_coords_bit_equal_including_past_the_table():
    bt = np.array([[3, 5, -1, -1], [7, -1, -1, -1], [-1, -1, -1, -1]], np.int32)
    # Slot 0 in its second page; slot 1 past its pages (-1 entry); slot 2
    # past the whole table (position >= MP * PAGE).
    positions = np.array([9, 12, MP * PAGE + 3], np.int32)
    j_ids, j_offs = jpa.token_page_coords(jnp.asarray(bt), jnp.asarray(positions), PAGE)
    t_ids, t_offs = tpa.token_page_coords(
        torch.from_numpy(bt), torch.from_numpy(positions), PAGE)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(t_offs.numpy(), np.asarray(j_offs))
    assert t_ids.tolist() == [5, 0, 0]


def test_scatter_decode_token_bit_equal():
    rng = np.random.default_rng(5)
    kp = rng.standard_normal((P, PAGE, KVH, D)).astype(np.float32)
    vp = rng.standard_normal((P, PAGE, KVH, D)).astype(np.float32)
    kn = rng.standard_normal((B, KVH, D)).astype(np.float32)
    vn = rng.standard_normal((B, KVH, D)).astype(np.float32)
    ids = np.array([4, 9, 2], np.int64)
    offs = np.array([0, 7, 3], np.int64)
    jk, jv = jpa.scatter_decode_token(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(ids), jnp.asarray(offs))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    out = tpa.scatter_decode_token(
        tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
        torch.from_numpy(ids), torch.from_numpy(offs))
    assert out[0] is tk and out[1] is tv  # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_batched_scatter_sequence_bit_equal_with_padding_rows():
    """Admission scatter: padded tails and a padding row (bt_row -1) write
    only scratch page 0; every real page matches JAX bit for bit."""
    rng = np.random.default_rng(6)
    NL, A, S = 2, 4, 24
    kp = np.zeros((NL, P, PAGE, KVH, D), np.float32)
    vp = np.zeros((NL, P, PAGE, KVH, D), np.float32)
    bt_rows = np.full((A, MP), -1, np.int32)
    bt_rows[0, :3] = [4, 2, 9]
    bt_rows[1, :1] = [5]
    bt_rows[2, :3] = [1, 12, 7]  # row 3 stays all -1: a padding row
    lengths = np.array([20, 3, 24, 1], np.int32)
    ks = rng.standard_normal((NL, A, S, KVH, D)).astype(np.float32)
    vs = rng.standard_normal((NL, A, S, KVH, D)).astype(np.float32)
    j_ids, j_offs = jpa.batched_sequence_page_coords(
        jnp.asarray(bt_rows), jnp.asarray(lengths), S, PAGE)
    t_ids, t_offs = tpa.batched_sequence_page_coords(
        torch.from_numpy(bt_rows), torch.from_numpy(lengths), S, PAGE)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(t_offs.numpy(), np.asarray(j_offs))
    assert (t_ids[3] == 0).all() and (t_ids[1, 3:] == 0).all()
    jk, jv = jpa.batched_scatter_sequence(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(ks), jnp.asarray(vs),
        j_ids, j_offs)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tpa.batched_scatter_sequence(
        tk, tv, torch.from_numpy(ks), torch.from_numpy(vs), t_ids, t_offs)
    # Page 0 is scratch: which duplicate write lands there is unspecified.
    np.testing.assert_array_equal(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:])
    np.testing.assert_array_equal(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:])
    untouched = [p for p in range(1, P) if p not in (4, 2, 9, 5, 1, 12, 7)]
    assert not tk.numpy()[:, untouched].any()


def test_page_allocator_and_block_table_match_jax():
    """The copied host allocator hands out the same pages as the JAX one
    through growth, release, exhaustion and rollback; set_block_table
    writes the same row."""
    from kubeai_tpu.engine import paged_cache as jpc
    from kubeai_tpu_torch.engine import paged_cache as tpc

    ja = jpc.PageAllocator(P, PAGE, max_pages_per_slot=MP)
    ta = tpc.PageAllocator(P, PAGE, max_pages_per_slot=MP)
    script = [("ensure", 0, 9), ("ensure", 1, 30), ("ensure", 0, 17),
              ("release", 1, 0), ("ensure", 2, 32), ("ensure", 1, 32),
              ("ensure", 0, 40), ("release", 2, 0), ("ensure", 1, 5)]
    for op, slot, n in script:
        outs = []
        for a, mod in ((ja, jpc), (ta, tpc)):
            try:
                outs.append(a.ensure(slot, n) if op == "ensure" else a.release(slot))
            except (mod.OutOfPages, mod.SequenceTooLong) as e:
                outs.append(type(e).__name__)
        assert outs[0] == outs[1], (op, slot, n, outs)
        assert ja.free_pages == ta.free_pages
    jbt = jpc.set_block_table(jnp.full((B, MP), -1, jnp.int32), 1, [4, 2])
    tbt = tpc.set_block_table(torch.full((B, MP), -1, dtype=torch.int32), 1, [4, 2])
    np.testing.assert_array_equal(tbt.numpy(), np.asarray(jbt))
