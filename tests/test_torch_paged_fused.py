"""The port's fused paged decode attention over the stacked pool (kernel
B4's wrapper and plain version) against kubeai_tpu's: the plain version
against the JAX Pallas kernel in interpret mode and its reference at
atol/rtol 1e-4 in f32 (the JAX fused test's own), against the port's
scatter-then-attend at 1e-5 (the same sums in another order), and an
empty slot returning its new token's value."""

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
NL = 3


def _setup(old_lengths, seed):
    """Stacked [NL, ...] pools holding each slot's old tokens on shuffled
    pages (room for the new one), and a new token's K/V not yet in them."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((NL, P, PAGE, KVH, D)).astype(np.float32)
    vp = rng.standard_normal((NL, P, PAGE, KVH, D)).astype(np.float32)
    perm = rng.permutation(np.arange(1, P))
    bt = np.full((B, MP), -1, np.int32)
    used = 0
    for s, ln in enumerate(old_lengths):
        need = -(-(ln + 1) // PAGE)
        bt[s, :need] = perm[used:used + need]
        used += need
    kn = rng.standard_normal((B, KVH, D)).astype(np.float32)
    vn = rng.standard_normal((B, KVH, D)).astype(np.float32)
    return q, kp, vp, kn, vn, bt, np.asarray(old_lengths, np.int32)


def _port(arrays, layer, **kw):
    return tpa.paged_decode_attention_fused(
        *(torch.from_numpy(a) for a in arrays), layer, **kw).numpy()


@pytest.mark.parametrize("layer", [0, 2])
@pytest.mark.parametrize("old", [[5, 17, 30], [0, 8, 3]])
def test_plain_matches_jax_kernel(old, layer):
    arrays = _setup(old, seed=11 + layer)
    got = _port(arrays, layer)
    j_kernel = np.asarray(jpa.paged_decode_attention_fused(
        *(jnp.asarray(a) for a in arrays), layer, use_pallas=True, interpret=True))
    np.testing.assert_allclose(got, j_kernel, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("cap,win", [(30.0, None), (None, 12), (50.0, 7), (None, 1)])
def test_softcap_and_window_match_jax_reference(cap, win):
    arrays = _setup([9, 26, 31], seed=13)
    got = _port(arrays, 1, logit_softcap=cap, window=win)
    want = np.asarray(jpa.ref_paged_decode_attention_fused(
        *(jnp.asarray(a) for a in arrays), jnp.int32(1),
        logit_softcap=cap, window=win))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("cap,win", [(None, None), (30.0, None), (None, 12), (50.0, 7)])
def test_plain_matches_scatter_then_attend(cap, win):
    """Pool read-only plus the new-token column equals writing the token
    first and attending with lengths = positions + 1, in every layer."""
    q, kp, vp, kn, vn, bt, pos = (torch.from_numpy(a) for a in _setup([5, 17, 30], seed=7))
    ids, offs = tpa.token_page_coords(bt, pos, PAGE)
    for layer in range(NL):
        fused = tpa.paged_decode_attention_fused(
            q, kp, vp, kn, vn, bt, pos, layer, logit_softcap=cap, window=win)
        kl, vl = tpa.scatter_decode_token(kp[layer].clone(), vp[layer].clone(), kn, vn, ids, offs)
        want = tpa.paged_decode_attention(
            q, kl, vl, bt, pos + 1, logit_softcap=cap, window=win)
        np.testing.assert_allclose(fused.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_empty_slot_returns_value_of_new_token():
    arrays = _setup([0, 8, 3], seed=17)
    out = _port(arrays, 0)
    vn = arrays[4]
    want0 = np.broadcast_to(vn[0][:, None, :], (KVH, G, D)).reshape(H, D)
    np.testing.assert_allclose(out[0], want0, atol=1e-5)
    j_ref = np.asarray(jpa.ref_paged_decode_attention_fused(
        *(jnp.asarray(a) for a in arrays), jnp.int32(0)))
    np.testing.assert_allclose(out, j_ref, atol=1e-4, rtol=1e-4)


def test_cpu_tensors_take_the_plain_version_without_launching():
    tpa.paged_decode_attention_fused.launches = 0
    args = [torch.from_numpy(a) for a in _setup([4, 4, 4], seed=1)]
    got = tpa.paged_decode_attention_fused(*args, 2, window=3)
    assert torch.equal(got, tpa.ref_paged_decode_attention_fused(*args, 2, window=3))
    assert tpa.paged_decode_attention_fused.launches == 0


def _bf16_args(h=H, d=64):
    q = torch.zeros(B, h, d, dtype=torch.bfloat16)
    pool = torch.zeros(NL, P, PAGE, KVH, d, dtype=torch.bfloat16)
    new = torch.zeros(B, KVH, d, dtype=torch.bfloat16)
    return (q, pool, pool, new, new, torch.zeros(B, MP, dtype=torch.int32),
            torch.zeros(B, dtype=torch.int32))


def test_kernel_argument_checks():
    tpa._check_fused_args(*_bf16_args(), 2, None)  # what the kernel takes
    for layer in (-1, NL, 1.0):
        with pytest.raises(ValueError, match="layer"):
            tpa._check_fused_args(*_bf16_args(), layer, None)
    with pytest.raises(ValueError, match="group"):
        tpa._check_fused_args(*_bf16_args(h=9 * KVH), 0, None)
    q, kp, vp, kn, vn, bt, pos = _bf16_args()
    with pytest.raises(ValueError, match="k_new"):
        tpa._check_fused_args(q, kp, vp, kn[:, :1], vn, bt, pos, 0, None)
    with pytest.raises(ValueError, match="NL, P, page"):
        tpa._check_fused_args(q, kp[0], vp[0], kn, vn, bt, pos, 0, None)
    with pytest.raises(TypeError, match="bf16 v_new"):
        tpa._check_fused_args(q, kp, vp, kn, vn.float(), bt, pos, 0, None)


# ---- the kernel's split page walk, emulated on the CPU ------------------------

def _emulate_kernel(arrays, layer, pages_per_split, *, cap=None, win=None):
    """The kernel's algorithm in f32 (tests/torch_split_walk.py) on one
    layer of the stacked pool, with the new token's column merged last."""
    q, kp, vp, kn, vn, bt, pos = arrays
    return emulate_split_walk(q, kp[layer], vp[layer], bt, pos, pages_per_split,
                              new=(kn, vn), cap=cap, win=win)


def _edge_lengths(pages_per_split, case):
    """Old lengths at a split boundary, one either side, 0 and 1; all fit
    the 4-page block table with room for the new token."""
    e = pages_per_split * PAGE
    return {"boundary": [e, e - 1, e + 1], "short": [0, 1, min(2 * e + 1, MP * PAGE - 1)]}[case]


@pytest.mark.parametrize("pages_per_split", [1, 2, 3])
@pytest.mark.parametrize("case,cap,win", [
    ("boundary", None, None), ("short", None, None),
    ("boundary", 30.0, None), ("short", None, 5),
])
def test_split_walk_matches_jax_kernel(pages_per_split, case, cap, win):
    """The split-and-combine algorithm against the JAX Pallas kernel in
    interpret mode; window 5 masks every split but the last live one."""
    arrays = _setup(_edge_lengths(pages_per_split, case), seed=19 + pages_per_split)
    got = _emulate_kernel(arrays, 1, pages_per_split, cap=cap, win=win)
    want = np.asarray(jpa.paged_decode_attention_fused(
        *(jnp.asarray(a) for a in arrays), 1, logit_softcap=cap, window=win,
        use_pallas=True, interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_split_walk_keeps_an_empty_slot_exact():
    """At old length 0 every split is empty: the output is v_new exactly."""
    arrays = _setup([0, 0, 5], seed=23)
    got = _emulate_kernel(arrays, 2, 1)
    vn = arrays[4]
    for s in (0, 1):
        want = np.broadcast_to(vn[s][:, None, :], (KVH, G, D)).reshape(H, D)
        np.testing.assert_array_equal(got[s], want)


@pytest.mark.parametrize("batch,kv_heads,max_pages,page", [
    (8, 8, 32, 64),     # the 8B serving shape: 8 splits of 4 pages
    (1, 8, 256, 64),    # one slot at a 16k context: 64 splits of 4 pages
    (64, 8, 32, 64),    # many slots: one split of the whole table
    (3, 2, 4, 8),       # the test shapes above
    (1, 1, 1, 16),
    (256, 8, 4096, 16),  # the split's table entries are capped
    (2, 4, 1000, 128),
])
def test_fused_split_covers_every_block_table_entry(batch, kv_heads, max_pages, page):
    num_splits, per = tpa.fused_split(batch, kv_heads, max_pages, page)
    assert 1 <= per <= min(max_pages, tpa._FUSED_MAX_SPLIT_PAGES)
    assert num_splits * per >= max_pages > (num_splits - 1) * per
    # The combine keeps one weight per split in 48 KB of shared memory.
    assert num_splits * 4 <= 48 * 1024
    if (batch, kv_heads, max_pages, page) == (8, 8, 32, 64):
        assert (num_splits, per) == (8, 4)
    if (batch, kv_heads, max_pages, page) == (1, 8, 256, 64):
        assert (num_splits, per) == (64, 4)


def test_fused_wrapper_reads_no_device_value():
    """The split comes from shapes: the wrapper never copies a tensor to
    the host, so it does not wait for the card and a CUDA graph can hold
    it."""
    src = inspect.getsource(tpa.paged_decode_attention_fused)
    cuda_path = src.split('if q.device.type != "cuda"', 1)[1]
    for reader in (".item(", ".tolist(", ".cpu(", ".numpy(", "int(positions", "positions.max"):
        assert reader not in cuda_path
    assert "fused_split(b, kvh, mp, page)" in cuda_path
    assert "torch.empty(" in cuda_path
