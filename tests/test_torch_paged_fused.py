"""The port's fused paged decode attention over the stacked pool (kernel
B4's wrapper and plain version) against kubeai_tpu's: the plain version
against the JAX Pallas kernel in interpret mode and its reference at
atol/rtol 1e-4 in f32 (the JAX fused test's own), against the port's
scatter-then-attend at 1e-5 (the same sums in another order), and an
empty slot returning its new token's value."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.ops import paged_attention as jpa
from kubeai_tpu_torch.ops import paged_attention as tpa

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
