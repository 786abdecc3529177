"""The port's speculative-verify attention (kernel B3's wrapper and plain
version) against kubeai_tpu's: the plain version against the JAX Pallas
kernel in interpret mode and against its reference, over ragged
positions, softcap, a sliding window and a window that reaches past the
block table. Tolerance atol/rtol 1e-4 in f32, the JAX verify test's own
(online vs one-shot softmax)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.ops import paged_attention as jpa
from kubeai_tpu_torch.ops import paged_attention as tpa

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
