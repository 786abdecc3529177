"""kubeai_tpu_torch.ops.flash_attention against kubeai_tpu's Pallas flash
prefill kernel (interpret mode, force=True): on CPU tensors the port's
flash_causal_prefill is its plain version. Tolerance rtol/atol 2e-3, the
JAX kernel test's own.

The CUDA kernel (csrc/flash_prefill.cu) runs only on the card. Its
algorithm is emulated here in f32 in its own tile order, with its block
sizes read from the source, and held against the JAX kernel and the plain
version."""

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
# Query rows per CTA (64 per consumer warpgroup) and keys per K/V tile.
BQ = int(re.search(r"constexpr int kBQ = (\d+);", _SRC).group(1))
BK = int(re.search(r"constexpr int kBK = (\d+);", _SRC).group(1))
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
def _jax_case(S, group, D):
    """Inputs and the JAX Pallas kernel's output (interpret mode)."""
    KVH = 2
    q, k, v = _mk(1, S, KVH * group, KVH, D, seed=S + group + D)
    want = np.asarray(j_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True, force=True))
    return q, k, v, want


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_prefill_matches_jax_interpret_kernel(S, group, D):
    q, k, v, want = _jax_case(S, group, D)
    got = tfa.flash_causal_prefill(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def _masked_tile(t, r0):
    """The kernel's rule: a consumer's 64 rows from r0 mask key tile t only
    if the tile's last key lies past r0 (the tile crosses the diagonal)."""
    return (t + 1) * BK - 1 > r0


def emulate_kernel(q, k, v, *, bf16_p=False):
    """csrc/flash_prefill.cu's algorithm in f32 on the CPU.

    Per (batch row, head) and BQ-row block, each consumer's 64 rows walk
    the BK-key tiles up to the block's causal frontier in order (tiles past
    it are never read). Per tile: raw scores, the q_pos >= k_pos mask only
    on a tile that crosses the diagonal, the row max taken on the raw
    scores, P = exp2(s * scale * log2(e) - m) and alpha in the log2
    domain, P rounded to bf16 before P.V when `bf16_p`. Rows and keys past
    S read as zeros (TMA's fill); the rows past S are not written. Out =
    acc / max(l, 1e-30)."""
    q, k, v = (torch.as_tensor(a).float() for a in (q, k, v))
    b, s, h, d = q.shape
    g = h // k.shape[2]
    sl2 = d ** -0.5 * math.log2(math.e)
    n_qb = -(-s // BQ)
    pad = n_qb * BQ - s
    qh = torch.nn.functional.pad(q.permute(0, 2, 1, 3), (0, 0, 0, pad))
    kh, vh = (torch.nn.functional.pad(
        x.permute(0, 2, 1, 3).repeat_interleave(g, dim=1), (0, 0, 0, pad)) for x in (k, v))
    out = torch.zeros(b, h, s, d)
    for qb in range(n_qb):
        q0 = qb * BQ
        n_kt = -(-min(q0 + BQ, s) // BK)
        for r0 in range(q0, q0 + BQ, 64):
            m = torch.full((b, h, 64), NEG_INF)
            l = torch.zeros(b, h, 64)
            acc = torch.zeros(b, h, 64, d)
            for t in range(n_kt):
                keys = slice(t * BK, (t + 1) * BK)
                sc = qh[:, :, r0:r0 + 64] @ kh[:, :, keys].transpose(-1, -2)
                if _masked_tile(t, r0):
                    q_pos = torch.arange(r0, r0 + 64)[:, None]
                    k_pos = torch.arange(t * BK, (t + 1) * BK)[None, :]
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
    """BQ is whole consumer warpgroups of 64 rows; BK is whole k16 steps of
    the P.V product."""
    assert BQ == 128 and BK == 128
    assert "constexpr int kConsumers = kBQ / 64;" in _SRC


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("D", [64, 128])
def test_kernel_emulation_matches_jax_interpret_kernel(S, group, D):
    q, k, v, want = _jax_case(S, group, D)
    got = emulate_kernel(q, k, v).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("S", [32, 200, 384])
def test_kernel_emulation_with_bf16_p_within_card_limit(S):
    """With P rounded to bf16, as the kernel feeds it to P.V, the
    emulation stays within the card's limit of the plain version, also for
    a ragged tail (32: less than one block; 200: a partial second block)
    and three blocks of tiles (384)."""
    q, k, v = _mk(2, S, 8, 2, 128, seed=S)
    want = causal_prefill_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    got = emulate_kernel(q, k, v, bf16_p=True)
    err = (got - want).abs()
    assert bool((err <= FLASH_TOL + FLASH_TOL * want.abs()).all()), float(err.max())
    # The rounding of P is visible, yet well inside the limit.
    assert 1e-4 < float(err.max()) < FLASH_TOL / 2


def test_kernel_emulation_never_reads_past_the_frontier():
    """The first block's rows read only the first BK keys: K/V past them
    may hold anything (NaN here) without reaching those rows."""
    S = 2 * BQ
    q, k, v = _mk(1, S, 4, 2, 64, seed=5)
    k[:, BK:], v[:, BK:] = np.nan, np.nan
    got = emulate_kernel(q, k, v)
    want = causal_prefill_attention(
        *(torch.from_numpy(x[:, :BQ]).contiguous() for x in (q, k, v)))
    assert torch.isfinite(got[:, :BQ]).all() and not torch.isfinite(got[:, BQ:]).all()
    torch.testing.assert_close(got[:, :BQ], want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("S", [32, 200, 1000])
def test_only_diagonal_tiles_need_the_mask(S):
    """For every consumer's rows and key tile the kernel walks, a tile it
    does not mask has no key past any of its valid rows, and a tile it
    masks has one: the mask is applied exactly where causality needs it."""
    walked = 0
    for q0 in range(0, S, BQ):
        n_kt = -(-min(q0 + BQ, S) // BK)
        for r0 in range(q0, min(q0 + BQ, S), 64):
            q_pos = torch.arange(r0, min(r0 + 64, S))[:, None]
            for t in range(n_kt):
                k_pos = torch.arange(t * BK, (t + 1) * BK)[None, :]
                assert _masked_tile(t, r0) == bool((k_pos > q_pos).any())
                walked += 1
        # Tiles past the frontier hold no key at or before any row.
        assert n_kt * BK > min(q0 + BQ, S) - 1 >= (n_kt - 1) * BK
    assert walked >= -(-S // 64)


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
