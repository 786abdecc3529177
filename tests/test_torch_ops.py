"""kubeai_tpu_torch.ops against kubeai_tpu.ops on the same inputs (CPU,
f32): rms_norm, RoPE frequencies and rotation, prefill and decode
attention. Tolerance atol 1e-5: f32 on both sides, sums in different
orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.ops import attention as jattn
from kubeai_tpu.ops import norms as jnorms
from kubeai_tpu.ops import rope as jrope
from kubeai_tpu_torch.ops import attention as tattn
from kubeai_tpu_torch.ops import norms as tnorms
from kubeai_tpu_torch.ops import rope as trope

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs thousands of tiny ops: one intra-op thread
    keeps them from spinning against the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-5

SCALINGS = [
    None,
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
    {"rope_type": "yarn", "factor": 4.0,
     "original_max_position_embeddings": 4096},
    {"rope_type": "yarn", "factor": 4.0, "mscale": 1.0, "mscale_all_dim": 0.5,
     "original_max_position_embeddings": 4096},
    {"type": "linear", "factor": 2.0},
    {"rope_type": "dynamic", "factor": 2.0},
]


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_rms_norm_matches_jax():
    x = _rand((3, 5, 64), 0) * 3
    w = _rand((64,), 1)
    want = np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("scaling", SCALINGS, ids=lambda s: (s or {}).get(
    "rope_type", (s or {}).get("type", "plain")) + ("-mscale" if s and "mscale" in s else ""))
def test_rope_frequencies_and_scaling_match_jax(scaling):
    for d in (16, 64, 128):
        want = jrope.rope_frequencies(d, 500000.0, scaling, 8192)
        got = trope.rope_frequencies(d, 500000.0, scaling, 8192)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert trope.rope_attention_scaling(scaling) == jrope.rope_attention_scaling(scaling)


@pytest.mark.parametrize("scaling", [SCALINGS[0], SCALINGS[1], SCALINGS[2]],
                         ids=["plain", "llama3", "yarn"])
def test_apply_rope_matches_jax(scaling):
    D = 32
    inv = jrope.rope_frequencies(D, 10000.0, scaling, 8192)
    msc = jrope.rope_attention_scaling(scaling)
    x = _rand((2, 7, 4, D), 2)
    pos = np.random.default_rng(3).integers(0, 4000, (2, 7)).astype(np.int32)
    want = np.asarray(jrope.apply_rope(
        jnp.asarray(x), jnp.asarray(pos), jnp.asarray(inv), msc))
    got = trope.apply_rope(
        torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(inv), msc
    ).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("cap,win", [(None, None), (30.0, None), (None, 5), (50.0, 3)])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_causal_prefill_attention_matches_jax(cap, win, group):
    B, S, KVH, D = 2, 19, 2, 16
    H = KVH * group
    q, k, v = _rand((B, S, H, D), 4), _rand((B, S, KVH, D), 5), _rand((B, S, KVH, D), 6)
    want = np.asarray(jattn.causal_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        logit_softcap=cap, window=win))
    got = tattn.causal_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        logit_softcap=cap, window=win).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("cap,win", [(None, None), (30.0, None), (None, 5), (50.0, 3)])
def test_decode_attention_matches_jax(cap, win):
    B, L, KVH, G, D = 3, 24, 2, 4, 16
    q = _rand((B, KVH * G, D), 7)
    kc, vc = _rand((B, L, KVH, D), 8), _rand((B, L, KVH, D), 9)
    lengths = np.array([1, 13, 24], np.int32)
    want = np.asarray(jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lengths),
        logit_softcap=cap, window=win))
    got = tattn.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(lengths), logit_softcap=cap, window=win).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_fully_masked_row_is_uniform_not_nan():
    """NEG_INF is finite: a row with every key masked averages V."""
    q = torch.ones(1, 2, 4)
    kc = torch.randn(1, 5, 1, 4)
    vc = torch.randn(1, 5, 1, 4)
    out = tattn.decode_attention(q, kc, vc, torch.tensor([0]))
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[0, 0], vc[0, :, 0].mean(0))
