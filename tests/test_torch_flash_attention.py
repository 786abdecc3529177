"""kubeai_tpu_torch.ops.flash_attention against kubeai_tpu's Pallas flash
prefill kernel (interpret mode, force=True): on CPU tensors the port's
flash_causal_prefill is its plain version. Tolerance rtol/atol 2e-3, the
JAX kernel test's own."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.ops.attention import causal_prefill_attention as j_causal
from kubeai_tpu.ops.pallas_attention import flash_causal_prefill as j_flash
from kubeai_tpu_torch.ops import flash_attention as tfa


def _mk(B, S, H, KVH, D, seed):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D))
    )


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_prefill_matches_jax_interpret_kernel(S, group, D):
    KVH = 2
    q, k, v = _mk(1, S, KVH * group, KVH, D, seed=S + group + D)
    want = np.asarray(j_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True, force=True))
    got = tfa.flash_causal_prefill(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


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
