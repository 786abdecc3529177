"""Causal flash attention for prefill.
Counterpart of kubeai_tpu/ops/pallas_attention.py (`flash_causal_prefill`).

`flash_causal_prefill` wraps the CUDA kernel in csrc/flash_prefill.cu,
which replaces the Pallas kernel B2. Its plain version is
`ops.attention.causal_prefill_attention`: CPU tensors take it, and the
tests and chip_smoke.py hold the kernel against it.

The Pallas kernel pads head_dim to 128 and needs S % 128 == 0 (TPU
tiling rules). The Hopper kernel needs neither: it masks the ragged S
tail and takes head_dim 64 or 128, so on the card every prefill bucket
goes through it. Its C entry point builds the TMA maps on the host from
the pointers and shapes on each call, so the wrapper reads no device
value and a CUDA graph can capture it; a pointer that is not 16-byte
aligned makes the launch fail and the wrapper raise.
"""

from __future__ import annotations

import torch

from kubeai_tpu_torch.ops import _build
from kubeai_tpu_torch.ops.attention import causal_prefill_attention

_HEAD_DIMS = (64, 128)


def _check_prefill_args(q, k, v):
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash prefill kernel takes bf16 {name}, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, S, heads, D], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash prefill kernel takes a contiguous {name}")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {_HEAD_DIMS}")
    if h % k.shape[2]:
        raise ValueError(f"{h} q heads not divisible by {k.shape[2]} kv heads")


def flash_causal_prefill(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, KVH, D]
    v: torch.Tensor,
) -> torch.Tensor:
    """Flash attention with the causal_prefill_attention contract. CUDA
    tensors launch the kernel (bf16, head_dim 64 or 128) or raise; CPU
    tensors take causal_prefill_attention."""
    if q.device.type == "cpu":
        return causal_prefill_attention(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash prefill has no path for {q.device}")
    _check_prefill_args(q, k, v)
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    lib = _build.load()
    status = lib.kubeai_flash_prefill_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, h, k.shape[2], d, float(d ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "flash_causal_prefill")
    flash_causal_prefill.launches += 1
    return out


# Kernel launches since the count was last set to 0.
flash_causal_prefill.launches = 0
