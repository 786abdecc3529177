"""Attention ops for prefill and decode: the plain PyTorch versions.
Counterpart of kubeai_tpu/ops/attention.py.

These are the reference semantics the CUDA kernels are held against
(`ops/flash_attention.py`, `ops/paged_attention.py`) and the path CPU
tensors take. GQA reshapes q to [kv_heads, group, ...] instead of
repeating K/V; softmax runs in float32.

Masked logits take the finite NEG_INF, not -inf, so that a fully masked
row softmaxes to uniform weights rather than NaN, as in the JAX package.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _window_tensor(window, device) -> torch.Tensor:
    return torch.as_tensor(window, dtype=torch.int32, device=device)


def causal_prefill_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, KVH, D]
    v: torch.Tensor,  # [B, S, KVH, D]
    *,
    q_offset: int = 0,  # positions of q within the sequence
    scale: float | None = None,
    logit_softcap: float | None = None,  # Gemma-2 tanh capping
    window: int | torch.Tensor | None = None,  # sliding window; <= 0 disables
) -> torch.Tensor:
    """Causal self-attention over a freshly computed prompt segment."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qg = (q * scale).reshape(b, s, kvh, h // kvh, d)  # [B, S, KVH, G, D]
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    if logit_softcap is not None:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    q_pos = torch.arange(s, device=q.device) + q_offset
    k_pos = torch.arange(k.shape[1], device=q.device)
    mask = q_pos[:, None] >= k_pos[None, :]  # [Sq, Sk]
    if window is not None:
        win = _window_tensor(window, q.device)
        mask = mask & ((win <= 0) | (q_pos[:, None] - k_pos[None, :] < win))
    logits = torch.where(mask[None, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def chunked_prefill_attention(
    q: torch.Tensor,  # [B, S, H, D] the new chunk's queries
    k_cache: torch.Tensor,  # [B, L, KVH, D] cache already holding the chunk
    v_cache: torch.Tensor,  # [B, L, KVH, D]
    chunk_start: torch.Tensor,  # [B] absolute position of q[:, 0]
    *,
    scale: float | None = None,
    logit_softcap: float | None = None,  # Gemma-2 tanh capping
    window: int | torch.Tensor | None = None,  # sliding window; <= 0 = off
) -> torch.Tensor:
    """Attention of a prefill chunk against the whole cache (causal from
    each query's absolute position). Softcap and window apply in the
    order of causal_prefill_attention: cap the raw logits, then mask.
    Keys past the causal frontier hold stale values and are masked."""
    b, s, h, d = q.shape
    kvh = k_cache.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qg = (q * scale).reshape(b, s, kvh, h // kvh, d)
    logits = torch.einsum("bqkgd,blkd->bkgql", qg.float(), k_cache.float())
    if logit_softcap is not None:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    start = torch.as_tensor(chunk_start, device=q.device).long()
    q_pos = start[:, None] + torch.arange(s, device=q.device)[None, :]  # [B, Sq]
    l_pos = torch.arange(k_cache.shape[1], device=q.device)  # [L]
    mask = q_pos[:, :, None] >= l_pos[None, None, :]  # [B, Sq, L]
    if window is not None:
        win = _window_tensor(window, q.device)
        mask = mask & ((win <= 0) | (q_pos[:, :, None] - l_pos[None, None, :] < win))
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgql,blkd->bqkgd", probs, v_cache.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # [B, H, D] one new token per slot
    k_cache: torch.Tensor,  # [B, L, KVH, D]
    v_cache: torch.Tensor,  # [B, L, KVH, D]
    lengths: torch.Tensor,  # [B] valid cache length per slot (incl. new token)
    *,
    scale: float | None = None,
    logit_softcap: float | None = None,
    window: int | torch.Tensor | None = None,  # sliding window; <= 0 = off
) -> torch.Tensor:
    """Single-token decode attention against a contiguous cache, masked
    by per-slot lengths."""
    b, h, d = q.shape
    kvh = k_cache.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qg = (q * scale).reshape(b, kvh, h // kvh, d)  # [B, KVH, G, D]
    logits = torch.einsum("bkgd,blkd->bkgl", qg.float(), k_cache.float())
    if logit_softcap is not None:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    l_pos = torch.arange(k_cache.shape[1], device=q.device)
    lengths = lengths.to(q.device)
    mask = l_pos[None, :] < lengths[:, None]  # [B, L]
    if window is not None:
        win = _window_tensor(window, q.device)
        mask = mask & ((win <= 0) | (l_pos[None, :] >= lengths[:, None] - win))
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgl,blkd->bkgd", probs, v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)
