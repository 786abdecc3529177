"""Token sampling: greedy, temperature, top-k, top-p.
Counterpart of kubeai_tpu/engine/sampling.py, token for token.

Semantics: a top-64 candidate pool; top-k filters first, then top-p acts
on the renormalised post-top-k distribution; the most likely token always
survives (top_p=0.0 degrades to greedy, not to token 0). Top-k ties break
toward the lower index, as `lax.top_k` does (a stable descending sort).

Seeded rows draw exactly what the JAX version draws: the row key is
fold_in(PRNGKey(seed), position) under jax's threefry2x32 with
`jax_threefry_partitionable` on (jax 0.9's default), and the draw is
`categorical`, i.e. argmax(logits + Gumbel noise). Threefry, fold_in and
the bits-to-float conversion are reproduced bit for bit on int64 tensors
holding uint32 values, on the logits' device; the Gumbel transform's f32
`log` can differ from XLA's in the last bit, which changes a draw only
when its two best candidates lie within one ulp.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling config (host-side; tensors built per batch).

    `stop` holds stop strings, enforced by the server on detokenized text;
    the engine core works in token space (EOS token ids)."""

    temperature: float = 1.0
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0
    max_tokens: int = 16
    stop: tuple[str, ...] = ()
    seed: int | None = None


# Sampling candidate pool: top-k and the nucleus are computed within the
# MAX_TOP_K most likely tokens.
MAX_TOP_K = 64

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) as jax.random implements it. Every
    argument is an int64 tensor (or int) holding uint32 values; they
    broadcast. Returns the two uint32 output words as int64 tensors."""
    k0 = torch.as_tensor(k0, dtype=torch.int64)
    k1 = torch.as_tensor(k1, dtype=torch.int64, device=k0.device)
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (torch.as_tensor(x0, dtype=torch.int64, device=k0.device) + ks[0]) & _M32
    x1 = (torch.as_tensor(x1, dtype=torch.int64, device=k0.device) + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """jax.random.PRNGKey of uint32 seeds: the key words (0, seed)."""
    seed = torch.as_tensor(seed, dtype=torch.int64) & _M32
    return torch.zeros_like(seed), seed


def fold_in(key, data) -> tuple[torch.Tensor, torch.Tensor]:
    """jax.random.fold_in: threefry2x32(key, (0, uint32(data)))."""
    k0, k1 = key
    data = torch.as_tensor(data, dtype=torch.int64, device=k0.device) & _M32
    return threefry2x32(k0, k1, torch.zeros_like(data), data)


def random_bits(key, n: int) -> torch.Tensor:
    """jax's partitionable threefry random bits for a 1-D shape (n,), per
    key: bits[i] = xor of threefry2x32(key, (0, i)). `key` words are [B]
    tensors; returns [B, n] int64 holding uint32 values."""
    k0, k1 = key
    counts = torch.arange(n, dtype=torch.int64, device=k0.device)[None, :]
    b0, b1 = threefry2x32(k0[:, None], k1[:, None], torch.zeros_like(counts), counts)
    return b0 ^ b1


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """jax.random.uniform(minval=tiny, maxval=1) in float32 from 32 random
    bits: the top 23 bits become a mantissa in [1, 2), minus 1."""
    f = (((bits >> 9) | 0x3F800000).to(torch.int32)).view(torch.float32) - 1.0
    # floats * (maxval - minval) + minval, with maxval - minval == 1.0 in f32.
    return torch.clamp(f + _F32_TINY, min=_F32_TINY)


def gumbel(key, n: int) -> torch.Tensor:
    """jax.random.gumbel (mode "low") of shape (n,) per key: [B, n] f32."""
    return -torch.log(-torch.log(uniform_from_bits(random_bits(key, n))))


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """jax.random.categorical over the last axis of [B, n] logits, one key
    per row: argmax(logits + gumbel). Returns [B] int64."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax's arithmetic: exp(x - max) / sum."""
    e = torch.exp(x - torch.max(x, dim=-1, keepdim=True).values)
    return e / torch.sum(e, dim=-1, keepdim=True)


def sample(
    logits: torch.Tensor,  # [B, V] float32
    seeds: torch.Tensor,  # [B] uint32 seeds (any integer dtype)
    positions: torch.Tensor,  # [B] current position (per-step entropy)
    temperature: torch.Tensor,  # [B] (0 = greedy)
    top_k: torch.Tensor,  # [B] (0 = off; capped at MAX_TOP_K)
    top_p: torch.Tensor,  # [B] float32 (1 = off)
) -> torch.Tensor:
    """Vectorized per-request sampling. Returns [B] int64 token ids."""
    B, V = logits.shape
    K = min(MAX_TOP_K, V)
    dev = logits.device
    greedy_tok = torch.argmax(logits, dim=-1)

    temp = torch.clamp(temperature.float(), min=1e-6)[:, None]
    scaled = logits / temp
    # lax.top_k order: descending, ties toward the lower index.
    vals, idxs = torch.sort(scaled, dim=-1, descending=True, stable=True)
    vals, idxs = vals[:, :K], idxs[:, :K]
    top_k = top_k.to(dev).long()
    k_eff = torch.where(top_k > 0, torch.clamp(top_k, max=K), K)
    keep_k = torch.arange(K, device=dev)[None, :] < k_eff[:, None]

    # top-p (nucleus) over the RENORMALIZED post-top-k distribution.
    kvals = torch.where(keep_k, vals, -torch.inf)
    probs = _softmax(kvals)
    cumsum = torch.cumsum(probs, dim=-1)
    keep = keep_k & (cumsum - probs < top_p.to(dev).float()[:, None])
    keep[:, 0] = True  # top-1 always survives
    masked = torch.where(keep, kvals, -torch.inf)

    key = fold_in(prng_key(seeds.to(dev)), positions.to(dev))
    choice = categorical(key, masked)  # [B] in [0, K)
    sampled = torch.gather(idxs, 1, choice[:, None])[:, 0]
    return torch.where(temperature.to(dev) <= 0.0, greedy_tok, sampled)
