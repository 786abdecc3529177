"""Slot KV cache. Counterpart of kubeai_tpu/engine/kvcache.py.

One buffer [num_layers, num_slots, max_len, kv_heads, head_dim] each for
K and V. Slots are the continuous-batching unit: a request owns one slot
from its prefill to its completion. The engine's slot mode keeps its
cache here, and a draft model keeps its own (the draft proposes through
the family's slot-cache `decode_step`).

The buffers are torch tensors on an explicit device that the engine
updates in place, at fixed addresses a captured CUDA graph keeps
reading; the JAX version is functional and returns new arrays. Slot
bookkeeping (the free list) is host-side Python in the engine.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [NL, slots, max_len, KVH, D]
    v: torch.Tensor  # [NL, slots, max_len, KVH, D]

    def nbytes(self) -> int:
        return int(self.k.nbytes + self.v.nbytes)

    @staticmethod
    def create(
        num_layers: int,
        num_slots: int,
        max_len: int,
        kv_heads: int,
        head_dim: int,
        dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device = "cuda",
    ) -> "KVCache":
        shape = (num_layers, num_slots, max_len, kv_heads, head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
        )


def insert_sequence(
    cache_k: torch.Tensor,  # [NL, slots, max_len, KVH, D]
    cache_v: torch.Tensor,
    k_new: torch.Tensor,  # [NL, S, KVH, D] (one sequence, padded to S)
    v_new: torch.Tensor,
    slot: int | torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write a prefilled sequence's K/V into a slot (positions 0..S-1),
    in place, and return the caches. S is a padded bucket length <=
    max_len; the padded tail holds garbage that the slot's length masks
    at attention time. The slot must lie in the cache: the JAX version's
    dynamic_update_slice would clamp an out-of-range start onto the last
    slot, and torch's indexing would raise on the card as a device-side
    assert, so the host checks it."""
    slot = int(slot)
    if not 0 <= slot < cache_k.shape[1]:
        raise IndexError(f"slot {slot} outside a cache of {cache_k.shape[1]} slots")
    S = k_new.shape[1]
    cache_k[:, slot, :S].copy_(k_new)
    cache_v[:, slot, :S].copy_(v_new)
    return cache_k, cache_v


def insert_sequences(
    cache_k: torch.Tensor,  # [NL, slots, max_len, KVH, D]
    cache_v: torch.Tensor,
    k_new: torch.Tensor,  # [NL, A, S, KVH, D] (A sequences, padded to S)
    v_new: torch.Tensor,
    slots: list[int],  # [A] slot of each row; >= num_slots: a padding row
) -> None:
    """Write a batch of prefilled rows into their slots, in place, as the
    JAX engine's draft admission scatters them (`.at[:, slots, :S].set`).
    That scatter silently drops a padding row, whose slot is num_slots;
    torch's indexing would raise on it (on the card as a device-side
    assert that kills the process), so padding rows are skipped here, on
    the host."""
    n = cache_k.shape[1]
    for row, slot in enumerate(slots):
        if slot < n:
            insert_sequence(cache_k, cache_v, k_new[:, row], v_new[:, row], slot)
