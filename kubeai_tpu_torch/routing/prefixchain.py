"""The page-hash chain that keys the engine's prefix cache. Counterpart
of kubeai_tpu/routing/prefixchain.py (`page_hash_chain`; the front
door's tokenizing `ChainComputer` is not ported).

The load balancer routes a request to the replica that holds the longest
prefix of its chain, so the port's engine must produce the JAX engine's
chain bit for bit: a blake2b-16 chain seeded `apc1:<adapter>:<gen>`,
folded one full page of int32 token ids at a time.
"""

from __future__ import annotations

import hashlib

import numpy as np

CHAIN_SEED_PREFIX = "apc1"


def page_hash_chain(
    token_ids: list[int],
    page_size: int,
    adapter_idx: int = 0,
    gen: int = 0,
) -> list[str]:
    """Hex blake2b-16 chain over the full pages of `token_ids`: entry i
    hashes pages 0..i. `gen` is the adapter's weight generation."""
    h = hashlib.blake2b(
        f"{CHAIN_SEED_PREFIX}:{adapter_idx}:{gen}".encode(), digest_size=16
    ).digest()
    arr = np.asarray(token_ids, np.int32)
    out: list[str] = []
    for i in range(len(token_ids) // page_size):
        h = hashlib.blake2b(
            h + arr[i * page_size : (i + 1) * page_size].tobytes(),
            digest_size=16,
        ).digest()
        out.append(h.hex())
    return out
