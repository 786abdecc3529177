"""Int8 KV-cache quantization: per-token-per-head symmetric scales.
Counterpart of kubeai_tpu/ops/kv_quant.py, with the same arithmetic.

An int8 pool stores pages as int8 and one float32 scale per (token, kv
head) beside them, which halves the resident KV bytes and every KV
transfer: handoffs, peer prefix fetches and spills ship the quantized
pages verbatim (disagg/handoff.py's `kv_quant` block).

Layout. A quantized pool is a `QuantizedPool` of two tensors:

    q8:    int8    [..., page, KVH, D]   quantized pages
    scale: float32 [..., page, KVH]      per-token-per-head scales

Indexing a QuantizedPool indexes both alike (`pool[layer]`,
`pool[:, pages]`), so the code that walks layers or gathers pages reads
the same for both pool kinds. The JAX package uses {"q8", "scale"} dicts.

Each token's K (or V) row of D values quantizes on its own,

    scale = max(|row|) / 127   (clamped to SCALE_FLOOR)
    q8    = round(row / scale) in [-127, 127]

so a decode step appends one row without re-scaling resident tokens:
pages are immutable once written, which the prefix cache's hash chains
and the handoff byte identity rely on. torch.round, like jnp.round,
rounds half to even, and the row is divided by its scale (not multiplied
by a reciprocal), so q8 is the JAX package's bit for bit on equal input.

Capacity: one token-layer costs 2*KVH*D*2 bytes in bf16 and 2*KVH*(D + 4)
in int8 (+4: the f32 scale), a 2D/(D+4) capacity factor, 1.94 at D=128.

Dequantization happens in f32 inside the attention read: the plain
version multiplies the gathered int8 pages by their gathered scales, and
on the card the decode kernel (csrc/paged_decode.cu,
`kubeai_paged_decode_int8`) does the same per element before its dot.
"""

from __future__ import annotations

import dataclasses

import torch

# Scales below this clamp to it: an all-zero row (scratch pages)
# quantizes to zeros and dequantizes back to exact zeros.
SCALE_FLOOR = 1e-8

# Engine-facing dtype names (EngineConfig.kv_dtype, --kv-dtype, the CRD's
# kvCache.dtype). "" means unset and resolves to bfloat16.
KV_DTYPES = ("bfloat16", "int8")


def resolve_kv_dtype(name: str) -> str:
    """Normalize a kv-dtype knob; raises ValueError on unknown names."""
    name = (name or "").strip().lower()
    if name == "":
        return "bfloat16"
    if name not in KV_DTYPES:
        raise ValueError(f"kv dtype {name!r} not in {KV_DTYPES}")
    return name


@dataclasses.dataclass(frozen=True)
class QuantizedPool:
    """An int8 page pool and its scales. The tensors are updated in place
    (the captured device programs read them at fixed addresses)."""

    q8: torch.Tensor  # int8 [..., page, KVH, D]
    scale: torch.Tensor  # f32 [..., page, KVH]

    def __getitem__(self, idx) -> "QuantizedPool":
        """The same index into both tensors (never into the head dim)."""
        return QuantizedPool(self.q8[idx], self.scale[idx])

    @property
    def shape(self) -> torch.Size:
        """The page-array shape, as a bf16 pool's."""
        return self.q8.shape

    @property
    def device(self) -> torch.device:
        return self.q8.device

    @property
    def nbytes(self) -> int:
        """Resident bytes: pages and scales."""
        return self.q8.nbytes + self.scale.nbytes


def make_quantized_pool(shape, device: str | torch.device = "cpu") -> QuantizedPool:
    """Zeroed quantized pool: int8 pages `shape` and f32 scales
    shape[:-1] (a zero scale is fine: rows are written before they are
    read, and masked junk dequantizes to 0)."""
    return QuantizedPool(
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(tuple(shape[:-1]), dtype=torch.float32, device=device),
    )


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., D] -> (int8 [..., D], f32 scales [...]): symmetric per-row
    quantization over the last (head_dim) axis."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = torch.clamp(amax / 127.0, min=SCALE_FLOOR)
    q8 = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127).to(torch.int8)
    return q8, scale


def dequantize_kv(q8: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(int8 [..., D], scales [...]) -> [..., D] in `dtype`, through f32."""
    return (q8.float() * scale[..., None].float()).to(dtype)


def kv_capacity_factor(head_dim: int, scale_bytes: int = 4) -> float:
    """Slot-capacity multiplier of int8 KV against bf16 at equal device
    memory: bytes per token per head 2*D (bf16) over D + scale_bytes."""
    return (2.0 * head_dim) / (head_dim + scale_bytes)
