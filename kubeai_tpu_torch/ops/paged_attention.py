"""Paged decode attention and the paged-cache write helpers.
Counterpart of kubeai_tpu/ops/paged_attention.py.

  ref_paged_decode_attention — gather pages through the block tables into
      a contiguous view, then masked attention. The plain PyTorch version:
      CPU tensors take it, and the tests and chip_smoke.py hold the kernel
      against it.
  paged_decode_attention     — the wrapper of the CUDA kernel
      (csrc/paged_decode.cu), which replaces the Pallas kernel B1. For a
      CUDA tensor it launches the kernel or raises; only a CPU tensor
      takes the plain version.

The write helpers mirror two behaviours of the JAX versions by hand:
jnp gathers clamp out-of-range indices (positions past the block table
map to the reserved scratch page 0 here), and the engine keeps its own
mask for scatter rows that must write nothing.
"""

from __future__ import annotations

import torch

from kubeai_tpu_torch.ops import _build

NEG_INF = -1e30

_DECODE_KERNELS = ("per_layer", "fused")


def resolve_decode_kernel(requested: str | None) -> str:
    """Validate a decode-attention layout; None/"" means "per_layer".
    Only "per_layer" is ported: "fused" (the stacked-pool kernel B4)
    raises NotImplementedError."""
    mode = requested or "per_layer"
    if mode not in _DECODE_KERNELS:
        raise ValueError(f"decode kernel {mode!r} not in {_DECODE_KERNELS}")
    if mode == "fused":
        raise NotImplementedError(
            "decode_kernel='fused' (the stacked-pool paged kernel, ROADMAP "
            "B4) is not ported yet; use 'per_layer'"
        )
    return mode


def ref_paged_decode_attention(
    q: torch.Tensor,  # [B, H, D] one new token per slot
    k_pages: torch.Tensor,  # [P, page, KVH, D] this layer's page pool
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MP] page ids, -1 = unallocated
    lengths: torch.Tensor,  # [B] valid tokens per slot (incl. the new one)
    *,
    scale: float | None = None,
    logit_softcap: float | None = None,
    window: int | None = None,  # sliding window; <= 0 disables
) -> torch.Tensor:
    """Gather pages into a virtual contiguous view, then masked attention."""
    b, h, d = q.shape
    bt = block_tables.long().clamp(min=0)  # -1 -> scratch page 0 (masked)
    kvh = k_pages.shape[2]
    k = k_pages[bt].float()  # [B, MP, page, KVH, D]
    v = v_pages[bt].float()
    mp, page = k.shape[1], k.shape[2]
    k = k.reshape(b, mp * page, kvh, d)
    v = v.reshape(b, mp * page, kvh, d)
    scale = scale if scale is not None else d ** -0.5
    qg = (q * scale).reshape(b, kvh, h // kvh, d)
    logits = torch.einsum("bkgd,blkd->bkgl", qg.float(), k)
    if logit_softcap is not None:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    pos = torch.arange(mp * page, device=q.device)
    lengths = lengths.to(q.device)
    mask = pos[None, :] < lengths[:, None]  # [B, L]
    if window is not None:
        win = torch.as_tensor(window, dtype=torch.int32, device=q.device)
        mask = mask & ((win <= 0) | (pos[None, :] >= lengths[:, None] - win))
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgl,blkd->bkgd", probs, v)
    return out.reshape(b, h, d).to(q.dtype)


_MAX_GROUP = 8  # query heads per kv head the kernel takes
_HEAD_DIMS = (64, 128)


def _check_decode_args(q, k_pages, v_pages, block_tables, lengths, window):
    dev = q.device
    for name, t in (
        ("k_pages", k_pages), ("v_pages", v_pages),
        ("block_tables", block_tables), ("lengths", lengths),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"paged decode kernel takes bf16 {name}, got {t.dtype}")
    for name, t in (("block_tables", block_tables), ("lengths", lengths)):
        if t.dtype != torch.int32:
            raise TypeError(f"paged decode kernel takes int32 {name}, got {t.dtype}")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, pools {tuple(k_pages.shape)} / "
            f"{tuple(v_pages.shape)}: want q [B, H, D], pools [P, page, KVH, D]"
        )
    b, h, d = q.shape
    kvh = k_pages.shape[2]
    if k_pages.shape[3] != d or d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} (pool {k_pages.shape[3]}) not in {_HEAD_DIMS}")
    if h % kvh or h // kvh > _MAX_GROUP:
        raise ValueError(f"{h} q heads over {kvh} kv heads: group must divide and be <= {_MAX_GROUP}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b or tuple(lengths.shape) != (b,):
        raise ValueError(
            f"block_tables {tuple(block_tables.shape)} / lengths "
            f"{tuple(lengths.shape)} do not match batch {b}"
        )
    for name, t in (
        ("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
        ("block_tables", block_tables), ("lengths", lengths),
    ):
        if not t.is_contiguous():
            raise ValueError(f"paged decode kernel takes a contiguous {name}")
    if window is not None and not isinstance(window, int):
        raise TypeError("the paged decode kernel takes window as a Python int")


def paged_decode_attention(
    q: torch.Tensor,  # [B, H, D]
    k_pages: torch.Tensor,  # [P, page, KVH, D]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MP] int32
    lengths: torch.Tensor,  # [B] int32
    *,
    scale: float | None = None,
    logit_softcap: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Paged decode attention. CUDA tensors launch the kernel (bf16,
    head_dim 64 or 128, group <= 8); anything else it does not take
    raises. CPU tensors take ref_paged_decode_attention."""
    if q.device.type == "cpu":
        return ref_paged_decode_attention(
            q, k_pages, v_pages, block_tables, lengths,
            scale=scale, logit_softcap=logit_softcap, window=window,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged decode attention has no path for {q.device}")
    _check_decode_args(q, k_pages, v_pages, block_tables, lengths, window)
    b, h, d = q.shape
    out = torch.empty_like(q)
    lib = _build.load()
    status = lib.kubeai_paged_decode_bf16(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, h, k_pages.shape[2], d, k_pages.shape[1], block_tables.shape[1],
        float(scale if scale is not None else d ** -0.5),
        float(logit_softcap or 0.0),
        int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


# Kernel launches since the count was last set to 0.
paged_decode_attention.launches = 0


# ---- paged cache writes (decode + admission) ---------------------------------


def token_page_coords(
    block_tables: torch.Tensor,  # [B, MP]
    positions: torch.Tensor,  # [B] absolute position of the new token
    page_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(page_ids [B], offsets [B]) for one new token per slot. Unallocated
    entries (-1) and positions past the block table map to the reserved
    scratch page 0 (the JAX version's gather would clamp the index and
    hit a live page)."""
    mp = block_tables.shape[1]
    slot_idx = torch.arange(block_tables.shape[0], device=block_tables.device)
    pidx = positions.long() // page_size
    page_ids = block_tables[slot_idx, pidx.clamp(max=mp - 1)]
    page_ids = torch.where(pidx < mp, page_ids, -1)
    return page_ids.clamp(min=0), positions.long() % page_size


def scatter_decode_token(
    k_pages: torch.Tensor,  # [P, page, KVH, D] (one layer)
    v_pages: torch.Tensor,
    k_new: torch.Tensor,  # [B, KVH, D]
    v_new: torch.Tensor,
    page_ids: torch.Tensor,  # [B]
    offsets: torch.Tensor,  # [B]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write one token per slot through the block tables (decode step),
    in place; returns the same pools. The JAX version returns new
    arrays."""
    k_pages[page_ids, offsets] = k_new.to(k_pages.dtype)
    v_pages[page_ids, offsets] = v_new.to(v_pages.dtype)
    return k_pages, v_pages


def batched_sequence_page_coords(
    bt_rows: torch.Tensor,  # [A, MP] block-table rows (one per admission)
    lengths: torch.Tensor,  # [A] true lengths
    seq_len: int,  # padded (bucket) length
    page_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(page_ids [A, S], offsets [A, S]) for prefilled sequences. Padded
    tail positions (>= length) and unallocated entries (-1) write into the
    reserved scratch page 0."""
    mp = bt_rows.shape[1]
    pos = torch.arange(seq_len, device=bt_rows.device)
    page_ids = bt_rows[:, (pos // page_size).clamp(max=mp - 1)].clamp(min=0)
    page_ids = torch.where(
        pos[None, :] < lengths.to(bt_rows.device)[:, None], page_ids, 0
    )
    return page_ids.long(), (pos % page_size).expand_as(page_ids)


def batched_scatter_sequence(
    k_pages: torch.Tensor,  # [NL, P, page, KVH, D]
    v_pages: torch.Tensor,
    k_seq: torch.Tensor,  # [NL, A, S, KVH, D]
    v_seq: torch.Tensor,
    page_ids: torch.Tensor,  # [A, S]
    offsets: torch.Tensor,  # [A, S]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write A prefilled sequences through their block tables in one
    scatter, in place; returns the same pools."""
    k_pages[:, page_ids, offsets] = k_seq.to(k_pages.dtype)
    v_pages[:, page_ids, offsets] = v_seq.to(v_pages.dtype)
    return k_pages, v_pages
