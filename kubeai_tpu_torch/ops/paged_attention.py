"""Paged decode, verify and fused-decode attention, and the paged-cache
write helpers. Counterpart of kubeai_tpu/ops/paged_attention.py.

Three kernels, each with its plain PyTorch version beside it. CPU
tensors take the plain version; the tests and chip_smoke.py hold each
kernel against it. For a CUDA tensor a wrapper launches its kernel or
raises.

  paged_decode_attention       — one query token per slot over the
      slot's pages (csrc/paged_decode.cu, replaces the Pallas kernel B1:
      the split page walk of B4, shared through csrc/paged_split_walk.cuh,
      on a one-layer pool, and a fixed-order combine); plain version
      ref_paged_decode_attention.
  paged_verify_attention       — K query tokens per slot, the speculative
      verify window, each seeing the keys up to its own position
      (csrc/paged_verify.cu, replaces B3: the page walk split across CTAs
      as fused_split chooses, both products on tensor cores, f32 partials
      merged in a fixed order by a second kernel); plain version
      ref_paged_verify_attention.
  paged_decode_attention_fused — one query token per slot over one layer
      of the STACKED [NL, ...] pool, read in place, with the new token
      (not yet in the pool) merged as one extra column
      (csrc/paged_decode_fused.cu, replaces B4: each slot's page walk
      split across CTAs as fused_split chooses, f32 partials in scratch
      merged in a fixed order by a second kernel); plain version
      ref_paged_decode_attention_fused.

The write helpers mirror two behaviours of the JAX versions by hand:
jnp gathers clamp out-of-range indices (positions past the block table
map to the reserved scratch page 0 here), and the engine keeps its own
mask for scatter rows that must write nothing.
"""

from __future__ import annotations

import os

import torch

from kubeai_tpu_torch.ops import _build

NEG_INF = -1e30

# Which decode-attention layout the models use when the caller does not
# say: "per_layer" scatters each layer's new token, then attends through
# paged_decode_attention; "fused" attends through
# paged_decode_attention_fused and writes every layer's new token in one
# scatter after the layer loop. The environment variable picks between
# them when the caller gives no layout, as in the JAX package.
DECODE_KERNEL_ENV = "KUBEAI_TPU_DECODE_KERNEL"
_DECODE_KERNELS = ("per_layer", "fused")


def default_decode_kernel() -> str:
    mode = os.environ.get(DECODE_KERNEL_ENV, "").strip().lower()
    return mode if mode in _DECODE_KERNELS else "per_layer"


def resolve_decode_kernel(requested: str | None) -> str:
    """Validate an explicit layout; None/"" defers to the env var."""
    if not requested:
        return default_decode_kernel()
    if requested not in _DECODE_KERNELS:
        raise ValueError(
            f"decode kernel {requested!r} not in {_DECODE_KERNELS}"
        )
    return requested


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


_MAX_GROUP = 8  # query heads per kv head the decode kernels take
_MAX_VERIFY_ROWS = 64  # (window tokens x group) rows the verify kernel takes
_HEAD_DIMS = (64, 128)


def _check_common(kernel: str, bf16: dict, int32: dict, window) -> None:
    """What every paged kernel wrapper checks: one device, bf16 data and
    int32 indices, all contiguous, the window a Python int."""
    tensors = {**bf16, **int32}
    dev = tensors["q"].device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} kernel takes a contiguous {name}")
    for name, t in bf16.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{kernel} kernel takes bf16 {name}, got {t.dtype}")
    for name, t in int32.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{kernel} kernel takes int32 {name}, got {t.dtype}")
    if window is not None and not isinstance(window, int):
        raise TypeError(f"the {kernel} kernel takes window as a Python int")


def _check_heads(d: int, pool_d: int, h: int, kvh: int, max_group: int) -> None:
    if pool_d != d or d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} (pool {pool_d}) not in {_HEAD_DIMS}")
    if h % kvh or h // kvh > max_group:
        raise ValueError(
            f"{h} q heads over {kvh} kv heads: group must divide and be <= {max_group}"
        )


def _check_tables(block_tables, per_slot, b: int) -> None:
    if block_tables.dim() != 2 or block_tables.shape[0] != b or tuple(per_slot.shape) != (b,):
        raise ValueError(
            f"block_tables {tuple(block_tables.shape)} / per-slot "
            f"{tuple(per_slot.shape)} do not match batch {b}"
        )


def _check_decode_args(q, k_pages, v_pages, block_tables, lengths, window):
    _check_common(
        "paged decode",
        dict(q=q, k_pages=k_pages, v_pages=v_pages),
        dict(block_tables=block_tables, lengths=lengths),
        window,
    )
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, pools {tuple(k_pages.shape)} / "
            f"{tuple(v_pages.shape)}: want q [B, H, D], pools [P, page, KVH, D]"
        )
    b, h, d = q.shape
    _check_heads(d, k_pages.shape[3], h, k_pages.shape[2], _MAX_GROUP)
    _check_tables(block_tables, lengths, b)


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
    raises. CPU tensors take ref_paged_decode_attention.

    A length past the block table keeps only the table's keys. A slot
    that keeps no key (length 0, or a window wholly past the table)
    gets 0 from the kernel, as from the TPU kernel; the plain version,
    like the JAX reference, averages every column there."""
    if q.device.type == "cpu":
        return ref_paged_decode_attention(
            q, k_pages, v_pages, block_tables, lengths,
            scale=scale, logit_softcap=logit_softcap, window=window,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged decode attention has no path for {q.device}")
    _check_decode_args(q, k_pages, v_pages, block_tables, lengths, window)
    b, h, d = q.shape
    page, kvh = k_pages.shape[1], k_pages.shape[2]
    mp = block_tables.shape[1]
    # From shapes alone: nothing here reads a device value, so the call
    # never waits for the card and can be captured in a CUDA graph.
    num_splits, pages_per_split = fused_split(b, kvh, mp, page)
    out = torch.empty_like(q)
    # Per (slot, kv head, split): m[G], l[G], then acc[G, D], in f32.
    scratch = torch.empty(b * kvh * num_splits * (h // kvh) * (d + 2),
                          dtype=torch.float32, device=q.device)
    lib = _build.load()
    status = lib.kubeai_paged_decode_bf16(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        scratch.data_ptr(),
        b, h, kvh, d, page, mp, num_splits, pages_per_split,
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


# ---- speculative verify (B3) -------------------------------------------------


def ref_paged_verify_attention(
    q: torch.Tensor,  # [B, K, H, D] K speculative positions per slot
    k_pages: torch.Tensor,  # [P, page, KVH, D]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MP]
    positions: torch.Tensor,  # [B] absolute position of query 0
    *,
    scale: float | None = None,
    logit_softcap: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Multi-query paged attention for the speculative verify: query k
    sits at positions + k and attends the keys at columns <= its own
    position (the window's K/V are already in the pages), within the
    sliding window when one is set. Gather, then masked attention.

    A row masked everywhere (a sliding window narrower than the row's
    distance past the end of the block table) averages every column
    here, as the JAX reference does; the kernels, the TPU's and this
    port's, write 0 there. No model the port serves has such a window."""
    b, kq, h, d = q.shape
    kvh = k_pages.shape[2]
    bt = block_tables.long().clamp(min=0)
    k = k_pages[bt]
    v = v_pages[bt]
    mp, page = k.shape[1], k.shape[2]
    L = mp * page
    k = k.reshape(b, L, kvh, d).float()
    v = v.reshape(b, L, kvh, d).float()
    scale = scale if scale is not None else d ** -0.5
    qg = (q * scale).reshape(b, kq, kvh, h // kvh, d)
    logits = torch.einsum("bqkgd,blkd->bkgql", qg.float(), k)  # [B, KVH, G, K, L]
    if logit_softcap is not None:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    col = torch.arange(L, device=q.device)
    q_abs = positions.to(q.device).long()[:, None] + torch.arange(kq, device=q.device)
    mask = col[None, None, :] <= q_abs[:, :, None]  # [B, K, L]
    if window is not None:
        win = torch.as_tensor(window, dtype=torch.int32, device=q.device)
        mask = mask & ((win <= 0) | (col[None, None, :] > q_abs[:, :, None] - win))
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgql,blkd->bqkgd", probs, v)
    return out.reshape(b, kq, h, d).to(q.dtype)


def _check_verify_args(q, k_pages, v_pages, block_tables, positions, window):
    _check_common(
        "paged verify",
        dict(q=q, k_pages=k_pages, v_pages=v_pages),
        dict(block_tables=block_tables, positions=positions),
        window,
    )
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, pools {tuple(k_pages.shape)} / "
            f"{tuple(v_pages.shape)}: want q [B, K, H, D], pools [P, page, KVH, D]"
        )
    b, kq, h, d = q.shape
    kvh = k_pages.shape[2]
    _check_heads(d, k_pages.shape[3], h, kvh, _MAX_VERIFY_ROWS)
    if kq * (h // kvh) > _MAX_VERIFY_ROWS:
        raise ValueError(
            f"{kq} window tokens x group {h // kvh} = {kq * (h // kvh)} rows; "
            f"the verify kernel takes <= {_MAX_VERIFY_ROWS}"
        )
    _check_tables(block_tables, positions, b)


def paged_verify_attention(
    q: torch.Tensor,  # [B, K, H, D]
    k_pages: torch.Tensor,  # [P, page, KVH, D]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MP] int32
    positions: torch.Tensor,  # [B] int32 absolute position of query 0
    *,
    scale: float | None = None,
    logit_softcap: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Speculative verify attention. CUDA tensors launch the kernel
    (bf16, head_dim 64 or 128, K * group <= 64 rows per kv head); anything
    else it does not take raises. CPU tensors take
    ref_paged_verify_attention."""
    if q.device.type == "cpu":
        return ref_paged_verify_attention(
            q, k_pages, v_pages, block_tables, positions,
            scale=scale, logit_softcap=logit_softcap, window=window,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged verify attention has no path for {q.device}")
    _check_verify_args(q, k_pages, v_pages, block_tables, positions, window)
    b, kq, h, d = q.shape
    page, kvh = k_pages.shape[1], k_pages.shape[2]
    mp = block_tables.shape[1]
    # From shapes alone: nothing here reads a device value, so the call
    # never waits for the card and can be captured in a CUDA graph.
    num_splits, pages_per_split = fused_split(b, kvh, mp, page)
    out = torch.empty_like(q)
    # Per (slot, kv head, split): m[R], l[R], then acc[R, D], in f32, with
    # R = K * group rows; acc starts 16-byte aligned (up to 3 floats of gap).
    scratch = torch.empty(b * kvh * num_splits * kq * (h // kvh) * (d + 2) + 3,
                          dtype=torch.float32, device=q.device)
    lib = _build.load()
    status = lib.kubeai_paged_verify_bf16(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
        scratch.data_ptr(),
        b, kq, h, kvh, d, page, mp, num_splits, pages_per_split,
        float(scale if scale is not None else d ** -0.5),
        float(logit_softcap or 0.0),
        int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "paged_verify_attention")
    paged_verify_attention.launches += 1
    return out


paged_verify_attention.launches = 0


# ---- fused decode over the stacked pool (B4) ---------------------------------


def ref_paged_decode_attention_fused(
    q: torch.Tensor,  # [B, H, D]
    k_pages: torch.Tensor,  # [NL, P, page, KVH, D] stacked pools
    v_pages: torch.Tensor,
    k_new: torch.Tensor,  # [B, KVH, D] the new token, not yet in the pool
    v_new: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MP]
    positions: torch.Tensor,  # [B] OLD lengths (the new token's position)
    layer: int,
    *,
    scale: float | None = None,
    logit_softcap: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Attention over the resident pages of `layer` plus the new token as
    an explicit extra column at position `positions`; equal (up to sum
    order) to scatter-then-attend with lengths = positions + 1."""
    b, h, d = q.shape
    kvh = k_pages.shape[3]
    bt = block_tables.long().clamp(min=0)
    k = k_pages[int(layer)][bt]  # [B, MP, page, KVH, D]
    v = v_pages[int(layer)][bt]
    mp, page = k.shape[1], k.shape[2]
    L = mp * page
    k = torch.cat([k.reshape(b, L, kvh, d), k_new[:, None].to(k.dtype)], 1).float()
    v = torch.cat([v.reshape(b, L, kvh, d), v_new[:, None].to(v.dtype)], 1).float()
    scale = scale if scale is not None else d ** -0.5
    qg = (q * scale).reshape(b, kvh, h // kvh, d)
    logits = torch.einsum("bkgd,blkd->bkgl", qg.float(), k)
    if logit_softcap is not None:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    col = torch.arange(L + 1, device=q.device)
    pos = positions.to(q.device).long()
    new = col[None, :] == L
    # Columns < positions are old tokens; column L is the new token.
    mask = (col[None, :] < pos[:, None]) | new
    if window is not None:
        win = torch.as_tensor(window, dtype=torch.int32, device=q.device)
        in_win = (win <= 0) | (col[None, :] >= pos[:, None] + 1 - win)
        mask = mask & (in_win | new)
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgl,blkd->bkgd", probs, v)
    return out.reshape(b, h, d).to(q.dtype)


def _check_fused_args(q, k_pages, v_pages, k_new, v_new, block_tables,
                      positions, layer, window):
    _check_common(
        "fused paged decode",
        dict(q=q, k_pages=k_pages, v_pages=v_pages, k_new=k_new, v_new=v_new),
        dict(block_tables=block_tables, positions=positions),
        window,
    )
    if q.dim() != 3 or k_pages.dim() != 5 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, pools {tuple(k_pages.shape)} / "
            f"{tuple(v_pages.shape)}: want q [B, H, D], pools [NL, P, page, KVH, D]"
        )
    b, h, d = q.shape
    kvh = k_pages.shape[3]
    _check_heads(d, k_pages.shape[4], h, kvh, _MAX_GROUP)
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if tuple(t.shape) != (b, kvh, d):
            raise ValueError(f"{name} {tuple(t.shape)}: want [B, KVH, D] = {(b, kvh, d)}")
    _check_tables(block_tables, positions, b)
    if not isinstance(layer, int) or not 0 <= layer < k_pages.shape[0]:
        raise ValueError(
            f"layer {layer!r}: want a Python int in [0, {k_pages.shape[0]})"
        )


# The split walk of the decode kernels (B4's, which B1 shares) runs one CTA
# per (slot, kv head, split), two of them to an SM at head_dim 128: aim at
# two waves over an H100's 132 SMs, with at least 64 tokens (one 16-token
# tile per warp) and at most 64 block-table entries (the kernel keeps them
# in shared memory) in a split. The verify kernel splits the same way (two
# CTAs an SM, one 64-token tile at least): at the serving shapes its walk
# was faster with these splits than with splits of twice the length
# (PERF.md, section 6).
_FUSED_TARGET_CTAS = 4 * 132
_FUSED_MIN_SPLIT_TOKENS = 64
_FUSED_MAX_SPLIT_PAGES = 64


def fused_split(batch: int, kv_heads: int, max_pages: int, page_size: int) -> tuple[int, int]:
    """(num_splits, pages_per_split) for the fused kernel's page walk, from
    shapes alone: split s of a slot takes block-table entries
    [s * pages_per_split, (s + 1) * pages_per_split), and the splits cover
    all max_pages of them, the last possibly short."""
    per = -(-(batch * kv_heads * max_pages) // _FUSED_TARGET_CTAS)
    per = max(per, -(-_FUSED_MIN_SPLIT_TOKENS // page_size), 1)
    per = min(per, max_pages, _FUSED_MAX_SPLIT_PAGES)
    return -(-max_pages // per), per


def paged_decode_attention_fused(
    q: torch.Tensor,  # [B, H, D]
    k_pages: torch.Tensor,  # [NL, P, page, KVH, D] stacked pools
    v_pages: torch.Tensor,
    k_new: torch.Tensor,  # [B, KVH, D]
    v_new: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MP] int32
    positions: torch.Tensor,  # [B] int32 OLD lengths
    layer: int,  # layer index into the stacked pool
    *,
    scale: float | None = None,
    logit_softcap: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Fused paged decode attention: reads one layer's pages straight out
    of the stacked pool and folds the new token in as an extra column, so
    the caller writes every layer's new K/V in one scatter after the
    layer loop. CUDA tensors launch the kernel (bf16, head_dim 64 or 128,
    group <= 8); anything else it does not take raises. CPU tensors take
    ref_paged_decode_attention_fused."""
    if q.device.type == "cpu":
        return ref_paged_decode_attention_fused(
            q, k_pages, v_pages, k_new, v_new, block_tables, positions, layer,
            scale=scale, logit_softcap=logit_softcap, window=window,
        )
    if q.device.type != "cuda":
        raise ValueError(f"fused paged decode attention has no path for {q.device}")
    _check_fused_args(q, k_pages, v_pages, k_new, v_new, block_tables,
                      positions, layer, window)
    b, h, d = q.shape
    nl, n_pages, page, kvh, _ = k_pages.shape
    mp = block_tables.shape[1]
    # From shapes alone: nothing here reads a device value, so the call
    # never waits for the card and can be captured in a CUDA graph.
    num_splits, pages_per_split = fused_split(b, kvh, mp, page)
    out = torch.empty_like(q)
    # Per (slot, kv head, split): m[G], l[G], then acc[G, D], in f32.
    scratch = torch.empty(b * kvh * num_splits * (h // kvh) * (d + 2),
                          dtype=torch.float32, device=q.device)
    lib = _build.load()
    status = lib.kubeai_paged_decode_fused_bf16(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(),
        block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
        scratch.data_ptr(),
        b, h, kvh, d, n_pages, page, mp, layer, num_splits, pages_per_split,
        float(scale if scale is not None else d ** -0.5),
        float(logit_softcap or 0.0),
        int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "paged_decode_attention_fused")
    paged_decode_attention_fused.launches += 1
    return out


paged_decode_attention_fused.launches = 0


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
