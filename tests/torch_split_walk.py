"""The split page walks of the port's decode kernels, emulated on the CPU in
f32 for their tests: csrc/paged_split_walk.cuh (shared by B1 and B4) and
csrc/paged_split_walk_int8.cuh (B1's int8 read).

Each split of `pages_per_split` block-table entries walks its kept keys in
TILE-token tiles dealt to WARPS warps (online softmax per warp) and merges
its warps in order into a partial (m, l, acc); the partials merge in split
order, then B4's new-token column if there is one, then the rows are
normalised. A row with no kept key and no new column comes out 0.

Int8 pools (B1's int8 read, `kubeai_paged_decode_int8`): the pools are
QuantizedPools, and the walk is the int8 walk's, with its own warps and
tile from its source: each score is the dot of the scaled q with the int8
row, times the row's K scale after the dot; V's scale goes into P
(P' = p * vs) and P' meets the int8 V rows; the sum l is of p. The
caller passes the int8 split (ops.paged_attention.int8_split)."""

import re
from pathlib import Path

import torch

from kubeai_tpu_torch.ops import paged_attention as tpa
from kubeai_tpu_torch.ops.kv_quant import QuantizedPool

CSRC = Path(tpa.__file__).resolve().parent.parent / "csrc"


def constant(source: str, name: str) -> int:
    """A `constexpr int` of a kernel source, read from the source."""
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


# Each walk's warps per CTA and tokens per warp tile, read from its source.
WARPS = constant("paged_split_walk.cuh", "kWarps")
TILE = constant("paged_split_walk.cuh", "kTile")
INT8_WARPS = constant("paged_split_walk_int8.cuh", "kWarps")
INT8_TILE = constant("paged_split_walk_int8.cuh", "kTile")


def merge(parts, extra=None):
    """Merge (m, l, acc) partials in list order, skipping those with no
    kept key (l == 0), then an always-valid column (score, value) if given.
    Returns (m, l, acc) unnormalised."""
    g, d = parts[0][2].shape
    kept = [(m, l, a) for m, l, a in parts if bool((l > 0).all())]
    m_all = torch.full((g,), tpa.NEG_INF)
    for m, _, _ in kept:
        m_all = torch.maximum(m_all, m)
    if extra is not None:
        m_all = torch.maximum(m_all, extra[0])
    l_all = torch.zeros(g)
    acc = torch.zeros(g, d)
    for m, l, a in kept:
        w = torch.exp(m - m_all)
        l_all = l_all + l * w
        acc = acc + a * w[:, None]
    if extra is not None:
        w = torch.exp(extra[0] - m_all)
        l_all = l_all + w
        acc = acc + w[:, None] * extra[1][None, :]
    return m_all, l_all, acc


def _pool(pages):
    """(f32 values [P, page, KVH, D], f32 scales [P, page, KVH] or None)."""
    if isinstance(pages, QuantizedPool):
        return pages.q8.float(), pages.scale.float()
    return torch.as_tensor(pages).float(), None


def emulate_split_walk(q, k_pages, v_pages, block_tables, counts, pages_per_split,
                       *, new=None, cap=None, win=None):
    """The kernels' algorithm over a one-layer [P, page, KVH, D] pool.

    With `new` = (k_new, v_new) it is B4's: counts are old lengths, old keys
    in [max(n + 1 - win, 0), min(n, MP * page)), the new token merged last.
    Without it, B1's: counts are lengths with the new token, keys in
    [max(n - win, 0), min(n, MP * page))."""
    q = torch.as_tensor(q).float()
    kp, ks = _pool(k_pages)
    vp, vs = _pool(v_pages)
    warps, tile = (WARPS, TILE) if ks is None else (INT8_WARPS, INT8_TILE)
    bt, counts = torch.as_tensor(block_tables).long(), torch.as_tensor(counts).long()
    b, h, d = q.shape
    kvh, page, mp = kp.shape[2], kp.shape[1], bt.shape[1]
    g = h // kvh
    num_splits = -(-mp // pages_per_split)
    out = torch.empty(b, h, d)
    for s in range(b):
        n = int(counts[s])
        lo = max(n + (1 if new is not None else 0) - win, 0) if win else 0
        for kh in range(kvh):
            qg = q[s, kh * g:(kh + 1) * g] * d ** -0.5
            empty = (torch.full((g,), tpa.NEG_INF), torch.zeros(g), torch.zeros(g, d))
            parts = []
            for split in range(num_splits):
                start = split * pages_per_split * page
                t_lo = max(start, lo)
                t_hi = min(start + pages_per_split * page, n, mp * page)
                if t_lo >= t_hi:
                    parts.append(empty)
                    continue
                n_tiles = -(-(t_hi - t_lo) // tile)
                per_warp = []
                for w in range(warps):
                    m, l, acc = empty
                    for i in range(w, n_tiles, warps):
                        toks = torch.arange(t_lo + i * tile, min(t_lo + (i + 1) * tile, t_hi))
                        pages = bt[s, toks // page].clamp(min=0)
                        k = kp[pages, toks % page, kh]
                        v = vp[pages, toks % page, kh]
                        sc = qg @ k.T
                        if ks is not None:  # int8: K's scale after the dot
                            sc = sc * ks[pages, toks % page, kh][None, :]
                        if cap is not None:
                            sc = torch.tanh(sc / cap) * cap
                        m_new = torch.maximum(m, sc.max(-1).values)
                        pr = torch.exp(sc - m_new[:, None])
                        alpha = torch.exp(m - m_new)
                        l = l * alpha + pr.sum(-1)
                        if ks is not None:  # int8: V's scale in P
                            pr = pr * vs[pages, toks % page, kh][None, :]
                        acc = acc * alpha[:, None] + pr @ v
                        m = m_new
                    per_warp.append((m, l, acc))
                parts.append(merge(per_warp))
            extra = None
            if new is not None:
                kn, vn = (torch.as_tensor(a).float() for a in new)
                s_new = (qg * kn[s, kh]).sum(-1)
                if cap is not None:
                    s_new = torch.tanh(s_new / cap) * cap
                extra = (s_new, vn[s, kh])
            _, l_all, acc = merge(parts, extra)
            out[s, kh * g:(kh + 1) * g] = acc / l_all.clamp(min=1e-30)[:, None]
    return out.numpy()
