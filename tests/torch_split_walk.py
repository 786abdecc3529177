"""The split page walk of the port's decode kernels (csrc/paged_split_walk.cuh,
shared by B1 and B4), emulated on the CPU in f32 for the tests of both.

Each split of `pages_per_split` block-table entries walks its kept keys in
TILE-token tiles dealt to WARPS warps (online softmax per warp) and merges
its warps in order into a partial (m, l, acc); the partials merge in split
order, then B4's new-token column if there is one, then the rows are
normalised. A row with no kept key and no new column comes out 0.

Int8 pools (B1's int8 read, `kubeai_paged_decode_int8`): the pools are
QuantizedPools, and each tile's rows dequantize in f32 as they load,
q8 * scale, before the products; tiles and splits are the same."""

import re
from pathlib import Path

import torch

from kubeai_tpu_torch.ops import paged_attention as tpa
from kubeai_tpu_torch.ops.kv_quant import QuantizedPool

_SRC = (Path(tpa.__file__).resolve().parent.parent / "csrc"
        / "paged_split_walk.cuh").read_text()
# The walk's warps per CTA and tokens per warp tile, read from its source.
WARPS = int(re.search(r"constexpr int kWarps = (\d+);", _SRC).group(1))
TILE = int(re.search(r"constexpr int kTile = (\d+);", _SRC).group(1))


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
                n_tiles = -(-(t_hi - t_lo) // TILE)
                warps = []
                for w in range(WARPS):
                    m, l, acc = empty
                    for i in range(w, n_tiles, WARPS):
                        toks = torch.arange(t_lo + i * TILE, min(t_lo + (i + 1) * TILE, t_hi))
                        pages = bt[s, toks // page].clamp(min=0)
                        k = kp[pages, toks % page, kh]
                        v = vp[pages, toks % page, kh]
                        if ks is not None:  # dequantize at load, in f32
                            k = k * ks[pages, toks % page, kh][:, None]
                            v = v * vs[pages, toks % page, kh][:, None]
                        sc = qg @ k.T
                        if cap is not None:
                            sc = torch.tanh(sc / cap) * cap
                        m_new = torch.maximum(m, sc.max(-1).values)
                        pr = torch.exp(sc - m_new[:, None])
                        alpha = torch.exp(m - m_new)
                        l = l * alpha + pr.sum(-1)
                        acc = acc * alpha[:, None] + pr @ v
                        m = m_new
                    warps.append((m, l, acc))
                parts.append(merge(warps))
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
