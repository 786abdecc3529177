// The split page walk of the paged decode kernels for Hopper (sm_90a): one
// new query token per slot against the slot's resident K/V pages, each
// slot's walk split across CTAs, f32 partials out. Included by
// paged_decode.cu (B1, one-layer pool) and paged_decode_fused.cu (B4, one
// layer of the stacked pool, plus a new-token column that the B4 combine
// merges); each source adds its own combine, which merges the partials.
// B1's read of an int8 pool has a walk of its own, designed for its bytes
// (paged_split_walk_int8.cuh), which uses the helpers below.
//
// What bounds it on this card: bytes. G <= 8 query rows per kv head make
// about 4 flops per byte of K/V, far below the ~295 where math would be the
// limit; the least time is the K+V bytes the mask keeps over 3.35 TB/s.
// What one CTA per (slot, kv head) walking the whole table held back, and
// what this walk does:
//   1. Too few CTAs, one per (slot, kv head): 64 for 132 SMs, 8 at B=1.
//      The grid is (KVH, B, S): CTA s walks only block-table entries
//      [s * pps, (s + 1) * pps) of its slot, with S and pps chosen by the
//      wrapper from shapes alone (fused_split: 8 splits of 4 pages, 512
//      CTAs, at 8 slots x 32 pages). A CTA whose pages hold no kept key
//      (past the slot's keys, past the block table, or wholly below the
//      window) writes an empty partial (m = NEG_INF, l = 0) and exits. The
//      split's block-table entries are read once into shared memory, and
//      each lane steps its token's page and offset from tile to tile
//      without a division.
//   2. No loads in flight during math, four barriers a tile: each of the
//      CTA's four warps owns a ring of kStages 16-token K/V tiles in
//      dynamic shared memory (102 KB a CTA at D=128, G <= 4; two CTAs an
//      SM; see D = 256 below), filled with 16-byte cp.async, zero-filled
//      outside the kept range, while it works on the oldest. In the walk
//      a warp waits only on itself (__syncwarp); the CTA meets once, at
//      the end of its split.
//   3. A 5-step warp reduction per (token, row): lanes l and l + 16 own
//      token l of the tile and half of its head dims each; they dot their
//      half of the K row against the G query rows (f32, scaled, broadcast
//      from shared memory) and join with one shuffle per row and tile. K
//      rows are padded by 16 bytes so each 8-lane phase hits distinct
//      banks. Softcap runs once per lane and row. A row's max takes one
//      warp reduction per tile; its sum l stays per lane and is reduced
//      once per split.
//   4. A serial scalar p.V: lane l owns D/32 head dims, reads them as one
//      bf16x4 (bf16x2 at D=64, bf16x8 at D=256) per token, over the tile's
//      16 tokens unrolled, into G x D/32 f32 accumulators; P comes from
//      shared memory as float4 broadcasts. The four warps' partials are
//      merged once per split, in warp order.
//   5. Spills: the walk is built for a group bound MG of 4 (Llama-3,
//      Mistral) or 8 and declares two CTAs an SM, so ptxas may use up to
//      255 registers. It computes all MG rows with no per-row guard (rows
//      past G have q = 0 and are never written): a guard costs a
//      predicated copy per FMA. Nothing per thread is indexed at run time;
//      q and P live in shared memory.
// Kept keys: `kNewColumn` says which caller's semantics the walk has, and
// changes only the low edge of the kept range. With n = counts[b]:
//   B4 (kNewColumn): n is the OLD length, the new token's position; old
//     keys in [max(n + 1 - window, 0), min(n, MP * page)), read from layer
//     `layer` of the stacked [NL, P, page, KVH, D] pool (a 64-bit offset);
//   B1: n is the length with the new token, already in the pool; keys in
//     [max(n - window, 0), min(n, MP * page)) of a [P, page, KVH, D] pool
//     (layer 0).
// A length past the block table keeps only the table's keys, as the TPU
// kernel's (B, MP) grid does. Both keep max(page_id, 0) for an unallocated
// entry, the finite NEG_INF, softcap, and D 64, 128 and 256.
// D = 256 (Gemma): the same walk and the same kStages. Its ring is 4 warps
// x 3 tiles x 16 tokens x (264 + 256) bf16 = 199,680 B, so a CTA takes
// 200 KB (MG 4) or 205 KB (MG 8) of the 227 KB an SM offers, and one CTA
// fits an SM where two fit at D = 128. The bytes in flight per SM stay
// the same: one CTA's 3 tiles of 1 KiB rows against two CTAs' of 512 B,
// so the ring keeps its depth. What changes is the split: a CTA walks its
// split alone, at twice the bytes a token, so fused_split caps a
// head_dim-256 split at 512 tokens (the measurement is beside the cap in
// ops/paged_attention.py). acc doubles to MG x 8 floats a lane (64 at MG
// 8) under the same 255-register bound: 177 registers at MG 8, 122 at MG
// 4, no spills.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16;      // tokens per warp tile, one per half-warp lane
constexpr int kStages = 3;     // tiles in each warp's ring
constexpr int kMaxGroup = 8;   // query heads per kv head
constexpr int kMaxSplitPages = 64;  // block-table entries per split
constexpr float kNegInf = -1e30f;  // the JAX package's finite NEG_INF

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 16 bytes global -> shared, asynchronously; zero-fills when !ok (reads
// nothing then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <int D, int MG>
struct Layout {
  static constexpr int kChunks = D / 8;       // 16-byte chunks per token row
  static constexpr int kHalf = kChunks / 2;   // chunks per half-warp lane
  static constexpr int kKStride = D + 8;      // padded K row, in bf16
  static constexpr int kDims = D / 32;        // head dims per lane in p.v
  static constexpr int kStageElems = kTile * (kKStride + D);  // bf16
  static constexpr int kQBytes = MG * D * 4;
  static constexpr int kPBytes = kWarps * kTile * MG * 4;
  static constexpr int kRingBytes = kWarps * kStages * kStageElems * 2;
  static constexpr int kSmemBytes = kQBytes + kPBytes + kRingBytes;
  // The end-of-split combine reuses the ring: m, l and acc of each warp.
  static_assert(kWarps * MG * (D + 2) * 4 <= kRingBytes, "ring too small");
};

// Partials of CTA (b, kh, split), in `part`: m[G] and l[G] at
// ((b * KVH + kh) * S + split) * 2G, then, after all CTAs' m and l, acc[G, D]
// at n_cta * 2G + ((b * KVH + kh) * S + split) * G * D, all f32.
template <int D, int MG, bool kNewColumn>
__global__ void __launch_bounds__(kThreads, 2)
paged_split_walk_kernel(const __nv_bfloat16* __restrict__ q,        // [B, H, D]
                        const __nv_bfloat16* __restrict__ k_pages,  // [NL, P, page, KVH, D]
                        const __nv_bfloat16* __restrict__ v_pages,
                        const int* __restrict__ block_tables,       // [B, MP]
                        const int* __restrict__ counts,             // [B], see above
                        float* __restrict__ part,
                        int H, int KVH, int num_pages, int page_size,
                        int max_pages, int layer, int pages_per_split,
                        float scale, float softcap, int window) {
  using L = Layout<D, MG>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                  // [MG, D]
  float* p_all = reinterpret_cast<float*>(smem + L::kQBytes);   // [kWarps, kTile, MG]
  __nv_bfloat16* ring =
      reinterpret_cast<__nv_bfloat16*>(smem + L::kQBytes + L::kPBytes);

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int S = gridDim.z;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t cta = ((size_t)b * KVH + kh) * S + split;
  const size_t n_cta = (size_t)gridDim.y * KVH * S;
  float* part_ml = part + cta * 2 * G;
  float* part_acc = part + n_cta * 2 * G + cta * G * D;

  // Kept keys of this split: positions in [t_lo, t_hi). B4's window also
  // holds the new token, so it keeps one old key fewer than B1's.
  const int count = counts[b];
  const int lo = window > 0 ? max(count + (kNewColumn ? 1 : 0) - window, 0) : 0;
  const int start = split * pages_per_split * page_size;
  const int t_lo = max(start, lo);
  const int t_hi = min(min(start + pages_per_split * page_size, count),
                       max_pages * page_size);
  if (t_lo >= t_hi) {
    if (tid < G) {
      part_ml[tid] = kNegInf;
      part_ml[G + tid] = 0.f;
    }
    return;
  }

  // Rows G..MG-1 are zero: the walk computes all MG rows without a
  // guard (a guard per row costs a predicated copy per FMA), and their
  // results are never written.
  for (int i = tid; i < MG * D; i += kThreads)
    q_s[i] = i < G * D
        ? __bfloat162float(q[((size_t)b * H + (size_t)kh * G) * D + i]) * scale
        : 0.f;
  // This split's block-table entries, so that no tile waits on a global
  // load before its copies can start.
  __shared__ int page_s[kMaxSplitPages];
  const int first_page = split * pages_per_split;
  for (int i = tid; i < min(pages_per_split, max_pages - first_page); i += kThreads)
    page_s[i] = max(block_tables[(size_t)b * max_pages + first_page + i], 0);

  const size_t tok_stride = (size_t)KVH * D;
  const size_t layer_off = (size_t)layer * num_pages * page_size * tok_stride;
  const __nv_bfloat16* kl = k_pages + layer_off;
  const __nv_bfloat16* vl = v_pages + layer_off;
  __nv_bfloat16* my_ring = ring + warp * kStages * L::kStageElems;
  float* p_s = p_all + warp * kTile * MG;

  const int n_tiles = (t_hi - t_lo + kTile - 1) / kTile;
  const int my_tiles = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;

  // Lane l owns token l % 16 of each tile and half l / 16 of its head dims.
  const int tok = lane & (kTile - 1);
  const int half = lane >> 4;

  // Start the copy of this warp's i-th tile into ring slot i % kStages;
  // called for i = 0, 1, 2, ... in turn. Lane t finds token t's row from
  // its page and offset, which step by kWarps * kTile tokens a call (no
  // division in the walk); lanes then copy 16-byte chunks, neighbours on
  // neighbouring addresses. Always commits a group, empty or not.
  int pg = (t_lo + warp * kTile + tok) / page_size - first_page;
  int pg_off = (t_lo + warp * kTile + tok) % page_size;
  auto issue = [&](int i) {
    if (i < my_tiles) {
      const int p = t_lo + (warp + i * kWarps) * kTile + tok;
      long long row = -1;
      if (p < t_hi)
        row = ((long long)page_s[pg] * page_size + pg_off) * (long long)tok_stride +
              (long long)kh * D;
      for (pg_off += kWarps * kTile; pg_off >= page_size; pg_off -= page_size) ++pg;
      __nv_bfloat16* k_dst = my_ring + (i % kStages) * L::kStageElems;
      __nv_bfloat16* v_dst = k_dst + kTile * L::kKStride;
#pragma unroll
      for (int j = 0; j < L::kHalf; ++j) {
        const int idx = lane + 32 * j;
        const int t = idx / L::kChunks;
        const int c = idx % L::kChunks;
        const long long r = __shfl_sync(0xffffffffu, row, t);
        const bool ok = r >= 0;
        const size_t off = ok ? (size_t)r + c * 8 : 0;
        cp_async16(k_dst + t * L::kKStride + c * 8, kl + off, ok);
        cp_async16(v_dst + t * D + c * 8, vl + off, ok);
      }
    }
    cp_async_commit();
  };

  float m[MG], l[MG], acc[MG][L::kDims];
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < L::kDims; ++e) acc[g][e] = 0.f;
  }

  __syncthreads();  // q_s and page_s are written
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  for (int i = 0; i < my_tiles; ++i) {
    issue(i + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const __nv_bfloat16* k_st = my_ring + (i % kStages) * L::kStageElems;
    const __nv_bfloat16* v_st = k_st + kTile * L::kKStride;
    const int n = min(kTile, t_hi - (t_lo + (warp + i * kWarps) * kTile));
    const bool valid = tok < n;

    // Scores: this lane's token against the G rows over its half of the
    // head dims; one shuffle per row joins the halves.
    float s[MG];
#pragma unroll
    for (int g = 0; g < MG; ++g) s[g] = 0.f;
    const __nv_bfloat16* krow = k_st + tok * L::kKStride;
#pragma unroll 4
    for (int c = half * L::kHalf; c < (half + 1) * L::kHalf; ++c) {
      float kf[8];
      unpack8(*reinterpret_cast<const uint4*>(krow + c * 8), kf);
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        const float4 qa = *reinterpret_cast<const float4*>(q_s + g * D + c * 8);
        const float4 qb = *reinterpret_cast<const float4*>(q_s + g * D + c * 8 + 4);
        float x = s[g];
        x = fmaf(qa.x, kf[0], x);
        x = fmaf(qa.y, kf[1], x);
        x = fmaf(qa.z, kf[2], x);
        x = fmaf(qa.w, kf[3], x);
        x = fmaf(qb.x, kf[4], x);
        x = fmaf(qb.y, kf[5], x);
        x = fmaf(qb.z, kf[6], x);
        s[g] = fmaf(qb.w, kf[7], x);
      }
    }

#pragma unroll
    for (int g = 0; g < MG; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], 16);

    // Online softmax per row; l stays per lane of the first half. Every
    // tile holds at least one kept key (token 0), so m is finite after the
    // first.
    float alpha[MG], pr[MG];
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      float sv = s[g];
      if (softcap > 0.f) sv = tanhf(sv / softcap) * softcap;
      sv = valid ? sv : kNegInf;
      const float m_new = fmaxf(m[g], warp_max(sv));
      pr[g] = valid ? expf(sv - m_new) : 0.f;
      alpha[g] = expf(m[g] - m_new);
      l[g] = l[g] * alpha[g] + (half == 0 ? pr[g] : 0.f);
      m[g] = m_new;
    }
    if (half == 0) {
      float4* p_row = reinterpret_cast<float4*>(p_s + tok * MG);
#pragma unroll
      for (int j = 0; j < MG / 4; ++j)
        p_row[j] = make_float4(pr[4 * j], pr[4 * j + 1], pr[4 * j + 2], pr[4 * j + 3]);
    }
    __syncwarp();

    // acc = acc * alpha + P . V over the tile's tokens (P is 0 and V zero
    // past the kept range).
#pragma unroll
    for (int g = 0; g < MG; ++g)
#pragma unroll
      for (int e = 0; e < L::kDims; ++e) acc[g][e] *= alpha[g];
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      float vf[L::kDims];
      const __nv_bfloat16* vrow = v_st + t * D + lane * L::kDims;
      if constexpr (L::kDims == 8) {
        unpack8(*reinterpret_cast<const uint4*>(vrow), vf);
      } else if constexpr (L::kDims == 4) {
        const uint2 u = *reinterpret_cast<const uint2*>(vrow);
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
        vf[0] = a.x;
        vf[1] = a.y;
        vf[2] = c.x;
        vf[3] = c.y;
      } else {
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vrow));
        vf[0] = a.x;
        vf[1] = a.y;
      }
      float pt[MG];
#pragma unroll
      for (int j = 0; j < MG / 4; ++j) {
        const float4 x = reinterpret_cast<const float4*>(p_s + t * MG)[j];
        pt[4 * j] = x.x;
        pt[4 * j + 1] = x.y;
        pt[4 * j + 2] = x.z;
        pt[4 * j + 3] = x.w;
      }
#pragma unroll
      for (int g = 0; g < MG; ++g)
#pragma unroll
        for (int e = 0; e < L::kDims; ++e) acc[g][e] = fmaf(pt[g], vf[e], acc[g][e]);
    }
    __syncwarp();  // the slot and p_s are free for the next copy
  }
  cp_async_wait<0>();

  // The CTA's warps meet once: each writes m, l and acc to the ring, then
  // the CTA merges them in warp order into this split's partial.
#pragma unroll
  for (int g = 0; g < MG; ++g) l[g] = warp_sum(l[g]);
  __syncthreads();  // every warp is done with its ring
  float* w_m = reinterpret_cast<float*>(ring);   // [kWarps, MG]
  float* w_l = w_m + kWarps * MG;          // [kWarps, MG]
  float* w_acc = w_l + kWarps * MG;        // [kWarps, MG, D]
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    if (g < G) {
      if (lane == 0) {
        w_m[warp * MG + g] = m[g];
        w_l[warp * MG + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < L::kDims; ++e)
        w_acc[(warp * MG + g) * D + lane * L::kDims + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i - g * D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (w_l[w * MG + g] > 0.f) mm = fmaxf(mm, w_m[w * MG + g]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float lw = w_l[w * MG + g];
      if (lw > 0.f) {
        const float e = expf(w_m[w * MG + g] - mm);
        ll += lw * e;
        aa += w_acc[(w * MG + g) * D + d] * e;
      }
    }
    part_acc[i] = aa;
    if (d == 0) {
      part_ml[g] = mm;
      part_ml[G + g] = ll;
    }
  }
}

}  // namespace
