// The split page walk of B1's int8 read for Hopper (sm_90a): one new query
// token per slot against the slot's resident int8 K/V pages and their f32
// per-(token, kv head) scales (ops/kv_quant.py), each slot's walk split
// across CTAs, f32 partials out in the layout of B1's bf16 walk
// (paged_split_walk.cuh), which B1's combine in paged_decode.cu merges.
// Included by paged_decode.cu's int8 entry, `kubeai_paged_decode_int8`.
//
// The function is B1's over dequantized pages, keys in [max(n - window, 0),
// min(n, MP * page)) for a length n that holds the new token, with GQA,
// softcap, D 64, 128 and 256, max(page_id, 0) for an unallocated entry,
// the finite NEG_INF, and 0 for a slot that keeps no key.
//
// What bounds it on this card: bytes, D + 4 a kept row (D int8 values and
// one f32 scale), against 2D for bf16 B1: 21.6 MB and 6.45 us at the 8B
// case (8 slots, 8 kv heads, lengths <= 2048). But at G = 4 query rows per
// kv head an int8 row carries half the bytes of a bf16 row for the same
// arithmetic, and instructions come close to the bound too. B1's walk with
// int8 rows issued ~1,860 instructions per lane per 16-token tile (a byte
// extract, an I2F at a quarter of the FMA rate and a multiply per element;
// 64 q loads from shared memory; a warp max and two expf per row and
// lane), ~10 us at perfect issue over the 8B case's 5,114 tiles on 132
// SMs; neither a deeper ring nor longer splits moved its 0.0243 ms. This
// walk issues ~600:
//   1. The score on tensor cores, one scale per dot: s = ks_t * scale *
//      (q . k8_t). A warp's 16-token tile is the m16 of `mma.sync`
//      m16n8k16 (f16 in, f32 sums), the group's query rows its n8 (G <= 8;
//      rows past G are 0). Lane (g, t) = (lane / 4, lane % 4) reads tokens g
//      and g + 8 of the tile as 16-byte units; each 32-bit word of 4 int8
//      values becomes two f16x2 with one XOR, two byte permutes into 1024.0
//      and two HSUB2, exact for int8. The head dims are dealt to the mma's
//      k slots in the order these words fall in, and q's fragments follow
//      the same order: q is loaded once per CTA into 2 * D / 16 registers
//      of f16x2, scaled by a power of two 2^-e (|q| < 2^15 after it, so
//      every bf16 value is exact in f16 down to 2^-14; e goes back into the
//      f32 scale). K rows are stored with their 16-byte units XOR-swizzled
//      by the row's parity at D = 128, so each 8-lane phase of a read hits
//      distinct banks.
//   2. The softmax in the mma's accumulator layout: a lane holds two
//      tokens of two rows; a row's max is a local max and three shuffles;
//      6 exponentials a lane and tile (__expf, ex2.approx), not 2 * MG
//      expf; l stays per lane until the end of the split.
//   3. V's scale in P: P' = p * vs_t is written to shared memory with each
//      row's rescale factor; in p.V lane l owns D / 32 head dims, and each
//      V element costs its conversion (a quarter XOR, a byte permute into
//      2^23 and an FADD, exact) and its MG FMAs, nothing else. P stays f32.
//   4. A ring of kStages = 4 int8 tiles a warp (4,224 bytes a stage at
//      D = 128: K and V rows, then the 16 tokens' K and V scales, each lane
//      copying one with a 4-byte cp.async), so three CTAs fit an SM; the
//      split from the wrapper's int8_split.
// On the card (H100 80GB HBM3, 700 W; PERF.md, section 6), a per-CTA
// timeline at the 8B case: ~1 us to read the block table and q, ~1.5 us
// waiting for the first tile behind every CTA's prefetches (they saturate
// the DRAM from the start), ~1.2 us a tile a warp with three warps a
// scheduler, and ~2 us to merge the warps after the slowest one. Rings of
// 2, 3 and 6 stages, splits of 2 to 16 pages and a partial per warp (no
// merge in the CTA, four times the splits in B1's combine) were no faster
// at the 8B case. It reached 0.0156-0.0161 ms a call from a CUDA graph at
// the 8B case (0.0198-0.0200 with a cold L2; B1 0.0282-0.0290 in the same
// runs; 0.0243 before), of which the walk 0.0126-0.0128 and B1's combine
// 0.0032, and 0.0185-0.0188 ms at B=1 and 16k (B1 0.0385-0.0389): 2.5x
// its 0.00645 ms bound at the 8B case.
//
// D = 256 (Gemma: MG 4 for Gemma-7B's and Gemma-2-9B's groups of 1 and 2,
// MG 8 for Gemma-2B's 8) keeps that design. What changes:
//   - A K row is 256 bytes, two whole bank cycles, so rows gq and gq + 1
//     meet the same banks as at 128: the same XOR of the 16-byte unit by
//     (r & 1) * 4 keeps an 8-lane phase on distinct banks.
//   - In p.V a lane owns 8 head dims, 8 bytes of a V row: two words.
//   - A stage is 2 * 16 * 256 + 128 = 8,320 bytes. Four of them a warp
//     would be 133,120 bytes a CTA and one CTA an SM; the ring is
//     kStagesD256 = 3 deep instead: 99,840 bytes, plus 2,176 of P' at
//     MG 8 (102,016), so two CTAs fit an SM. The end-of-split merge
//     takes 4 * 8 * 258 * 4 = 33,024 bytes of the ring.
//   - ptxas gives the MG 4 build 144 registers and MG 8 159 (acc is 8 MG
//     f32 a lane, q's fragments 32 words), no spills.
//   - int8_split gives D = 256 its own cap: 256 tokens a split.
// On the card (H100 80GB HBM3, 700 W; PERF.md, section 6) at Gemma-2-9B's
// kernel case (8 slots, 8 kv heads, lengths <= 8192): 0.0639 ms a call
// from a CUDA graph (cold L2 0.0646; bf16 B1 at D = 256 0.1070 in the same
// run), 1.7x its 0.0375 ms bound; 0.0533 with window 4096 and softcap 50;
// 0.0206-0.0208 at the served contexts (60-4,232 tokens). Without the
// swizzle it took 1.2-1.6% more; with a 4-deep ring, one CTA an SM,
// 26-44% more; with splits of 512 tokens 28-38% more at the served
// contexts (chip_smoke.py, report_int8_d256_variants and
// report_int8_d256_splits).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_split_walk.cuh"

namespace {
namespace int8_walk {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16;           // tokens per warp tile: the mma's m16
constexpr int kStages = 4;          // tiles in each warp's ring, D <= 128
constexpr int kStagesD256 = 3;      // at D = 256: two CTAs an SM
constexpr int kMaxGroup = 8;        // query heads per kv head: the mma's n8
constexpr int kMaxSplitPages = 64;  // block-table entries per split

// 4 bytes global -> shared, asynchronously; zero-fills when !ok.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

// Four int8 values (bytes 0..3 of w) as f16x2 pairs (0, 1) and (2, 3),
// exact: x + 128 goes into the low mantissa byte of 1024.0, and 1152.0
// comes off.
__device__ __forceinline__ void i8x4_to_f16x4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const __half2 bias = __halves2half2(__ushort_as_half(0x6480), __ushort_as_half(0x6480));
  uint32_t a = __byte_perm(u, 0x64646464u, 0x5140);
  uint32_t b = __byte_perm(u, 0x64646464u, 0x5342);
  const __half2 x = __hsub2(*reinterpret_cast<__half2*>(&a), bias);
  const __half2 y = __hsub2(*reinterpret_cast<__half2*>(&b), bias);
  lo = *reinterpret_cast<const uint32_t*>(&x);
  hi = *reinterpret_cast<const uint32_t*>(&y);
}

// Byte e of w (an int8 value) as f32, exact: x + 128 goes into the low
// mantissa byte of 2^23, and 2^23 + 128 comes off. `u` is w ^ 0x80808080.
__device__ __forceinline__ float i8_to_f32(uint32_t u, int e) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + e)) - 8388736.f;
}

// c += a * b: one m16n8k16 product, f16 in, f32 sums.
__device__ __forceinline__ void mma_f16(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int D, int MG>
struct Layout {
  static constexpr int kUnits = D / 16;          // 16-byte units per row
  // K unit u of row r at u ^ (r & 1) * kSwizzle. From D = 128 on, a row
  // spans a whole number of 128-byte bank cycles, so rows gq and gq + 1
  // meet the same banks unless one of them moves its units by half a
  // cycle (4 units); the XOR stays within the row's units.
  static constexpr int kSwizzle = D >= 128 ? 4 : 0;
  static constexpr int kCopies = kTile * kUnits / 32;  // units a lane copies of K (and V) a tile
  static constexpr int kHalves = D / 64;         // 16-byte reads a lane makes per K row
  static constexpr int kChunks = D / 16;         // k16 steps of the score
  static constexpr int kDims = D / 32;           // head dims a lane owns in p.V
  static constexpr int kVWords = (kDims + 3) / 4;  // 32-bit words of them in a V row
  static constexpr int kRing = D > 128 ? kStagesD256 : kStages;  // tiles in each warp's ring
  // A stage: K rows, V rows, then K and V scales of its 16 tokens.
  static constexpr int kStageBytes = 2 * kTile * D + 2 * kTile * 4;
  static constexpr int kRingBytes = kWarps * kRing * kStageBytes;
  // Per warp: P' of each token, then each row's rescale factor.
  static constexpr int kPBytes = kWarps * (kTile + 1) * MG * 4;
  static constexpr int kSmemBytes = kRingBytes + kPBytes;
  static_assert(MG % 4 == 0 && MG <= kMaxGroup, "MG is 4 or 8");
  static_assert(kStageBytes % 16 == 0, "stages hold 16-byte copies");
  // The end-of-split merge reuses the ring: m, l and acc of each warp.
  static_assert(kWarps * MG * (D + 2) * 4 <= kRingBytes, "ring too small");
};

// Partials of CTA (b, kh, split), in `part`, as B1's bf16 walk writes them:
// m[G] and l[G] at ((b * KVH + kh) * S + split) * 2G, then, after all CTAs'
// m and l, acc[G, D] at n_cta * 2G + ((b * KVH + kh) * S + split) * G * D.
template <int D, int MG>
__global__ void __launch_bounds__(kThreads, 2)
paged_split_walk_int8_kernel(const __nv_bfloat16* __restrict__ q,  // [B, H, D]
                             const int8_t* __restrict__ k_pages,   // [P, page, KVH, D]
                             const int8_t* __restrict__ v_pages,
                             const float* __restrict__ k_scales,   // [P, page, KVH]
                             const float* __restrict__ v_scales,
                             const int* __restrict__ block_tables,  // [B, MP]
                             const int* __restrict__ lengths,       // [B], new token included
                             float* __restrict__ part, int H, int KVH, int page_size,
                             int max_pages, int pages_per_split, float scale,
                             float softcap, int window) {
  using L = Layout<D, MG>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* p_all = reinterpret_cast<float*>(smem + L::kRingBytes);  // [kWarps, kTile + 1, MG]
  __shared__ int page_s[kMaxSplitPages];

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

  // Kept keys of this split: positions in [t_lo, t_hi).
  const int count = lengths[b];
  const int lo = window > 0 ? max(count - window, 0) : 0;
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

  // This split's block-table entries, so that no tile waits on a global
  // load before its copies can start.
  const int first_page = split * pages_per_split;
  for (int i = tid; i < min(pages_per_split, max_pages - first_page); i += kThreads)
    page_s[i] = max(block_tables[(size_t)b * max_pages + first_page + i], 0);

  // The mma's lane roles: group gq (a token row of K, a query row of q) and
  // thread tq within it.
  const int gq = lane >> 2;
  const int tq = lane & 3;

  // q's fragments, straight from global memory by every warp, before any
  // tile is asked for (behind the tiles' copies, q's loads would wait on a
  // saturated DRAM): chunk c = 4h + w takes, from lane (gq, tq), the 4 head
  // dims 16 (4h + tq) + 4w of row gq, as K's words fall (item 1 above).
  // Rows past G are 0.
  float qf[L::kChunks][4];
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c) {
    const int d = 16 * (4 * (c / 4) + tq) + 4 * (c % 4);
    if (gq < G) {
      const uint2 u = *reinterpret_cast<const uint2*>(
          q + ((size_t)b * H + (size_t)kh * G + gq) * D + d);
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      qf[c][0] = x.x;
      qf[c][1] = x.y;
      qf[c][2] = y.x;
      qf[c][3] = y.y;
    } else {
      qf[c][0] = qf[c][1] = qf[c][2] = qf[c][3] = 0.f;
    }
  }
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) amax = fmaxf(amax, fabsf(qf[c][j]));
  amax = warp_max(amax);
  // |q| * 2^-e < 2^15: every bf16 value of q is exact in f16 down to 2^-14.
  // (A q below 2^-86 everywhere scores 0 here; 2^-e stays finite.)
  const int e = amax > 0.f ? max(ilogbf(amax) - 14, -100) : 0;
  const float q_down = ldexpf(1.f, -e);
  const float q_scale = scale * ldexpf(1.f, e);  // the dot's f32 factor, before ks
  uint32_t qb[L::kChunks][2];
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c) {
    const __half2 x = __floats2half2_rn(qf[c][0] * q_down, qf[c][1] * q_down);
    const __half2 y = __floats2half2_rn(qf[c][2] * q_down, qf[c][3] * q_down);
    qb[c][0] = *reinterpret_cast<const uint32_t*>(&x);
    qb[c][1] = *reinterpret_cast<const uint32_t*>(&y);
  }

  unsigned char* my_ring = ring + warp * L::kRing * L::kStageBytes;
  float* p_s = p_all + warp * (kTile + 1) * MG;

  const int n_tiles = (t_hi - t_lo + kTile - 1) / kTile;
  const int my_tiles = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;

  // Start the copy of this warp's i-th tile into ring slot i % kRing;
  // called for i = 0, 1, 2, ... in turn. Lane l finds token l % 16's row
  // from its page and offset, which step by kWarps * kTile tokens a call
  // (no division in the walk); lanes then copy 16-byte units, neighbours on
  // neighbouring addresses, and each lane its token's K (lanes 0-15) or V
  // (16-31) scale. Always commits a group, empty or not.
  const int tok = lane & (kTile - 1);
  const int half = lane >> 4;
  int pg = (t_lo + warp * kTile + tok) / page_size - first_page;
  int pg_off = (t_lo + warp * kTile + tok) % page_size;
  auto issue = [&](int i) {
    if (i < my_tiles) {
      const int p = t_lo + (warp + i * kWarps) * kTile + tok;
      long long row = -1;  // the (token, kv head) row: D bytes of pages, one scale
      if (p < t_hi) row = ((long long)page_s[pg] * page_size + pg_off) * KVH + kh;
      for (pg_off += kWarps * kTile; pg_off >= page_size; pg_off -= page_size) ++pg;
      unsigned char* k_dst = my_ring + (i % L::kRing) * L::kStageBytes;
      unsigned char* v_dst = k_dst + kTile * D;
      float* s_dst = reinterpret_cast<float*>(v_dst + kTile * D);
#pragma unroll
      for (int j = 0; j < L::kCopies; ++j) {
        const int idx = lane + 32 * j;
        const int t = idx / L::kUnits;
        const int u = idx % L::kUnits;
        const long long r = __shfl_sync(0xffffffffu, row, t);
        const bool ok = r >= 0;
        const size_t off = ok ? (size_t)r * D + 16 * u : 0;
        cp_async16(k_dst + t * D + 16 * (u ^ ((t & 1) * L::kSwizzle)), k_pages + off, ok);
        cp_async16(v_dst + t * D + 16 * u, v_pages + off, ok);
      }
      cp_async4(s_dst + half * kTile + tok, (half ? v_scales : k_scales) + (row >= 0 ? row : 0),
                row >= 0);
    }
    cp_async_commit();
  };

  // Rows 2tq and 2tq + 1 of the accumulator layout: running max and the
  // lane's share of the sum.
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[MG][L::kDims];
#pragma unroll
  for (int g = 0; g < MG; ++g)
#pragma unroll
    for (int d = 0; d < L::kDims; ++d) acc[g][d] = 0.f;

  __syncthreads();  // page_s is written
#pragma unroll
  for (int i = 0; i < L::kRing - 1; ++i) issue(i);

  for (int i = 0; i < my_tiles; ++i) {
    issue(i + L::kRing - 1);
    cp_async_wait<L::kRing - 1>();
    __syncwarp();
    const unsigned char* k_st = my_ring + (i % L::kRing) * L::kStageBytes;
    const unsigned char* v_st = k_st + kTile * D;
    const float* ks_st = reinterpret_cast<const float*>(v_st + kTile * D);
    const float* vs_st = ks_st + kTile;
    const int n = min(kTile, t_hi - (t_lo + (warp + i * kWarps) * kTile));

    // Scores of tokens gq and gq + 8 against rows 2tq and 2tq + 1, two
    // accumulators to halve the mma chain.
    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const int sw = (gq & 1) * L::kSwizzle;  // rows gq and gq + 8 share a parity
#pragma unroll
    for (int h = 0; h < L::kHalves; ++h) {
      const int unit = (4 * h + tq) ^ sw;
      const uint4 r0 = *reinterpret_cast<const uint4*>(k_st + gq * D + 16 * unit);
      const uint4 r1 = *reinterpret_cast<const uint4*>(k_st + (gq + 8) * D + 16 * unit);
      const uint32_t w0[4] = {r0.x, r0.y, r0.z, r0.w};
      const uint32_t w1[4] = {r1.x, r1.y, r1.z, r1.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        uint32_t a[4];
        i8x4_to_f16x4(w0[w], a[0], a[2]);
        i8x4_to_f16x4(w1[w], a[1], a[3]);
        mma_f16(c[w & 1], a, qb[4 * h + w]);
      }
    }

    // Online softmax in the accumulator layout: sv[j] is token gq (j < 2)
    // or gq + 8 (j >= 2) against row 2tq + (j & 1). Every tile holds at
    // least one kept key (token 0), so m is finite after the first.
    const float f0 = q_scale * ks_st[gq];
    const float f1 = q_scale * ks_st[gq + 8];
    float sv[4] = {(c[0][0] + c[1][0]) * f0, (c[0][1] + c[1][1]) * f0,
                   (c[0][2] + c[1][2]) * f1, (c[0][3] + c[1][3]) * f1};
    const bool valid0 = gq < n;
    const bool valid1 = gq + 8 < n;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (softcap > 0.f) sv[j] = tanhf(sv[j] / softcap) * softcap;
      sv[j] = (j < 2 ? valid0 : valid1) ? sv[j] : kNegInf;
    }
    float pr[4], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(sv[r], sv[2 + r]);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      pr[r] = valid0 ? __expf(sv[r] - m_new) : 0.f;
      pr[2 + r] = valid1 ? __expf(sv[2 + r] - m_new) : 0.f;
      alpha[r] = __expf(m[r] - m_new);
      l[r] = l[r] * alpha[r] + pr[r] + pr[2 + r];
      m[r] = m_new;
    }
    // P' = p * vs of each token and row, and each row's rescale factor.
    if (2 * tq < MG) {
      const float v0 = vs_st[gq], v1 = vs_st[gq + 8];
      *reinterpret_cast<float2*>(p_s + gq * MG + 2 * tq) = make_float2(pr[0] * v0, pr[1] * v0);
      *reinterpret_cast<float2*>(p_s + (gq + 8) * MG + 2 * tq) =
          make_float2(pr[2] * v1, pr[3] * v1);
      if (gq == 0)
        *reinterpret_cast<float2*>(p_s + kTile * MG + 2 * tq) = make_float2(alpha[0], alpha[1]);
    }
    __syncwarp();

    // acc = acc * alpha + P' . V over the tile's tokens (P' is 0 and V zero
    // past the kept range). Lane l owns head dims [l * kDims, (l + 1) * kDims).
#pragma unroll
    for (int j = 0; j < MG / 4; ++j) {
      const float4 a4 = reinterpret_cast<const float4*>(p_s + kTile * MG)[j];
      const float al[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int d = 0; d < L::kDims; ++d) acc[4 * j + g][d] *= al[g];
    }
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      // The lane's kDims int8 values of V row t: 8 bytes (D = 256), 4
      // (128) or 2 (64), in kVWords words.
      uint32_t w[L::kVWords];
      if constexpr (L::kDims == 8) {
        const uint2 u = *reinterpret_cast<const uint2*>(v_st + t * D + 8 * lane);
        w[0] = u.x;
        w[1] = u.y;
      } else if constexpr (L::kDims == 4) {
        w[0] = *reinterpret_cast<const uint32_t*>(v_st + t * D + 4 * lane);
      } else {
        static_assert(L::kDims == 2, "D is 64, 128 or 256");
        w[0] = *reinterpret_cast<const uint16_t*>(v_st + t * D + 2 * lane);
      }
      float vf[L::kDims];
#pragma unroll
      for (int d = 0; d < L::kDims; ++d) vf[d] = i8_to_f32(w[d / 4] ^ 0x80808080u, d % 4);
#pragma unroll
      for (int j = 0; j < MG / 4; ++j) {
        const float4 x = reinterpret_cast<const float4*>(p_s + t * MG)[j];
        const float pt[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int d = 0; d < L::kDims; ++d)
            acc[4 * j + g][d] = fmaf(pt[g], vf[d], acc[4 * j + g][d]);
      }
    }
    __syncwarp();  // the slot and p_s are free for the next copy
  }
  cp_async_wait<0>();

  // A row's sum over the warp's 8 token groups; then the CTA's warps meet
  // once: each writes m, l and acc to the ring, and the CTA merges them in
  // warp order into this split's partial. A warp with no tile has l = 0
  // and adds nothing.
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
  __syncthreads();  // every warp is done with its ring
  float* w_m = reinterpret_cast<float*>(ring);  // [kWarps, MG]
  float* w_l = w_m + kWarps * MG;               // [kWarps, MG]
  float* w_acc = w_l + kWarps * MG;             // [kWarps, MG, D]
  if (gq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (2 * tq + r < G) {
        w_m[warp * MG + 2 * tq + r] = m[r];
        w_l[warp * MG + 2 * tq + r] = l[r];
      }
    }
  }
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    if (g < G) {
#pragma unroll
      for (int d = 0; d < L::kDims; ++d)
        w_acc[(warp * MG + g) * D + lane * L::kDims + d] = acc[g][d];
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
        const float x = expf(w_m[w * MG + g] - mm);
        ll += lw * x;
        aa += w_acc[(w * MG + g) * D + d] * x;
      }
    }
    part_acc[i] = aa;
    if (d == 0) {
      part_ml[g] = mm;
      part_ml[G + g] = ll;
    }
  }
}

}  // namespace int8_walk
}  // namespace
