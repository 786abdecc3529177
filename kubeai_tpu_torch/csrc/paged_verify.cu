// Paged speculative-verify attention for Hopper (sm_90a), bf16 in and out:
// a split page walk on tensor cores and a fixed-order combine.
//
// Replaces the Pallas TPU kernel in kubeai_tpu/ops/paged_attention.py:
// `_paged_verify_pallas` / `_paged_verify_kernel` (B3), entry
// `paged_verify_attention`. A window of K query tokens per slot (the last
// emitted token and K - 1 proposals) attends over the slot's resident K/V
// pages through its block table. Query k sits at position pos + k and sees
// the keys at positions <= pos + k, and > pos + k - window when a sliding
// window is set; the window's own K/V are already in the pages. GQA: the G
// query heads of one kv head and the K window tokens make R = K*G <= 64
// rows; row r is window token r / G and query head kh * G + r % G.
//
// What bounds it on this card: bytes. Each call reads every kept K/V byte
// of a slot once; R rows make about R flops per byte (20 at K=5, G=4), far
// below the ~295 where bf16 tensor cores become the limit, but at the f32
// CUDA-core peak (67 TFLOP/s) 20 flops a byte at 3.35 TB/s is already the
// whole of it. The least time is the K+V bytes the mask keeps over 3.35 TB/s
// (0.0133 ms at 8 slots x 8 kv heads x positions <= 2046). The earlier
// design, one CTA per (slot, kv head) walking B1's loop in f32, took 0.774
// ms there on an H100. What held it back, and what this design does:
//   1. Too few CTAs, one per (slot, kv head): 64 for 132 SMs. The grid is
//      (KVH, B, S): CTA s walks only the kept keys of block-table entries
//      [s * pps, (s + 1) * pps), with S and pps chosen by the wrapper from
//      shapes alone (fused_split, shared with B4: 8 splits of 4 pages, 512
//      CTAs, at 8 slots x 32 pages). Its keys are positions [t_lo, t_hi):
//      from query 0's window edge (0 without a window) to the last window
//      token, bounded by the block table (near max_seq_len a window reaches
//      past it; those keys do not exist, as in the TPU kernel). A CTA with
//      no key in that range writes an empty partial (m = NEG_INF, l = 0)
//      and exits. The split's block-table entries are read once into
//      shared memory.
//   2. No loads in flight during math, three barriers a 32-token tile: the
//      CTA's four warps share each 64-token K/V tile, streamed through a
//      ring in dynamic shared memory with 16-byte cp.async, zero-filled
//      outside [t_lo, t_hi) (P is 0 there, and 0 * garbage could be NaN);
//      tiles i + 1 and i + 2 load while tile i is computed. The ring holds
//      three tiles where two CTAs an SM still fit (109 KiB a CTA at D=128,
//      R <= 24), else two. K and V rows are not padded but swizzled (chunk
//      c of token t at c ^ (t % 8)), so every ldmatrix phase hits distinct
//      banks with no bytes lost. q is copied with the first tile.
//   3. All math in f32 on CUDA cores. Both products now run on tensor
//      cores, mma.sync.m16n8k16 with bf16 operands and f32 accumulators fed
//      by ldmatrix, with tokens and head dims on the M side so that R rows
//      pad to a multiple of 8 (NT n8 tiles), not 16:
//        scores: warp w computes S^T for its 16 tokens of the tile against
//          all rows, K as A and the unscaled bf16 q (staged once, rows
//          padded by 16 bytes against bank conflicts) as B; the f32 scores
//          are scaled after the product, so q.k is exact in the accumulator
//          as in the f32 plain version;
//        softmax: a row's tile max meets across the four warps through
//          shared memory, so m is the same in every warp; l stays a per-lane
//          partial, reduced once per split. Each row has its own causal edge
//          pos + r/G and window edge; a masked entry gets P = 0 explicitly;
//        P.V: P goes to shared memory as [token, row] in two bf16 parts,
//          hi = bf16(p) and lo = bf16(p - hi), and warp w computes O^T for
//          its D/4 head dims, V^T through ldmatrix.trans as A and P^T as B,
//          once for each part. hi alone puts up to 2^-8 of relative error
//          on each weight: in the CPU emulation of this algorithm
//          (tests/test_torch_paged_verify.py) that moves rows averaging a
//          few values by up to 3.2e-3, above the 2e-3 atol the card's check
//          holds small outputs to; hi + lo keeps P to about 2^-16 (6e-6).
//      The O accumulator is (D/64) x NT x 4 f32 a lane (24 at D=128,
//      R=20; 64 at R=64) and sits in the same lane columns as the scores,
//      so the online-softmax rescale needs no data movement.
// Combine: a second kernel, one warp per (slot, kv head, row), merges the
// S f32 partials (m, l, acc) in split order, the loads of every split's
// acc in flight at once. No atomics: two calls give the same bits. A split
// where the row has no kept key (l = 0) adds nothing; a row masked in every
// split writes 0, as the TPU kernel's zero_masked_p does. The partials live
// in scratch the wrapper allocates; the kernels allocate nothing.
// Together the two take 0.038 ms at the case above, from a CUDA graph on an
// H100 at 700 W (chip_smoke.py): the walk 0.034 ms, the combine 0.004.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;           // tokens per tile; 16 a warp in the scores
constexpr int kMaxRows = 64;        // K * G rows per kv head
constexpr int kMaxSplitPages = 64;  // block-table entries per split
constexpr float kNegInf = -1e30f;   // the JAX package's finite NEG_INF
// Shared memory of one SM (228 KB) and what the card keeps of it per CTA.
constexpr int kSmemPerSm = 233472;
constexpr int kSmemReservedPerCta = 1024;

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8, and register j holds matrix j (row lane / 4, columns 2 (lane % 4)
// and the next).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a . b, m16n8k16, bf16 in, f32 accumulators. c0, c1: row lane / 4,
// columns 2 (lane % 4) and the next; c2, c3: the same columns, row + 8.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The partials: m[R], l[R] of every CTA (b, kh, split), then acc[R, D] of
// every CTA, from the first multiple of 4 floats so that a lane reads its
// head dims of acc as one float4.
__device__ __forceinline__ size_t acc_region(size_t n_cta, int R) {
  return (n_cta * 2 * R + 3) & ~size_t(3);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_half, float hi_half) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo_half, hi_half);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int D, int NT>
struct Layout {
  static constexpr int kRows = NT * 8;        // R padded to n8 tiles
  static constexpr int kChunks = D / 8;       // 16-byte chunks per token row
  static constexpr int kQStride = D + 8;      // padded q row, in bf16
  static constexpr int kPStride = (NT | 1) * 8;  // P row: an odd number of 16 B
  static constexpr int kMTiles = D / 64;      // m16 tiles of a warp's D/4 dims
  static constexpr int kStageElems = 2 * kTile * D;  // K then V, swizzled
  static constexpr int kQBytes = kRows * kQStride * 2;
  static constexpr int kPBytes = 2 * kTile * kPStride * 2;  // hi, lo
  static constexpr int kRedBytes = kWarps * kRows * 4;
  static constexpr int kFixedBytes = kQBytes + kPBytes + kRedBytes;
  // Three tiles in the ring where two CTAs an SM still fit (every R at
  // D=64, R <= 24 at D=128), else two.
  static constexpr int kStages =
      2 * (kFixedBytes + 3 * kStageElems * 2 + kMaxSplitPages * 4 + kSmemReservedPerCta) <=
              kSmemPerSm
          ? 3
          : 2;
  static constexpr int kSmemBytes = kFixedBytes + kStages * kStageElems * 2;
  // Element offset of 16-byte chunk c of token t in a K or V tile: chunk
  // c ^ (t % 8), so the 8 rows of every ldmatrix phase and of every
  // cp.async quarter-warp hit 8 distinct 16-byte bank groups.
  __device__ static __forceinline__ int at(int t, int c) { return t * D + ((c ^ (t & 7)) << 3); }
};

template <int D, int NT>
__global__ void __launch_bounds__(kThreads, 2)
paged_verify_split_kernel(const __nv_bfloat16* __restrict__ q,        // [B, K, H, D]
                          const __nv_bfloat16* __restrict__ k_pages,  // [P, page, KVH, D]
                          const __nv_bfloat16* __restrict__ v_pages,
                          const int* __restrict__ block_tables,       // [B, MP]
                          const int* __restrict__ positions,          // [B]
                          float* __restrict__ part,                   // partials, see below
                          int K, int H, int KVH, int page_size, int max_pages,
                          int pages_per_split, float scale, float softcap, int window) {
  using L = Layout<D, NT>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [kRows, kQStride]
  __nv_bfloat16* p_hi = reinterpret_cast<__nv_bfloat16*>(smem + L::kQBytes);  // [kTile, kPStride]
  __nv_bfloat16* p_lo = p_hi + kTile * L::kPStride;
  float* red = reinterpret_cast<float*>(smem + L::kQBytes + L::kPBytes);  // [kWarps, kRows]
  __nv_bfloat16* ring =
      reinterpret_cast<__nv_bfloat16*>(smem + L::kQBytes + L::kPBytes + L::kRedBytes);
  __shared__ int page_s[kMaxSplitPages];

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int S = gridDim.z;
  const int G = H / KVH;
  const int R = K * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;  // the accumulator row this lane holds (and + 8)
  const int tig = lane & 3;   // its column pair: 2 tig, 2 tig + 1
  // Partials of CTA (b, kh, split): m[R], l[R] in the first region, acc[R, D]
  // in the second.
  const size_t cta = ((size_t)b * KVH + kh) * S + split;
  const size_t n_cta = (size_t)gridDim.y * KVH * S;
  float* part_ml = part + cta * 2 * R;
  float* part_acc = part + acc_region(n_cta, R) + cta * R * D;

  // Keys of this split: positions [t_lo, t_hi).
  const int pos = positions[b];
  const int lo = window > 0 ? max(pos + 1 - window, 0) : 0;
  const int first_page = split * pages_per_split;
  const int t_lo = max(first_page * page_size, lo);
  const int t_hi = min(min((first_page + pages_per_split) * page_size, pos + K),
                       max_pages * page_size);
  if (t_lo >= t_hi) {
    for (int r = tid; r < R; r += kThreads) {
      part_ml[r] = kNegInf;
      part_ml[R + r] = 0.f;
    }
    return;
  }

  for (int i = tid; i < min(pages_per_split, max_pages - first_page); i += kThreads)
    page_s[i] = max(block_tables[(size_t)b * max_pages + first_page + i], 0);
  // q rows, unscaled bf16, copied with tile 0 (the first commit below);
  // rows R.. are zero-filled and never kept.
  for (int i = tid; i < L::kRows * L::kChunks; i += kThreads) {
    const int r = i / L::kChunks;
    const int c = i - r * L::kChunks;
    const size_t src =
        r < R ? (((size_t)b * K + r / G) * H + (size_t)kh * G + r % G) * D + c * 8 : 0;
    cp_async16(q_s + r * L::kQStride + c * 8, q + src, r < R);
  }

  const size_t tok_stride = (size_t)KVH * D;
  const int n_tiles = (t_hi - t_lo + kTile - 1) / kTile;

  // Start the copy of tile i into ring slot i % kStages (an empty group
  // past the last tile). Thread tid copies chunk tid % kChunks of tokens
  // tid / kChunks, + kThreads / kChunks, ...
  auto issue = [&](int i) {
    if (i < n_tiles) {
      __nv_bfloat16* k_dst = ring + (i % L::kStages) * L::kStageElems;
      __nv_bfloat16* v_dst = k_dst + kTile * D;
      const int c = tid % L::kChunks;
      const int t0 = t_lo + i * kTile;
#pragma unroll
      for (int t = tid / L::kChunks; t < kTile; t += kThreads / L::kChunks) {
        const int ta = t0 + t;
        const bool ok = ta < t_hi;
        size_t off = 0;
        if (ok) {
          const int p = ta / page_size;
          off = ((size_t)page_s[p - first_page] * page_size + (ta - p * page_size)) *
                    tok_stride + (size_t)kh * D + c * 8;
        }
        cp_async16(k_dst + L::at(t, c), k_pages + off, ok);
        cp_async16(v_dst + L::at(t, c), v_pages + off, ok);
      }
    }
    cp_async_commit();
  };

  // This lane's columns: row nt * 8 + 2 tig + j is column 2 nt + j. Its
  // last visible key, pos + row / G (-1 for the padding rows).
  int q_abs[2 * NT];
  float m[2 * NT], l[2 * NT];
#pragma unroll
  for (int c = 0; c < 2 * NT; ++c) {
    const int r = (c >> 1) * 8 + 2 * tig + (c & 1);
    q_abs[c] = r < R ? pos + r / G : -1;
    m[c] = kNegInf;
    l[c] = 0.f;
  }
  float o[L::kMTiles][NT][4];
#pragma unroll
  for (int mt = 0; mt < L::kMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][nt][e] = 0.f;

  __syncthreads();  // page_s is written
#pragma unroll
  for (int i = 0; i < L::kStages - 1; ++i) issue(i);

  const int dw = warp * (D / 4);  // this warp's head dims in P.V
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<L::kStages - 2>();
    __syncthreads();  // tile i has landed; every warp is done with tile i - 1
    issue(i + L::kStages - 1);
    const __nv_bfloat16* k_st = ring + (i % L::kStages) * L::kStageElems;
    const __nv_bfloat16* v_st = k_st + kTile * D;

    // Scores S^T[token, row] for this warp's 16 tokens.
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, k_st + L::at(warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                              ks * 2 + (lane >> 4)));
#pragma unroll
      for (int nt = 0; nt + 1 < NT; nt += 2) {
        uint32_t bq[4];
        ldsm_x4(bq, q_s + ((nt + (lane >> 4)) * 8 + (lane & 7)) * L::kQStride + ks * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(s[nt], a, bq);
        mma_bf16(s[nt + 1], a, bq + 2);
      }
      if (NT & 1) {
        uint32_t bq[2];
        ldsm_x2(bq, q_s + ((NT - 1) * 8 + (lane & 7)) * L::kQStride + ks * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(s[NT - 1], a, bq);
      }
    }

    // Scale, softcap, mask; this warp's max of each row over its tokens.
    const int tok = t_lo + i * kTile + warp * 16 + gid;  // entries e < 2; +8 for e >= 2
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 2 * nt + (e & 1);
        const int t = tok + (e >> 1) * 8;
        float x = s[nt][e] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        const bool ok = t < t_hi && t <= q_abs[c] && (window <= 0 || t > q_abs[c] - window);
        s[nt][e] = ok ? x : kNegInf;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float mx = fmaxf(s[nt][j], s[nt][j + 2]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        if (gid == 0) red[warp * L::kRows + nt * 8 + 2 * tig + j] = mx;
      }
    }
    __syncthreads();  // every warp's maxima are in red

    // The tile's max of each row, the same in every warp; P, split in two
    // bf16 parts, to shared memory as [token, row].
    float alpha[2 * NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 2 * nt + j;
        const int r = nt * 8 + 2 * tig + j;
        float tm = red[r];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) tm = fmaxf(tm, red[w * L::kRows + r]);
        const float m_new = fmaxf(m[c], tm);
        alpha[c] = expf(m[c] - m_new);
        m[c] = m_new;
      }
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 2 * nt + (e & 1);
        // A masked entry is exactly kNegInf; its P is 0, not exp(0) when
        // the whole row is masked so far.
        p[e] = s[nt][e] == kNegInf ? 0.f : expf(s[nt][e] - m[c]);
      }
      l[2 * nt] = l[2 * nt] * alpha[2 * nt] + p[0] + p[2];
      l[2 * nt + 1] = l[2 * nt + 1] * alpha[2 * nt + 1] + p[1] + p[3];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = warp * 16 + gid + h * 8;
        const float a0 = p[2 * h], a1 = p[2 * h + 1];
        const float h0 = __bfloat162float(__float2bfloat16_rn(a0));
        const float h1 = __bfloat162float(__float2bfloat16_rn(a1));
        const int at = t * L::kPStride + nt * 8 + 2 * tig;
        *reinterpret_cast<uint32_t*>(p_hi + at) = pack_bf16(h0, h1);
        *reinterpret_cast<uint32_t*>(p_lo + at) = pack_bf16(a0 - h0, a1 - h1);
      }
    }
#pragma unroll
    for (int mt = 0; mt < L::kMTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][nt][e] *= alpha[2 * nt + (e & 1)];
    __syncthreads();  // P of every warp's tokens is in shared memory

    // O^T[dim, row] += V^T . P^T over the tile's 64 tokens, for this
    // warp's head dims; P's hi and lo parts are two products.
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      uint32_t a[L::kMTiles][4];
#pragma unroll
      for (int mt = 0; mt < L::kMTiles; ++mt)
        ldsm_x4_t(a[mt], v_st + L::at(ks * 16 + (lane & 7) + (lane >> 4) * 8,
                                      (dw + mt * 16) / 8 + ((lane >> 3) & 1)));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bp[4];
        ldsm_x4_t(bp, ((lane >> 4) ? p_lo : p_hi) +
                          (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L::kPStride +
                          nt * 8);
#pragma unroll
        for (int mt = 0; mt < L::kMTiles; ++mt) {
          mma_bf16(o[mt][nt], a[mt], bp);
          mma_bf16(o[mt][nt], a[mt], bp + 2);
        }
      }
    }
  }
  cp_async_wait<0>();

  // The split's partial: m is the same in every warp; l is summed over the
  // lanes of a column, then over the warps in order; each warp writes the
  // acc of its own head dims.
#pragma unroll
  for (int c = 0; c < 2 * NT; ++c) {
    l[c] += __shfl_xor_sync(0xffffffffu, l[c], 4);
    l[c] += __shfl_xor_sync(0xffffffffu, l[c], 8);
    l[c] += __shfl_xor_sync(0xffffffffu, l[c], 16);
  }
  __syncthreads();  // every warp is done reading red
  if (gid == 0) {
#pragma unroll
    for (int c = 0; c < 2 * NT; ++c)
      red[warp * L::kRows + (c >> 1) * 8 + 2 * tig + (c & 1)] = l[c];
  }
  __syncthreads();
  if (warp == 0 && gid == 0) {
#pragma unroll
    for (int c = 0; c < 2 * NT; ++c) {
      const int r = (c >> 1) * 8 + 2 * tig + (c & 1);
      if (r < R) {
        float ll = red[r];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) ll += red[w * L::kRows + r];
        part_ml[r] = m[c];
        part_ml[R + r] = ll;
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < L::kMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = nt * 8 + 2 * tig + (e & 1);
        const int d = dw + mt * 16 + gid + (e >> 1) * 8;
        if (r < R) part_acc[(size_t)r * D + d] = o[mt][nt][e];
      }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One warp per (slot, kv head, row r), kCombineRows rows a CTA. Lane i
// holds the (m, l) of splits i, i + 32, ...; the row's max over the splits
// with a kept key (l > 0) and its sum l are butterfly reductions, and lane
// i then adds head dims [i * D/32, (i + 1) * D/32) of every split's acc in
// split order, with all the loads issued at once. A split where the row
// keeps no key has weight 0 and its acc, never written, is read but not
// used. The order is fixed, so two calls give the same bits.
constexpr int kCombineRows = 4;

template <int D>
__global__ void __launch_bounds__(kCombineRows * 32)
paged_verify_combine_kernel(const float* __restrict__ part,
                            __nv_bfloat16* __restrict__ out,  // [B, K, H, D]
                            int K, int H, int KVH, int S) {
  constexpr int kDims = D / 32;  // 4 or 2 head dims a lane
  using Vec = typename std::conditional<kDims == 4, float4, float2>::type;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.z * kCombineRows + (threadIdx.x >> 5);
  const int G = H / KVH;
  const int R = K * G;
  if (r >= R) return;
  const size_t cta0 = ((size_t)b * KVH + kh) * S;
  const size_t n_cta = (size_t)gridDim.y * KVH * S;
  const float* ml = part + cta0 * 2 * R + r;  // split s: m at s * 2R, l at + R
  const float* acc = part + acc_region(n_cta, R) + cta0 * R * D + (size_t)r * D + lane * kDims;

  float mx = kNegInf;
  for (int s = lane; s < S; s += 32)
    if (ml[(size_t)s * 2 * R + R] > 0.f) mx = fmaxf(mx, ml[(size_t)s * 2 * R]);
  mx = warp_max(mx);
  float ll = 0.f;
  float aa[kDims] = {};
  for (int s0 = 0; s0 < S; s0 += 32) {
    float w = 0.f;
    if (s0 + lane < S) {
      const float ls = ml[(size_t)(s0 + lane) * 2 * R + R];
      w = ls > 0.f ? expf(ml[(size_t)(s0 + lane) * 2 * R] - mx) : 0.f;
      ll += ls * w;
    }
#pragma unroll 8
    for (int j = 0; j < min(32, S - s0); ++j) {
      const float wj = __shfl_sync(0xffffffffu, w, j);
      const Vec a = *reinterpret_cast<const Vec*>(acc + (size_t)(s0 + j) * R * D);
      const float* af = reinterpret_cast<const float*>(&a);
#pragma unroll
      for (int e = 0; e < kDims; ++e) aa[e] += wj > 0.f ? af[e] * wj : 0.f;
    }
  }
  ll = warp_sum(ll);
  // No kept key in any split: ll = aa = 0 and the row writes 0.
  const float inv = 1.f / fmaxf(ll, 1e-30f);
  __nv_bfloat16* o =
      out + (((size_t)b * K + r / G) * H + (size_t)kh * G + r % G) * D + lane * kDims;
#pragma unroll
  for (int e = 0; e < kDims; e += 2)
    *reinterpret_cast<__nv_bfloat162*>(o + e) = __floats2bfloat162_rn(aa[e] * inv, aa[e + 1] * inv);
}

template <int D, int NT>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* kp, const __nv_bfloat16* vp,
           const int* bt, const int* ps, __nv_bfloat16* out, float* part, int B, int K,
           int H, int KVH, int page_size, int max_pages, int num_splits,
           int pages_per_split, float scale, float softcap, int window, cudaStream_t s) {
  constexpr int kSmem = Layout<D, NT>::kSmemBytes;
  static bool attr_set = false;  // idempotent; a race sets it twice
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_verify_split_kernel<D, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  paged_verify_split_kernel<D, NT><<<dim3(KVH, B, num_splits), kThreads, kSmem, s>>>(
      q, kp, vp, bt, ps, part, K, H, KVH, page_size, max_pages, pages_per_split, scale,
      softcap, window);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rows = K * (H / KVH);
  paged_verify_combine_kernel<D>
      <<<dim3(KVH, B, (rows + kCombineRows - 1) / kCombineRows), kCombineRows * 32, 0, s>>>(
          part, out, K, H, KVH, num_splits);
  return (int)cudaGetLastError();
}

template <int D>
int launch_rows(const __nv_bfloat16* q, const __nv_bfloat16* kp, const __nv_bfloat16* vp,
                const int* bt, const int* ps, __nv_bfloat16* out, float* part, int B,
                int K, int H, int KVH, int page_size, int max_pages, int num_splits,
                int pages_per_split, float scale, float softcap, int window,
                cudaStream_t s) {
  // One build per bound on the rows: R padded to 8, 16, 24, 32, 48 or 64.
  const int nt = (K * (H / KVH) + 7) / 8;
#define KUBEAI_VERIFY_LAUNCH(NT_)                                                     \
  return launch<D, NT_>(q, kp, vp, bt, ps, out, part, B, K, H, KVH, page_size,        \
                        max_pages, num_splits, pages_per_split, scale, softcap, window, \
                        s)
  if (nt <= 1) KUBEAI_VERIFY_LAUNCH(1);
  if (nt <= 2) KUBEAI_VERIFY_LAUNCH(2);
  if (nt <= 3) KUBEAI_VERIFY_LAUNCH(3);
  if (nt <= 4) KUBEAI_VERIFY_LAUNCH(4);
  if (nt <= 6) KUBEAI_VERIFY_LAUNCH(6);
  KUBEAI_VERIFY_LAUNCH(8);
#undef KUBEAI_VERIFY_LAUNCH
}

}  // namespace

// Launches two kernels on `stream` (PyTorch's current stream): the split
// walk, then the combine. `scratch` holds B * KVH * num_splits * K * G *
// (D + 2) + 3 floats, allocated by the caller; the kernels allocate nothing.
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for a shape the kernels do not take.
extern "C" int kubeai_paged_verify_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* positions, void* out, void* scratch,
    int B, int K, int H, int KVH, int D, int page_size, int max_pages,
    int num_splits, int pages_per_split, float scale, float softcap, int window,
    void* stream) {
  if (B <= 0) return 0;
  if (K <= 0 || KVH <= 0 || H % KVH != 0 || K * (H / KVH) > kMaxRows ||
      page_size <= 0 || max_pages <= 0 || num_splits <= 0 || pages_per_split <= 0 ||
      pages_per_split > kMaxSplitPages ||
      (long long)num_splits * pages_per_split < max_pages ||
      (long long)(max_pages + pages_per_split) * page_size > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k_pages);
  const auto* vp = static_cast<const __nv_bfloat16*>(v_pages);
  const auto* bt = static_cast<const int*>(block_tables);
  const auto* ps = static_cast<const int*>(positions);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* part = static_cast<float*>(scratch);
  if (D == 128)
    return launch_rows<128>(qp, kp, vp, bt, ps, op, part, B, K, H, KVH, page_size,
                            max_pages, num_splits, pages_per_split, scale, softcap,
                            window, s);
  if (D == 64)
    return launch_rows<64>(qp, kp, vp, bt, ps, op, part, B, K, H, KVH, page_size,
                           max_pages, num_splits, pages_per_split, scale, softcap,
                           window, s);
  return (int)cudaErrorInvalidValue;
}
