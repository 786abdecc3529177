// Causal flash attention for prefill on Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas TPU kernel in kubeai_tpu/ops/pallas_attention.py:
// `_flash_bhsd` / `_flash_kernel` (B2), entry `flash_causal_prefill`.
// Causal self-attention over a prompt, q [B, S, H, D] against k, v
// [B, S, KVH, D]; q head h reads kv head h / (H / KVH). D is 64, 128 or
// 256 (Gemma).
//
// What bounds it on this card: at long S, tensor-core flops. The causal
// product does about 2 * 2 * B * H * S^2 / 2 * D flops against
// 2 * B * S * (H + 2 * KVH) * D bytes, i.e. ~S/2 flops per byte: above
// the ~295 flops/byte ridge once S passes a few hundred tokens. At short
// S it is bound by bytes.
//
// The first port of this kernel (WMMA 16x16x16, an f32 output tile in
// 113 KB of shared memory, plain loads then __syncthreads, 4 warps a CTA)
// ran at about 39 TFLOP/s at B=4, S=1024 on an H100, 4% of the 989 peak.
// This one keeps every product on Hopper's tensor cores through wgmma
// with the accumulators in registers, and keeps loads in flight during
// the math:
//
// - Grid (H, B, q blocks), the q blocks in reverse order, so that the
//   longest causal walks start first. A CTA owns kBQ = 128 query rows of
//   one head and is three warpgroups: a producer and two consumers of 64
//   rows each. The producer gives up registers (setmaxnreg.dec) and one
//   of its threads issues TMA: Q once, then the kBK-key K and V tiles of
//   kv head h / group up to the causal frontier (tiles past it are never
//   loaded) into a 2-stage ring (kBK is 128, and 64 at D = 256), each
//   stage with a full mbarrier for K, one for V and an empty one the
//   consumer warps arrive on. The consumers take the registers
//   (setmaxnreg.inc): 232 a thread.
// - S = Q K^T: each consumer its own 64 rows, wgmma m64n128k16 (m64n64k16
//   at D = 256) with Q and K in shared memory, both K-major, D / 16
//   k-steps; the kBK / 2 f32 scores a thread stay in registers. So every
//   query row's score against every key it needs is computed once, and
//   every K/V tile taken from L2 serves the block's 128 rows.
// - Online softmax in registers in the log2 domain (exp2 with the scale
//   folded into log2(e)), the row max and sum over the 4 lanes that share
//   a row; the JAX kernel's finite NEG_INF and max(l, 1e-30). Only the
//   tile that crosses the diagonal applies the q_pos >= k_pos mask. A
//   consumer computes no tile whose keys all lie past its last row below
//   S (at D = 256, consumer 0's last tile of each block), and none at all
//   if its rows all lie at or past S; it still waits for each such tile
//   and arrives on its empty barrier, so the ring turns. Rows past S that
//   share a consumer with rows below it are computed on the zeros TMA
//   fills in and not written; keys at or past S are masked by causality.
// - O += P V: P converted to bf16 in registers is the A operand (the
//   score accumulator layout is wgmma's A-fragment layout), V enters as
//   an MN-major B operand through the descriptor's transpose bit, 128 of
//   O's columns a wgmma; O stays whole in each consumer's registers in
//   f32: 128 f32 a thread at D = 256, beside its 32 scores. ptxas
//   compiles the 384-thread CTA for 168 registers a thread at launch and
//   allocates the consumer path, which runs only after setmaxnreg.inc,
//   within 232 (the D = 256 build names up to R183 there), as long as no
//   trap lies on that path (hopper.cuh's mbar_wait); no build spills.
// - At D = 256 the consumers take turns issuing Q K^T (kPingPong).
// - Epilogue: O / l as bf16 into the consumer's own rows of Q's shared
//   memory (no other warpgroup reads them) in the map's swizzle, then one
//   TMA store per 64-column box, which clips the rows past S.
// - Shared memory: Q (128 rows) 32 KB and 2 x (K + V) 128 KB at D = 128;
//   at D = 256 Q 64 KB and 2 x (K + V) of 64 keys 128 KB (128-key tiles
//   would need 320 KB). No output tile. Every tile uses the 128-byte
//   swizzle, in the TMA maps and in the wgmma descriptors; a tile is
//   D / 64 boxes of 64 columns. The rank-4 (D, heads, S, B) maps are
//   built on the host for each call and passed as __grid_constant__
//   parameters, so a CUDA graph captures them with the launch, and a box
//   never crosses into the next batch row.
//
// What bounds the D = 256 build at Gemma's long prompts: tensor-core
// flops (5.5e11 for the causal product at B=1, S=8192, 16 heads; about
// 62% of the card's peak reached there), and behind them the K/V tiles
// each CTA takes from L2 (4.4 GB there). At S <= 512 the grid has fewer
// CTAs than the card has SMs (64 for 16 heads at 512), and each walks
// twice the rows of a 64-row block: there latency bounds it.
//
// Left for later: overlapping one consumer's softmax with its own next
// GEMMs (the registers allow S of two tiles at D = 256), K/V tiles
// multicast to a cluster of q blocks, a persistent grid.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 2;  // consumer warpgroups
// Query rows per CTA: 64 per consumer warpgroup.
constexpr int kBQ = 128;
// Keys per K/V tile: 128, or 64 at D = 256, where two stages of 128-key
// K and V tiles (256 KB) would pass the 227 KB a block may have.
template <int D>
constexpr int kBK = D == 256 ? 64 : 128;
// O's columns per P.V wgmma: all of them, or 128 at D = 256 (two wgmmas
// a k-step over O kept whole).
template <int D>
constexpr int kPVN = D < 128 ? D : 128;
constexpr int kStages = 2;     // K/V tiles in flight
// FA3's ping-pong at D = 256: the two consumers take turns issuing Q K^T
// (named barriers kTurnBar + c, 256 threads), so that one's softmax runs
// beside the other's products (3-4% off at S 200-1024 on an H100, none
// measurable at 8192).
template <int D>
constexpr bool kPingPong = D == 256;
constexpr int kTurnBar = 1 + kConsumers;
constexpr int kThreads = 128 * (1 + kConsumers);  // warpgroup 0 produces
// setmaxnreg: the producer gives registers up, the consumers take them
// (40 * 128 + 232 * 256 <= 65536).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kBox = 64;       // bf16 columns per TMA box (128-byte swizzle)
constexpr float kNegInf = -1e30f;  // the JAX package's finite NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// Byte offsets from the 1024-byte-aligned base of dynamic shared memory.
// Every tile is [D / 64 column boxes][rows][128 bytes], swizzled.
template <int D>
struct Smem {
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK<D> * D * 2;  // one K or V tile
  static constexpr int q = 0;
  static constexpr int k = q + kQBytes;
  static constexpr int v = k + kStages * kKVBytes;
  static constexpr int bars = v + kStages * kKVBytes;
  // q_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr int bytes = bars + 8 * (1 + 3 * kStages) + 1024;
  static_assert(bytes <= 232448, "a block has at most 227 KB of shared memory");
};

// ---- TMA -------------------------------------------------------------------

// One box {64 columns, 1 head, rows, 1 batch row} of a rank-4 (D, heads,
// S, B) map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head, int row,
                                         int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(row), "r"(batch),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int col,
                                          int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// d[64] (+)= A(smem, K-major) * B(smem, K-major), m64n128k16; scale_d = 0
// overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[32] (+)= A(smem, K-major) * B(smem, K-major), m64n64k16: the score
// tile of 64 keys at D = 256.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// S (+)= Q K^T over one k16 step: BK keys, BK / 2 scores a thread.
template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&s)[BK / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (BK == 128) {
    wgmma_ss_n128(s, da, db, scale_d);
  } else {
    static_assert(BK == 64, "a key tile is 64 or 128 keys");
    wgmma_ss_n64(s, da, db, scale_d);
  }
}

// d[64] += A(registers) * B(smem, MN-major), m64n128k16.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[32] += A(registers) * B(smem, MN-major), m64n64k16.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V over one k16 step, for N of O's columns.
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&o)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 128) {
    wgmma_rs_n128(o, a, db);
  } else {
    wgmma_rs_n64(o, a, db);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the online softmax on one score tile ------------------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// s: this thread's N raw scores of the tile in wgmma's accumulator layout
// (entry i: row `row` + 8 * ((i >> 1) & 1), key `key0` + 8 * (i >> 2) +
// (i & 1)). Turns s into P = exp2(s * sl2 - m_new) in place, with m in
// the log2 domain, updates m and the thread's partial l, and returns
// alpha = exp2(m_old - m_new) per row. The row max is taken on the raw
// scores (sl2 > 0 keeps their order), so the scale folds into one FFMA.
template <bool kMask, int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float sl2, int row,
                                             int key0) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (kMask && key0 + 8 * (i >> 2) + (i & 1) > row + 8 * ((i >> 1) & 1)) s[i] = kNegInf;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * sl2);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = ex2(fmaf(s[i], sl2, -m[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap q_map,  // box kBQ rows
                     const __grid_constant__ CUtensorMap k_map,  // box kBK<D> rows
                     const __grid_constant__ CUtensorMap v_map,  // box kBK<D> rows
                     const __grid_constant__ CUtensorMap o_map,  // box 64 rows
                     int S, int group, float sl2) {
  using L = Smem<D>;
  constexpr int BQ = kBQ;
  constexpr int BK = kBK<D>;
  constexpr int PVN = kPVN<D>;
  constexpr int kHalves = D / kBox;
  constexpr int kRowBytes = kBox * 2;  // one swizzled row of a half
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base + L::q;
  const uint32_t k_s = base + L::k;
  const uint32_t v_s = base + L::v;
  const uint32_t q_full = base + L::bars;
  const uint32_t k_full = q_full + 8;            // + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;  // + 8 * stage
  const uint32_t empty = v_full + 8 * kStages;   // + 8 * stage

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  // The warpgroup index, broadcast from lane 0 so that ptxas knows it is
  // warp-uniform (CUTLASS's canonical_warp_group_idx).
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  // Key tiles up to the causal frontier of the block's last row below S.
  const int n_kt = (min(q0 + BQ, S) + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(empty + 8 * st, 4 * kConsumers);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid != 0) return;
    const int kvh = h / group;
    mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf)
      tma_load(q_s + hf * BQ * kRowBytes, &q_map, q_full, hf * kBox, h, q0, b);
    for (int t = 0; t < n_kt; ++t) {
      const int st = t % kStages;
      // The consumers released the tile this stage held before.
      if (t >= kStages) mbar_wait<true>(empty + 8 * st, (t / kStages - 1) & 1);
      mbar_expect_tx(k_full + 8 * st, L::kKVBytes);
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf)
        tma_load(k_s + st * L::kKVBytes + hf * BK * kRowBytes, &k_map, k_full + 8 * st,
                 hf * kBox, kvh, t * BK, b);
      mbar_expect_tx(v_full + 8 * st, L::kKVBytes);
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf)
        tma_load(v_s + st * L::kKVBytes + hf * BK * kRowBytes, &v_map, v_full + 8 * st,
                 hf * kBox, kvh, t * BK, b);
    }
    return;
  }

  // Consumer warpgroup c: query rows r0 .. r0 + 63 of the block, all of
  // O's columns.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int c = wg - 1;
  const int r0 = q0 + 64 * c;
  // The key tiles its rows below S need: up to the last such row, none if
  // it has none.
  const int n_mine = r0 < S ? (min(r0 + 64, S) + BK - 1) / BK : 0;
  const int lane = tid & 31;
  const int row = 16 * (tid >> 5) + (lane >> 2);  // this thread's rows: row, row + 8
  const uint32_t q_wg = q_s + (r0 - q0) * kRowBytes;

  float o[D / PVN][PVN / 2];  // O in column groups of one P.V wgmma each
  float s[BK / 2];
#pragma unroll
  for (int n = 0; n < D / PVN; ++n)
#pragma unroll
    for (int i = 0; i < PVN / 2; ++i) o[n][i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  mbar_wait<false>(q_full, 0);
  // Consumer 0 takes the first turn; each passes the turn on after its
  // Q K^T of every tile, but the last of consumer 1's, so each barrier
  // sees as many arrivals as waits.
  if (kPingPong<D> && c == 1)
    asm volatile("bar.arrive %0, 256;" ::"r"(kTurnBar) : "memory");
  const auto pass_turn = [&](int t) {
    if (kPingPong<D> && (c == 0 || t + 1 < n_kt))
      asm volatile("bar.arrive %0, 256;" ::"r"(kTurnBar + 1 - c) : "memory");
  };

  for (int t = 0; t < n_kt; ++t) {
    const int st = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    const uint32_t k_tile = k_s + st * L::kKVBytes;
    const uint32_t v_tile = v_s + st * L::kKVBytes;

    mbar_wait<false>(k_full + 8 * st, parity);
    if constexpr (kPingPong<D>) asm volatile("bar.sync %0, 256;" ::"r"(kTurnBar + c) : "memory");
    if (t >= n_mine) {
      pass_turn(t);
      // No row of this consumer needs the tile; the other one may. Its
      // warps release the stage all the same, now that the producer has
      // filled it (an arrival before then would count toward the tile
      // the stage held before).
      if (lane == 0) mbar_arrive(empty + 8 * st);
      continue;
    }

    // S = Q K^T: both K-major; k-step kk reads columns 16 kk of half kk / 4.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_qk<BK>(s, desc(q_wg + (kk / 4) * BQ * kRowBytes + off, 16, 1024),
                   desc(k_tile + (kk / 4) * BK * kRowBytes + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    pass_turn(t);
    wgmma_wait<0>();
    fence_regs(s);

    float alpha[2];
    // Only the tile that crosses the diagonal masks.
    if ((t + 1) * BK - 1 > r0)
      softmax_tile<true>(s, m, l, alpha, sl2, r0 + row, t * BK + 2 * (lane & 3));
    else
      softmax_tile<false>(s, m, l, alpha, sl2, r0 + row, t * BK + 2 * (lane & 3));
#pragma unroll
    for (int n = 0; n < D / PVN; ++n)
#pragma unroll
      for (int i = 0; i < PVN / 2; ++i) o[n][i] *= alpha[(i >> 1) & 1];

    // O += P V: P from registers (the score layout is the A-fragment
    // layout), V MN-major: k-step j reads keys 16 j.. of column group n's
    // 64-column boxes (LBO apart).
    mbar_wait<false>(v_full + 8 * st, parity);
#pragma unroll
    for (int n = 0; n < D / PVN; ++n) fence_regs(o[n]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t a[4] = {pack_bf16(s[8 * j + 0], s[8 * j + 1]),
                             pack_bf16(s[8 * j + 2], s[8 * j + 3]),
                             pack_bf16(s[8 * j + 4], s[8 * j + 5]),
                             pack_bf16(s[8 * j + 6], s[8 * j + 7])};
#pragma unroll
      for (int n = 0; n < D / PVN; ++n)
        wgmma_pv<PVN>(o[n], a,
                      desc(v_tile + (n * (PVN / kBox) * BK + j * 16) * kRowBytes,
                           BK * kRowBytes, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < D / PVN; ++n) fence_regs(o[n]);
    // This warp is done with the stage.
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }
  if (n_mine == 0) return;  // every row at or past S: nothing to write

  // Epilogue: O / l as bf16 into this warpgroup's own rows of Q's shared
  // memory in the map's swizzle, then one TMA store per box (rows past S
  // are clipped).
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  unsigned char* o_s = smem_raw + (q_wg - raw);
#pragma unroll
  for (int g = 0; g < D / 8; ++g) {  // 8-column group g: box g / 8, chunk g % 8
    const int n = g / (PVN / 8), i = 4 * (g % (PVN / 8));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = row + 8 * r;
      unsigned char* dst = o_s + (g / 8) * BQ * kRowBytes + rr * kRowBytes +
                           (((g % 8) ^ (rr & 7)) << 4) + 4 * (lane & 3);
      *reinterpret_cast<uint32_t*>(dst) =
          pack_bf16(o[n][i + 2 * r] * inv[r], o[n][i + 2 * r + 1] * inv[r]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + c) : "memory");  // this warpgroup
  if (tid == 0) {
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf)
      tma_store(&o_map, q_wg + hf * BQ * kRowBytes, hf * kBox, h, r0, b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// ---- host ------------------------------------------------------------------

// A rank-4 (D, heads, S, B) map of a contiguous [B, S, heads, D] bf16
// tensor with {64, 1, rows, 1} boxes and the 128-byte swizzle. Rows past S
// read as zeros and are not written.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int D,
              int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode_fn()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                     dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
           int KVH, float scale, cudaStream_t stream) {
  constexpr int bytes = Smem<D>::bytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap q_map, k_map, v_map, o_map;
  if (!make_map(&q_map, q, B, S, H, D, kBQ) || !make_map(&k_map, k, B, S, KVH, D, kBK<D>) ||
      !make_map(&v_map, v, B, S, KVH, D, kBK<D>) || !make_map(&o_map, out, B, S, H, D, 64))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B, (S + kBQ - 1) / kBQ);
  flash_prefill_kernel<D><<<grid, kThreads, bytes, stream>>>(
      q_map, k_map, v_map, o_map, S, H / KVH, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` (PyTorch's current stream); allocates nothing.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a shape or an alignment the kernel does not take (TMA needs
// 16-byte-aligned bases), or cudaErrorNotSupported when the driver has no
// cuTensorMapEncodeTiled.
extern "C" int kubeai_flash_prefill_bf16(const void* q, const void* k, const void* v,
                                         void* out, int B, int S, int H, int KVH, int D,
                                         float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || B > 65535 || (S + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorInvalidValue;
  if (encode_fn() == nullptr) return (int)cudaErrorNotSupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 256) return launch<256>(q, k, v, out, B, S, H, KVH, scale, s);
  if (D == 128) return launch<128>(q, k, v, out, B, S, H, KVH, scale, s);
  if (D == 64) return launch<64>(q, k, v, out, B, S, H, KVH, scale, s);
  return (int)cudaErrorInvalidValue;
}
