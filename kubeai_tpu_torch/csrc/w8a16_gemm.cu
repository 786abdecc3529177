// W8A16 GEMM for Hopper (sm_90a): out[M, N] = x[M, K] @ deq(w8[K, N]), bf16
// activations, int8 weights with one f32 scale per output channel, f32
// accumulation, bf16 out.
//
// Replaces no pallas_call. It stands for XLA's fused dequantize-into-dot in
// the JAX package's int8-weight serving: kubeai_tpu/engine/quantization.py
// (`dequantize`, applied through `_w` at kubeai_tpu/models/llama.py:39),
// where XLA folds convert(int8 -> bf16) * scale into the dot's operand read
// so that no bf16 copy of a weight is ever written. Plain PyTorch cannot do
// that: it would write and read back a bf16 copy of every layer weight each
// step, more bytes than the bf16 weights themselves.
//
// Each weight is formed as exactly the bf16 value that the plain version
// forms, bf16(bf16(w8) * bf16(scale)): the int8 value goes to f32 exactly
// (byte_perm into the mantissa of 2^23, one FADD), and the product with
// the bf16-rounded scale, exact in f32, is rounded once to bf16 as torch
// rounds it (cvt.rn.bf16x2 in the skinny kernel; mul.rn.bf16x2 on the two
// values packed as bf16, which they are exactly, in the wgmma kernel). So
// the kernels and torch.matmul on the dequantized weight differ only in
// the order of the sums.
//
// Layout: w8 is read N-major, [N, K] contiguous (quantization.py stores the
// [K, N] leaf as the transposed view of such a tensor, once, at load). Both
// kernels compute the product transposed, out^T[channels, rows] = W x^T,
// with the WEIGHT as the tensor cores' A operand (its rows are channels, so
// each thread keeps its channels' scales in registers) and x as B.
//
// Two kernels, chosen by the wrapper from M alone (ops/int8_matmul.py,
// `route`; on an H100 the wgmma kernel is the faster over a layer's seven
// products from 16 rows up, the skinny one at 8, PERF.md section 6):
//   - Decode steps (M <= 8): the skinny kernel, bound by bytes. A weight
//     byte feeds at most 2 * M flops, far below the ~295 a byte where the
//     tensor cores would be the limit; the least time is the int8 weights
//     over 3.35 TB/s (0.0050 ms for Llama-3-8B's wq, 0.0175 ms for
//     w_gate). It streams them straight into registers with 16-byte
//     ld.global.nc, four chunks in flight a lane, on mma.sync.m16n8k16: one
//     CTA per 16 or 32 output channels, its warps splitting K chunk by
//     chunk, summed through shared memory in warp order (no atomics: two
//     calls give the same bits). x is read through L1. Within a 64-wide K
//     chunk, lane (g, t) holds the 16 contiguous bytes k = 16t .. 16t + 15
//     of channel rows g and g + 8; in the chunk's j-th k16 step its four A
//     slots (logical k 2t, 2t+1, 2t+8, 2t+9) take bytes 4j .. 4j + 3, and its
//     B slots the same four k of x's row g: a permutation of k that A and B
//     share, so a 16-byte load per row feeds four mmas. It takes one 8-row
//     tile (kSkinnyMaxM).
//   - From 9 rows up (verify windows, prefill): the wgmma kernel. A CTA of
//     three warpgroups owns 128 channels x BM rows (BM 16 .. 256, wgmma's
//     N). Warpgroup 0 gives up its registers (setmaxnreg.dec) and one of its
//     threads keeps TMA loads in flight into a ring of 4 to 8 stages, each
//     the weight tile [128 channels][64 k] (int8, 64-byte swizzle) and the
//     x tile [BM rows][64 k] (bf16, 128-byte swizzle), with full and empty
//     mbarriers. Warpgroups 1 and 2 take the registers (setmaxnreg.inc) and
//     own 64 channels each. For each k16 step a consumer reads its 64 x 16
//     int8 A fragment from shared memory (one 4-byte load a row and half
//     step a lane, conflict-free), forms the bf16 weights in registers and
//     issues wgmma.mma_async m64nBMk16 with the fragment from registers (RS
//     form) and x through a shared-memory descriptor; it forms step j + 1's
//     fragment while step j's wgmma runs (wait_group 1). Each weight is
//     converted once a CTA and serves BM rows. The epilogue rounds to bf16,
//     transposes through shared memory with stmatrix and writes out[M, N]
//     with one TMA store a consumer (rows past M and channels past N are
//     clipped; TMA zero-fills loads past them). Where the tiles are too few
//     for the card the grid splits K into f32 partials that a small kernel
//     sums in a fixed order. Every mbarrier wait is bounded (hopper.cuh's
//     mbar_wait): the producer's traps, a consumer's exits, so that the
//     producer's next wait traps.
//     What bounds it on an H100 (builds without one part of the work,
//     chip_smoke.report_w8a16_variants; PERF.md section 6): at every M the
//     consumers' k16 steps, the fragment's loads and conversion and the
//     RS-form wgmma behind them, not the bytes: at M = 40 a build without
//     the TMA loads takes as long, and one without the fragments' work
//     ~20% less. At M = 4096 it reaches ~58% of the tensor cores' peak;
//     without the fragments' work ~71%, without the TMA loads ~66%.
// The kernels allocate nothing (split-K scratch comes from the wrapper) and
// launch on the caller's stream, so the engine's CUDA graphs capture them;
// the TMA maps are built on the host on every call and passed as
// __grid_constant__ parameters, so a graph captures them with the launch.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kChunk = 64;   // K per chunk
constexpr int kUnroll = 4;   // chunks in flight a lane (skinny kernel)
constexpr int kSkinnyMaxM = 8;  // one 8-row tile: the decode step
constexpr int kTileN = 128;  // channels a CTA (wgmma kernel): 64 a consumer
constexpr uint32_t kSel = 0x7440;  // byte_perm selector of byte_to_float

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The signed byte that selector `sel` (kSel | byte) picks from w, exactly,
// as f32: 2^23 + (byte + 128), minus 2^23 + 128.
__device__ __forceinline__ float byte_to_float(uint32_t w_biased, uint32_t sel) {
  return __int_as_float(__byte_perm(w_biased, 0x4B000000u, sel)) - 8388736.0f;
}

// bf16(byte lo * s), bf16(byte hi * s) packed (lo in the low half); lo and
// hi are byte_perm selectors.
__device__ __forceinline__ uint32_t deq2(uint32_t w_biased, uint32_t lo, uint32_t hi, float s) {
  const __nv_bfloat162 p =
      __floats2bfloat162_rn(byte_to_float(w_biased, lo) * s, byte_to_float(w_biased, hi) * s);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The same two values from the bf16 scale packed twice (s2): the two
// bytes, exact in f32, are exact in bf16 too (|byte| <= 128 needs 8
// significant bits), so their upper halves pack them, and mul.rn.bf16x2
// rounds each exact product once, as deq2 does.
__device__ __forceinline__ uint32_t deq2_bf16(uint32_t w_biased, uint32_t lo, uint32_t hi,
                                              uint32_t s2) {
  const uint32_t p = __byte_perm(__float_as_uint(byte_to_float(w_biased, lo)),
                                 __float_as_uint(byte_to_float(w_biased, hi)), 0x7632);
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(p), "r"(s2));
  return r;
}

// The A fragments of four k16 steps from 16 bytes of channel row g (wa) and
// row g + 8 (wb), with their bf16 scales: a[j] = {row g bytes 4j, 4j+1; row
// g+8 bytes 4j, 4j+1; row g bytes 4j+2, 4j+3; row g+8 bytes 4j+2, 4j+3}.
__device__ __forceinline__ void dequant_fragments(const uint4& wa, const uint4& wb, float s0,
                                                  float s1, uint32_t (&a)[4][4]) {
  const uint32_t ra[4] = {wa.x ^ 0x80808080u, wa.y ^ 0x80808080u, wa.z ^ 0x80808080u,
                          wa.w ^ 0x80808080u};
  const uint32_t rb[4] = {wb.x ^ 0x80808080u, wb.y ^ 0x80808080u, wb.z ^ 0x80808080u,
                          wb.w ^ 0x80808080u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j][0] = deq2(ra[j], kSel | 0, kSel | 1, s0);
    a[j][1] = deq2(rb[j], kSel | 0, kSel | 1, s1);
    a[j][2] = deq2(ra[j], kSel | 2, kSel | 3, s0);
    a[j][3] = deq2(rb[j], kSel | 2, kSel | 3, s1);
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 ld_nc16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint32_t word(const uint4& lo, const uint4& hi, int i) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  return w[i];
}

// ---- M <= 8: one CTA per 16 * RN channels, warps split K -------------------

// A warp holds RN 16-channel tiles, so each x fragment it loads feeds RN
// mmas: RN = 2 on wide weights (kubeai_w8a16_gemm). 16 warps a CTA where
// the CTAs are few, else 8 (launch_skinny). Each lane keeps kUnroll / RN
// chunks in flight.
template <int RN>
__global__ void __launch_bounds__(512)
w8a16_skinny_kernel(const __nv_bfloat16* __restrict__ x,  // [M, K]
                    const int8_t* __restrict__ w,         // [N, K]
                    const float* __restrict__ scale,      // [N]
                    __nv_bfloat16* __restrict__ out,      // [M, N]
                    int M, int N, int K) {
  constexpr int U = kUnroll / RN;
  extern __shared__ float red_s[];  // [warps][4][32], one tile at a time
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * 16 * RN;
  float s[RN][2];
  const int8_t* wr[RN];
#pragma unroll
  for (int r = 0; r < RN; ++r) {
    s[r][0] = bf16_round(scale[n0 + 16 * r + g]);
    s[r][1] = bf16_round(scale[n0 + 16 * r + g + 8]);
    wr[r] = w + (size_t)(n0 + 16 * r + g) * K + 16 * t;
  }
  const int chunks = K / kChunk;
  float acc[RN][4];
#pragma unroll
  for (int r = 0; r < RN; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;

  for (int c0 = warp; c0 < chunks; c0 += warps * U) {
    uint4 wa[U][RN], wb[U][RN];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * warps;
      if (c < chunks) {
#pragma unroll
        for (int r = 0; r < RN; ++r) {
          wa[u][r] = ld_nc16(wr[r] + (size_t)c * kChunk);
          wb[u][r] = ld_nc16(wr[r] + (size_t)8 * K + (size_t)c * kChunk);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * warps;
      if (c >= chunks) break;
      uint32_t a[RN][4][4];
#pragma unroll
      for (int r = 0; r < RN; ++r) dequant_fragments(wa[u][r], wb[u][r], s[r][0], s[r][1], a[r]);
      uint4 xa = make_uint4(0, 0, 0, 0), xb = xa;
      if (g < M) {
        const __nv_bfloat16* xp = x + (size_t)g * K + (size_t)c * kChunk + 16 * t;
        xa = ld_nc16(xp);
        xb = ld_nc16(xp + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < RN; ++r)
          mma_bf16(acc[r], a[r][j], word(xa, xb, 2 * j), word(xa, xb, 2 * j + 1));
    }
  }

  // Sum the warps' partial tiles in warp order, one 16-channel tile at a
  // time: register i of lane l holds channel (l >> 2) + 8 (i >= 2), row
  // 2 (l & 3) + (i & 1).
#pragma unroll
  for (int r = 0; r < RN; ++r) {
    if (r) __syncthreads();  // the last tile's sums are read
#pragma unroll
    for (int i = 0; i < 4; ++i) red_s[(warp * 4 + i) * 32 + lane] = acc[r][i];
    __syncthreads();
    for (int e = threadIdx.x; e < 4 * 32; e += blockDim.x) {
      float sum = 0.f;
      for (int v = 0; v < warps; ++v) sum += red_s[v * 4 * 32 + e];
      const int i = e >> 5, l = e & 31;
      const int n = n0 + 16 * r + (l >> 2) + (i >= 2 ? 8 : 0);
      const int m = 2 * (l & 3) + (i & 1);
      if (m < M) out[(size_t)m * N + n] = __float2bfloat16_rn(sum);
    }
  }
}

// ---- split K: the fixed-order sum of the partials ---------------------------

// out = the sum of `splits` f32 partials [splits, M * N], in split order,
// four elements a thread.
__global__ void __launch_bounds__(256)
w8a16_reduce_kernel(const float4* __restrict__ part, __nv_bfloat16* __restrict__ out,
                    int quads, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= quads) return;
  float4 sum = part[i];
  for (int z = 1; z < splits; ++z) {
    const float4 p = part[(size_t)z * quads + i];
    sum.x += p.x;
    sum.y += p.y;
    sum.z += p.z;
    sum.w += p.w;
  }
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out) + 2 * (size_t)i;
  o[0] = __floats2bfloat162_rn(sum.x, sum.y);
  o[1] = __floats2bfloat162_rn(sum.z, sum.w);
}

// ---- the wgmma kernel: 128 channels x BM rows a CTA -------------------------

constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);   // warpgroup 0 produces
// setmaxnreg: the producer gives registers up, the consumers take them
// (40 * 128 + 232 * 256 <= 65536).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kWTileBytes = kTileN * kChunk;  // int8 [128 channels][64 k]
constexpr int kSmemLimit = 232448;            // 227 KB a block
constexpr int kMaxStages = 8;

// Byte offsets from the 1024-byte-aligned base of dynamic shared memory:
// the ring's weight tiles, its x tiles, one bf16 output tile a consumer
// ([BM rows][64 channels], 128-byte swizzle), then the mbarriers. The ring
// is as deep as the 227 KB allow, up to 8 stages: 4 at BM = 256.
template <int BM>
struct WgmmaLayout {
  static constexpr int kXBytes = BM * kChunk * 2;  // bf16 [BM rows][64 k]
  static constexpr int kOutBytes = BM * 64 * 2;     // one consumer's output tile
  static constexpr int kStageBytes = kWTileBytes + kXBytes;
  static constexpr int kFit =
      (kSmemLimit - 1024 - 16 * kMaxStages - kConsumers * kOutBytes) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int w = 0;
  static constexpr int x = w + kStages * kWTileBytes;
  static constexpr int out = x + kStages * kXBytes;
  static constexpr int bars = out + kConsumers * kOutBytes;  // full[kStages], empty[kStages]
  static constexpr int bytes = bars + 16 * kStages + 1024;
  static_assert(kStages >= 4, "a ring of at least 4 stages");
  static_assert(bytes <= kSmemLimit, "a block has at most 227 KB of shared memory");
};

// One box {64 k, rows} of a rank-2 (K, rows) map into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int col, int row) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(col), "r"(row)
               : "memory");
}

// d[N / 2] += A(registers, 64 channels x 16 k) * B(shared memory, K-major:
// N rows of x), m64nNk16: N is the tile's rows, BM.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, uint32_t r0, uint32_t r1,
                                                  uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(
                   addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// bf16(s) in both halves of a word.
__device__ __forceinline__ uint32_t scale2(float s) {
  const __nv_bfloat16 b = __float2bfloat16_rn(s);
  return (uint32_t)(*reinterpret_cast<const uint16_t*>(&b)) * 0x10001u;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of k16 step j of the chunk in the weight tile `ws`
// (rows of 64 bytes; TMA's 64-byte swizzle stores the 16 bytes of step j
// of row r at chunk j ^ ((r >> 1) & 3), the same for rows r and r + 8):
// wgmma's A layout for rows r (a[0], a[2]) and r + 8 (a[1], a[3]), k 2t,
// 2t + 1 (a[0], a[1]) and 2t + 8, 2t + 9 (a[2], a[3]) of the step. Lane t
// loads word t / 2 of each 8-byte half of the step (`word`: 4 (t / 2)) and
// takes bytes 2 (t % 2) and 2 (t % 2) + 1 of it (`sel_lo`, `sel_hi`); the
// lanes of a warp read 16 distinct words, no two on one bank.
__device__ __forceinline__ void load_fragment(uint32_t ws, int r, int sw, int j, uint32_t word,
                                              uint32_t sel_lo, uint32_t sel_hi, uint32_t s0,
                                              uint32_t s1, uint32_t (&a)[4]) {
  const uint32_t ra = ws + r * kChunk + ((j ^ sw) << 4) + word;
  const uint32_t rb = ra + 8 * kChunk;
  a[0] = deq2_bf16(lds32(ra) ^ 0x80808080u, sel_lo, sel_hi, s0);
  a[1] = deq2_bf16(lds32(rb) ^ 0x80808080u, sel_lo, sel_hi, s1);
  a[2] = deq2_bf16(lds32(ra + 8) ^ 0x80808080u, sel_lo, sel_hi, s0);
  a[3] = deq2_bf16(lds32(rb + 8) ^ 0x80808080u, sel_lo, sel_hi, s1);
}

// out^T[n0 .. n0 + 127, m0 .. m0 + BM - 1] = W x^T over this CTA's chunks
// [z * cps, (z + 1) * cps): grid (M / BM, N / 128, splits), the row tiles
// fastest, so the CTAs in flight share each weight tile through L2. With
// part == nullptr the consumers write bf16 out through o_map; else f32
// partials to part[z] (scratch from the wrapper), which
// w8a16_reduce_kernel sums in z order.
template <int BM>
__global__ void __launch_bounds__(kThreads, 1)
w8a16_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,  // bf16 [M, K], box {64, BM}
                   const __grid_constant__ CUtensorMap w_map,  // u8 [N, K], box {64, 128}
                   const __grid_constant__ CUtensorMap o_map,  // bf16 [M, N], box {64, BM}
                   const float* __restrict__ scale, float* __restrict__ part, int M, int N,
                   int chunks, int cps) {
  using L = WgmmaLayout<BM>;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + L::bars;  // + 8 * stage
  const uint32_t empty = full + 8 * S;   // + 8 * stage
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kTileN;
  const int c_first = blockIdx.z * cps;
  const int n_chunks = min(chunks - c_first, cps);
  // The warpgroup index, broadcast from lane 0 so that ptxas knows it is
  // warp-uniform.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < S; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 4 * kConsumers);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid != 0) return;
    for (int i = 0; i < n_chunks; ++i) {
      const int st = i % S;
      // The consumers released the chunk this stage held before.
      if (i >= S) mbar_wait<true>(empty + 8 * st, (i / S - 1) & 1);
      mbar_expect_tx(full + 8 * st, kWTileBytes + L::kXBytes);
      const int k = (c_first + i) * kChunk;
      tma_load(base + L::w + st * kWTileBytes, &w_map, full + 8 * st, k, n0);
      tma_load(base + L::x + st * L::kXBytes, &x_map, full + 8 * st, k, m0);
    }
    return;
  }

  // Consumer warpgroup c: channels n0 + 64 c .. + 63. Warp w of it holds
  // channel rows r = 64 c + 16 w + g and r + 8 of the tile in its A
  // fragments and accumulators (d[i]: channel row r + 8 ((i >> 1) & 1), x
  // row 8 (i >> 2) + 2 t + (i & 1)).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int c = wg - 1;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r = 64 * c + 16 * warp + g;
  const int sw = (r >> 1) & 3;
  const uint32_t word = 4 * (t >> 1);
  const uint32_t sel_lo = kSel | (2 * (t & 1)), sel_hi = sel_lo + 1;
  // Each channel's bf16 scale, packed twice.
  const uint32_t s0 = n0 + r < N ? scale2(scale[n0 + r]) : 0u;
  const uint32_t s1 = n0 + r + 8 < N ? scale2(scale[n0 + r + 8]) : 0u;

  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  uint32_t a[2][4];
  mbar_wait<false>(full, 0);
  load_fragment(base + L::w, r, sw, 0, word, sel_lo, sel_hi, s0, s1, a[0]);
  for (int i = 0; i < n_chunks; ++i) {
    const int st = i % S;
    const uint32_t ws = base + L::w + st * kWTileBytes;
    const uint32_t xs = base + L::x + st * L::kXBytes;
#pragma unroll
    for (int j = 0; j < kChunk / 16; ++j) {
      fence_regs(acc);
      wgmma_fence();
      // Step j reads k 16 j .. of the x tile: 32 bytes into each 128-byte
      // row of the swizzled tile, 8-row groups 1024 bytes apart.
      wgmma_rs<BM>(acc, a[j & 1], desc(xs + 32 * j, 16, 1024));
      wgmma_commit();
      // Step j - 1's wgmma is done: its fragment registers are free, and
      // at j = 0 the previous chunk's stage is no longer read.
      wgmma_wait<1>();
      fence_regs(acc);
      if (j == 0 && i > 0 && lane == 0) mbar_arrive(empty + 8 * ((i - 1) % S));
      if (j + 1 < kChunk / 16) {
        load_fragment(ws, r, sw, j + 1, word, sel_lo, sel_hi, s0, s1, a[(j + 1) & 1]);
      } else if (i + 1 < n_chunks) {
        const int nst = (i + 1) % S;
        mbar_wait<false>(full + 8 * nst, ((i + 1) / S) & 1);
        load_fragment(base + L::w + nst * kWTileBytes, r, sw, 0, word, sel_lo, sel_hi, s0, s1,
                      a[0]);
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  if (part != nullptr) {
    // f32 partials of split blockIdx.z.
    float* p = part + (size_t)blockIdx.z * M * N;
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) {
      const int n = n0 + r + 8 * ((i >> 1) & 1);
      const int m = m0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (m < M && n < N) p[(size_t)m * N + n] = acc[i];
    }
    return;
  }
  // bf16 through this consumer's output tile [BM rows][64 channels] in the
  // map's 128-byte swizzle: stmatrix .trans writes the 8 x 8 blocks
  // (channels 16 w + 8 h .., x rows 8 b ..) of d[4 b + 2 h], d[4 b + 2 h + 1]
  // as rows of x. Lanes 8 q .. 8 q + 7 address matrix q's 8 rows.
  const uint32_t o_s = base + L::out + c * L::kOutBytes;
  const int q = lane >> 3;
#pragma unroll
  for (int b = 0; b < BM / 8; b += 2) {
    const int row = 8 * (b + (q >> 1)) + (lane & 7);
    const int chunk = 2 * warp + (q & 1);
    stmatrix_x4_trans(o_s + row * 128 + ((chunk ^ (row & 7)) << 4),
                      pack_bf16(acc[4 * b + 0], acc[4 * b + 1]),
                      pack_bf16(acc[4 * b + 2], acc[4 * b + 3]),
                      pack_bf16(acc[4 * b + 4], acc[4 * b + 5]),
                      pack_bf16(acc[4 * b + 6], acc[4 * b + 7]));
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + c) : "memory");  // this warpgroup
  if (tid == 0 && n0 + 64 * c < N) {
    tma_store(&o_map, o_s, n0 + 64 * c, m0);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

template <int RN>
int launch_skinny(const __nv_bfloat16* x, const int8_t* w, const float* scale,
                  __nv_bfloat16* out, int M, int N, int K, cudaStream_t s) {
  // 16 warps a CTA where the CTAs are few (Llama-3-8B's wk and wv: 64),
  // else 8.
  const int tiles = N / (16 * RN);
  const int warps = tiles < 264 ? 16 : 8;
  const size_t smem = (size_t)warps * 4 * 32 * sizeof(float);
  w8a16_skinny_kernel<RN><<<tiles, warps * 32, smem, s>>>(x, w, scale, out, M, N, K);
  return (int)cudaGetLastError();
}

// A rank-2 (cols, rows) map of a contiguous row-major [rows, cols] tensor
// with {64, box_rows} boxes. Boxes past the edges read as zeros and are
// not written.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* ptr,
              int rows, int cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode_fn()(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM>
int launch_wgmma(const void* x, const void* w, const float* scale, __nv_bfloat16* out,
                 float* part, int M, int N, int K, int splits, cudaStream_t s) {
  using L = WgmmaLayout<BM>;
  static bool configured = false;  // idempotent; a race sets it twice
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        w8a16_wgmma_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  CUtensorMap x_map, w_map, o_map;
  if (!make_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, BM,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, N, K, kTileN,
                CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map(&o_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, M, N, BM,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const int chunks = K / kChunk;
  const int cps = (chunks + splits - 1) / splits;
  splits = (chunks + cps - 1) / cps;  // no split without a chunk
  if (splits == 1) part = nullptr;
  const dim3 grid((M + BM - 1) / BM, (N + kTileN - 1) / kTileN, splits);
  w8a16_wgmma_kernel<BM><<<grid, kThreads, L::bytes, s>>>(x_map, w_map, o_map, scale, part, M,
                                                           N, chunks, cps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const int quads = M * N / 4;
  w8a16_reduce_kernel<<<(quads + 255) / 256, 256, 0, s>>>(reinterpret_cast<const float4*>(part),
                                                           out, quads, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// out[M, N] = x[M, K] @ (bf16(w8) * bf16(scale)), w8 stored [N, K], on
// `stream` (PyTorch's current stream), by the kernel the wrapper chose
// (ops/int8_matmul.py's `route` and `gemm_plan`): kernel 0
// the skinny kernel (M <= 8, splits 1), kernel 1 the wgmma kernel with `bm` rows a CTA (16, 32, 48,
// 64, 96, 128 or 256) and K split `splits` ways, the reduce kernel after it
// when splits > 1 (`scratch` then holds splits * M * N floats from the
// caller). Returns cudaGetLastError() after the launches,
// cudaErrorInvalidValue for a shape, an alignment (TMA reads x, w8 and out
// from 16-byte-aligned bases) or a plan it does not take (K not a multiple
// of 64, N not a multiple of 16), or cudaErrorNotSupported when libcuda
// has no cuTensorMapEncodeTiled.
extern "C" int kubeai_w8a16_gemm(const void* x, const void* w8, const void* scale, void* out,
                                 void* scratch, int M, int N, int K, int kernel, int bm,
                                 int splits, void* stream) {
  if (M <= 0) return 0;
  if (N <= 0 || K <= 0 || K % kChunk != 0 || N % 16 != 0 || splits < 1 ||
      (splits > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const int8_t*>(w8);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* part = static_cast<float*>(scratch);
  if (kernel == 0) {
    if (M > kSkinnyMaxM || splits != 1) return (int)cudaErrorInvalidValue;
    // Two 16-channel tiles a warp on wide weights (w_gate and w_up at 8B:
    // 448 CTAs of 32 channels); narrower ones keep one.
    if (N % 32 == 0 && N >= 8192) return launch_skinny<2>(xp, wp, sp, op, M, N, K, s);
    return launch_skinny<1>(xp, wp, sp, op, M, N, K, s);
  }
  if (kernel != 1) return (int)cudaErrorInvalidValue;
  for (const void* p : {x, w8, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorInvalidValue;
  if (encode_fn() == nullptr) return (int)cudaErrorNotSupported;
  switch (bm) {
    case 16: return launch_wgmma<16>(x, w8, sp, op, part, M, N, K, splits, s);
    case 32: return launch_wgmma<32>(x, w8, sp, op, part, M, N, K, splits, s);
    case 48: return launch_wgmma<48>(x, w8, sp, op, part, M, N, K, splits, s);
    case 64: return launch_wgmma<64>(x, w8, sp, op, part, M, N, K, splits, s);
    case 96: return launch_wgmma<96>(x, w8, sp, op, part, M, N, K, splits, s);
    case 128: return launch_wgmma<128>(x, w8, sp, op, part, M, N, K, splits, s);
    case 256: return launch_wgmma<256>(x, w8, sp, op, part, M, N, K, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
