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
// (byte_perm into the mantissa of 2^23, one FADD), the product with the
// bf16-rounded scale is exact in f32, and cvt.rn.bf16x2 rounds it as torch
// does. So the kernel and torch.matmul on the dequantized weight differ
// only in the order of the sums.
//
// Layout: w8 is read N-major, [N, K] contiguous (quantization.py stores the
// [K, N] leaf as the transposed view of such a tensor, once, at load).
// Both products run on mma.sync.m16n8k16 (bf16 in, f32 accumulators) with
// the WEIGHT as the A operand (16 output channels a tile) and x as B (8
// rows a tile), so a decode step's 8 rows fill an n8 tile. Within a 64-wide
// K chunk, lane (g, t) of a warp holds the 16 contiguous bytes k = 16t ..
// 16t + 15 of channel rows g and g + 8; in the chunk's j-th k16 step its
// four A slots (logical k 2t, 2t+1, 2t+8, 2t+9) take bytes 4j .. 4j + 3, and
// its B slots take the same four k of x's row g, which the same lane reads
// as 16 contiguous bf16. The logical k order inside a step is a permutation
// that A and B share, so the product is the same sum: a 16-byte load per
// row feeds four mmas, with no shared-memory pass and no ldmatrix.
//
// What bounds it on this card:
//   - M <= 64 (decode steps, verify windows): bytes. A weight byte feeds at
//     most 2 * 64 flops, far below the ~295 a byte where the tensor cores
//     would be the limit; the least time is the int8 weights over 3.35 TB/s
//     (0.0050 ms for Llama-3-8B's wq, 0.0175 ms for w_gate). The skinny
//     kernel streams them straight into registers with 16-byte
//     ld.global.nc, four chunks in flight a lane: one CTA per 16 or 32
//     output channels, its 8 or 16 warps splitting K chunk by chunk,
//     summed through shared memory in warp order (no atomics: two calls
//     give the same bits). x (at most 64 rows) is read through L1. On an
//     H100 it streams at ~1.9-2.1 TB/s (PERF.md section 6).
//   - M > 64 (prefill): operations. The tiled kernel runs a CTA of 8 warps
//     over 128 channels x 16 * MT rows, with a 4- or 6-deep cp.async ring
//     of 64-wide K chunks (weight tile 8 KB, x tile padded to 144-byte rows
//     against bank conflicts); each warp dequantizes its two 16-channel
//     tiles once per chunk and uses them for 4 * MT mmas. Where its tiles
//     are too few for the card it splits K into f32 partials that a small
//     kernel sums in a fixed order. It is a simple mma.sync kernel (~210
//     TFLOP/s on an H100), not wgmma.
// The kernels allocate nothing (split-K scratch comes from the wrapper) and
// launch on the caller's stream, so the engine's CUDA graphs capture them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;   // K per chunk
constexpr int kUnroll = 4;   // chunks in flight a lane (skinny kernel)
constexpr int kSkinnyMaxM = 64;
constexpr int kTileN = 128;  // channels a CTA (tiled kernel)
constexpr int kXRowBytes = kChunk * 2 + 16;  // padded x row in shared memory

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Signed byte `sel` of w, exactly, as f32: 2^23 + (byte + 128), minus
// 2^23 + 128.
__device__ __forceinline__ float byte_to_float(uint32_t w_biased, int sel) {
  return __int_as_float(__byte_perm(w_biased, 0x4B000000u, 0x7440 | sel)) - 8388736.0f;
}

// bf16(byte lo * s), bf16(byte hi * s) packed (lo in the low half).
__device__ __forceinline__ uint32_t deq2(uint32_t w_biased, int lo, int hi, float s) {
  const __nv_bfloat162 p =
      __floats2bfloat162_rn(byte_to_float(w_biased, lo) * s, byte_to_float(w_biased, hi) * s);
  return *reinterpret_cast<const uint32_t*>(&p);
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
    a[j][0] = deq2(ra[j], 0, 1, s0);
    a[j][1] = deq2(rb[j], 0, 1, s1);
    a[j][2] = deq2(ra[j], 2, 3, s0);
    a[j][3] = deq2(rb[j], 2, 3, s1);
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

// ---- M <= 64: one CTA per 16 * RN channels, warps split K ------------------

// A warp holds RN 16-channel tiles, so each x fragment it loads feeds RN
// mmas: RN = 2 from 24 rows up, where x's traffic (through L1 and L2, MT
// times the weight's bytes at RN = 1) would bound the kernel, and on wide
// weights (launch_skinny_rows). 16 warps a
// CTA at MT * RN <= 4, else 8 (launch_skinny), so the larger tiles keep up
// to 255 registers a thread for their 4 * MT * RN accumulators. Each lane
// keeps kUnroll / RN chunks in flight.
template <int MT, int RN>
__global__ void __launch_bounds__(MT * RN <= 4 ? 512 : 256)
w8a16_skinny_kernel(const __nv_bfloat16* __restrict__ x,  // [M, K]
                    const int8_t* __restrict__ w,         // [N, K]
                    const float* __restrict__ scale,      // [N]
                    __nv_bfloat16* __restrict__ out,      // [M, N]
                    int M, int N, int K) {
  constexpr int U = kUnroll / RN;
  extern __shared__ float red_s[];  // [warps][MT * 4][32], one tile at a time
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
  float acc[RN][MT][4];
#pragma unroll
  for (int r = 0; r < RN; ++r)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][mt][i] = 0.f;

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
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = mt * 8 + g;
        uint4 xa = make_uint4(0, 0, 0, 0), xb = xa;
        if (m < M) {
          const __nv_bfloat16* xp = x + (size_t)m * K + (size_t)c * kChunk + 16 * t;
          xa = ld_nc16(xp);
          xb = ld_nc16(xp + 8);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < RN; ++r)
            mma_bf16(acc[r][mt], a[r][j], word(xa, xb, 2 * j), word(xa, xb, 2 * j + 1));
      }
    }
  }

  // Sum the warps' partial tiles in warp order, one 16-channel tile at a
  // time.
#pragma unroll
  for (int r = 0; r < RN; ++r) {
    if (r) __syncthreads();  // the last tile's sums are read
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red_s[(warp * MT * 4 + mt * 4 + i) * 32 + lane] = acc[r][mt][i];
    __syncthreads();
    for (int e = threadIdx.x; e < MT * 4 * 32; e += blockDim.x) {
      float sum = 0.f;
      for (int v = 0; v < warps; ++v) sum += red_s[v * MT * 4 * 32 + e];
      const int i = e >> 5, l = e & 31;
      const int n = n0 + 16 * r + (l >> 2) + ((i & 3) >= 2 ? 8 : 0);
      const int m = (i >> 2) * 8 + 2 * (l & 3) + (i & 1);
      if (m < M) out[(size_t)m * N + n] = __float2bfloat16_rn(sum);
    }
  }
}

// ---- M > 64: 128 channels x 16 * MT rows a CTA ------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint4 lds16(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// The cp.async ring keeps kStages - 1 chunks in flight behind the one the
// warps multiply: a chunk's products take ~0.2 us of the SM, a load ~1 us.
// MT = 8 (139 registers) runs one CTA an SM with a 6-deep ring (160 KB);
// MT = 4 two CTAs an SM with 4-deep rings (70 KB each).
template <int MT>
struct TiledLayout {
  static constexpr int kTileM = 16 * MT;  // 2 warps along M, 8 * MT rows each
  static constexpr int kCtasPerSm = MT >= 8 ? 1 : 2;
  static constexpr int kStages = MT >= 8 ? 6 : 4;
  static constexpr int kWBytes = kTileN * kChunk;
  static constexpr int kXBytes = kTileM * kXRowBytes;
  static constexpr int kStageBytes = kWBytes + kXBytes;
  static constexpr int kSmemBytes = kStages * kStageBytes;
};

// Split K (grid z) where the (N, M) tiles are too few for the card: CTA z
// multiplies chunks [z * cps, (z + 1) * cps) and writes f32 partials to
// part[z] (scratch from the wrapper), which w8a16_reduce_kernel sums in z
// order; with part == nullptr the CTA writes the bf16 output itself.
template <int MT>
__global__ void __launch_bounds__(256, TiledLayout<MT>::kCtasPerSm)
w8a16_tiled_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ part, int M, int N, int K, int cps) {
  using L = TiledLayout<MT>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp & 3, wm = warp >> 2;  // 4 warps along N, 2 along M
  const int g = lane >> 2, t = lane & 3;
  const int n_cta = blockIdx.x * kTileN, m_cta = blockIdx.y * L::kTileM;
  const int c_first = blockIdx.z * cps;
  const int chunks = min(K / kChunk - c_first, cps);  // this CTA's

  float sc[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n_cta + wn * 32 + r * 16 + g + 8 * h;
      sc[r][h] = n < N ? bf16_round(scale[n]) : 0.f;
    }
  float acc[2][MT][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][mt][i] = 0.f;

  auto load = [&](int stage, int local) {
    const int c = c_first + local;
    uint8_t* ws = smem + stage * L::kStageBytes;
    uint8_t* xs = ws + L::kWBytes;
    for (int i = tid; i < kTileN * 4; i += 256) {  // 128 rows x 4 x 16 bytes
      const int row = i >> 2, piece = i & 3, n = n_cta + row;
      cp_async16(ws + row * kChunk + piece * 16,
                 w + (size_t)min(n, N - 1) * K + (size_t)c * kChunk + piece * 16, n < N);
    }
    for (int i = tid; i < L::kTileM * 8; i += 256) {  // rows x 8 x 16 bytes
      const int row = i >> 3, piece = i & 7, m = m_cta + row;
      cp_async16(xs + row * kXRowBytes + piece * 16,
                 x + (size_t)min(m, M - 1) * K + (size_t)c * kChunk + piece * 8, m < M);
    }
  };

#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < chunks) load(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<L::kStages - 2>();
    __syncthreads();  // chunk c has landed; every warp is done with chunk c - 1
    const int next = c + L::kStages - 1;
    if (next < chunks) load(next % L::kStages, next);
    cp_async_commit();

    const uint8_t* ws = smem + (c % L::kStages) * L::kStageBytes;
    const uint8_t* xs = ws + L::kWBytes;
    uint32_t a[2][4][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint8_t* wr = ws + (wn * 32 + r * 16 + g) * kChunk + 16 * t;
      dequant_fragments(lds16(wr), lds16(wr + 8 * kChunk), sc[r][0], sc[r][1], a[r]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint8_t* xr = xs + (wm * 8 * MT + mt * 8 + g) * kXRowBytes + 32 * t;
      const uint4 xa = lds16(xr), xb = lds16(xr + 16);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          mma_bf16(acc[r][mt], a[r][j], word(xa, xb, 2 * j), word(xa, xb, 2 * j + 1));
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n_cta + wn * 32 + r * 16 + g + (i >= 2 ? 8 : 0);
        const int m = m_cta + wm * 8 * MT + mt * 8 + 2 * t + (i & 1);
        if (n >= N || m >= M) continue;
        if (part)
          part[((size_t)blockIdx.z * M + m) * N + n] = acc[r][mt][i];
        else
          out[(size_t)m * N + n] = __float2bfloat16_rn(acc[r][mt][i]);
      }
}

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

template <int MT, int RN>
int launch_skinny(const __nv_bfloat16* x, const int8_t* w, const float* scale,
                  __nv_bfloat16* out, int M, int N, int K, cudaStream_t s) {
  // 16 warps a CTA where the tiles are few (Llama-3-8B's wk and wv: 64
  // CTAs at RN = 1), else 8; the reduction buffer stays within 32 KB.
  const int tiles = N / (16 * RN);
  const int warps = (MT * RN <= 4 && tiles < 264) ? 16 : 8;
  const size_t smem = (size_t)warps * MT * 4 * 32 * sizeof(float);
  w8a16_skinny_kernel<MT, RN><<<tiles, warps * 32, smem, s>>>(x, w, scale, out, M, N, K);
  return (int)cudaGetLastError();
}

template <int MT>
int launch_skinny_rows(const __nv_bfloat16* x, const int8_t* w, const float* scale,
                       __nv_bfloat16* out, int M, int N, int K, cudaStream_t s) {
  // Two tiles a warp from 24 rows up, or where the 32-channel CTAs stay
  // plentiful (w_gate and w_up at 8B: 448); a narrow weight (wk, wv: 32
  // CTAs) keeps one.
  if (N % 32 == 0 && (MT >= 3 || N >= 8192))
    return launch_skinny<MT, 2>(x, w, scale, out, M, N, K, s);
  return launch_skinny<MT, 1>(x, w, scale, out, M, N, K, s);
}

template <int MT>
int launch_tiled(const __nv_bfloat16* x, const int8_t* w, const float* scale,
                 __nv_bfloat16* out, float* part, int M, int N, int K, int splits,
                 cudaStream_t s) {
  using L = TiledLayout<MT>;
  static bool attr_set = false;  // idempotent; a race sets it twice
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        w8a16_tiled_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int chunks = K / kChunk;
  const int cps = (chunks + splits - 1) / splits;
  splits = (chunks + cps - 1) / cps;  // no split without a chunk
  if (splits == 1) part = nullptr;
  const dim3 grid((N + kTileN - 1) / kTileN, (M + L::kTileM - 1) / L::kTileM, splits);
  w8a16_tiled_kernel<MT><<<grid, 256, L::kSmemBytes, s>>>(x, w, scale, out, part, M, N, K,
                                                          cps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const int quads = M * N / 4;
  w8a16_reduce_kernel<<<(quads + 255) / 256, 256, 0, s>>>(
      reinterpret_cast<const float4*>(part), out, quads, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// out[M, N] = x[M, K] @ (bf16(w8) * bf16(scale)), w8 stored [N, K], on
// `stream` (PyTorch's current stream): the skinny kernel for M <= 64, the
// tiled kernel above, with K split `splits` ways (ops/int8_matmul.py's
// gemm_splits) and the reduce kernel after it when splits > 1; `scratch`
// then holds splits * M * N floats from the caller. Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// shape it does not take (K not a multiple of 64, N not a multiple of 16)
// or a split it cannot run.
extern "C" int kubeai_w8a16_gemm(const void* x, const void* w8, const void* scale, void* out,
                                 void* scratch, int M, int N, int K, int splits,
                                 void* stream) {
  if (M <= 0) return 0;
  if (N <= 0 || K <= 0 || K % kChunk != 0 || N % 16 != 0 || splits < 1 ||
      (splits > 1 && (M <= kSkinnyMaxM || scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const int8_t*>(w8);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (M <= kSkinnyMaxM) {
    switch ((M + 7) / 8) {
      case 1: return launch_skinny_rows<1>(xp, wp, sp, op, M, N, K, s);
      case 2: return launch_skinny_rows<2>(xp, wp, sp, op, M, N, K, s);
      case 3: return launch_skinny_rows<3>(xp, wp, sp, op, M, N, K, s);
      case 4: return launch_skinny_rows<4>(xp, wp, sp, op, M, N, K, s);
      case 5: return launch_skinny_rows<5>(xp, wp, sp, op, M, N, K, s);
      case 6: return launch_skinny_rows<6>(xp, wp, sp, op, M, N, K, s);
      case 7: return launch_skinny_rows<7>(xp, wp, sp, op, M, N, K, s);
      default: return launch_skinny_rows<8>(xp, wp, sp, op, M, N, K, s);
    }
  }
  auto* part = static_cast<float*>(scratch);
  // 64-row CTAs (two an SM) while 128-row ones would fill fewer than two
  // waves.
  const long long tiles128 = (long long)((N + kTileN - 1) / kTileN) * ((M + 127) / 128);
  if (tiles128 < 2 * 132) return launch_tiled<4>(xp, wp, sp, op, part, M, N, K, splits, s);
  return launch_tiled<8>(xp, wp, sp, op, part, M, N, K, splits, s);
}
