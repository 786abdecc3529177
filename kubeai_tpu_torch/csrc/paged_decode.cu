// Paged decode attention for Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas TPU kernel in kubeai_tpu/ops/paged_attention.py:
// `_paged_pallas` / `_paged_kernel` (B1), entry `paged_decode_attention`.
// One new query token per slot attends over the slot's resident K/V
// pages through its block table, with GQA (G query heads share one kv
// head), an optional tanh softcap and an optional sliding window.
//
// What bounds it on this card: bytes. Each step reads every resident
// K/V byte once and does 4 flops per K/V element pair per query head,
// about G flops per byte: far below the ~295 flops/byte where the
// tensor cores become the limit. The least time is the resident K+V
// bytes over 3.35 TB/s.
//
// Design: one CTA (128 threads) per (slot, kv head). The CTA reads its
// own block-table row and walks pages first..ceil(len/page)-1, where
// `first` skips pages wholly below the sliding window. Each page is
// staged in shared memory in tiles of up to 64 tokens ([tile, D] bf16
// for K and for V, 16 KB each at D=128), loaded with 16-byte vector
// reads so every token row is one coalesced 2*D-byte segment. The G
// query rows live in registers, scaled, in f32. Scores are per-warp dot
// products reduced with shuffles; the online softmax keeps m and l per
// query row in f32 and the output accumulator in f32 registers (one
// head dim per thread). The output is written once, in bf16.
//
// Known limit: at 8 slots x 8 kv heads the grid is 64 CTAs for 132 SMs,
// so the card is under-filled and each CTA streams its pages with no
// overlap of loads and math. Splitting the page range across CTAs
// (flash-decoding) and asynchronous copies are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;      // tokens staged in shared memory at a time
constexpr int kMaxGroup = 8;   // query heads per kv head
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

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,        // [B, H, D]
                    const __nv_bfloat16* __restrict__ k_pages,  // [P, page, KVH, D]
                    const __nv_bfloat16* __restrict__ v_pages,
                    const int* __restrict__ block_tables,       // [B, MP]
                    const int* __restrict__ lengths,            // [B]
                    __nv_bfloat16* __restrict__ out,            // [B, H, D]
                    int H, int KVH, int page_size, int max_pages,
                    float scale, float softcap, int window) {
  constexpr int kElems = D / 32;          // head dims per lane in q.k
  constexpr int kChunks = D / 8;          // 16-byte chunks per token row
  constexpr int kRowStep = kThreads / D;  // query rows per pass in p.v
  constexpr int kAccRows = kMaxGroup / kRowStep;

  __shared__ __align__(16) __nv_bfloat16 k_s[kTile * D];
  __shared__ __align__(16) __nv_bfloat16 v_s[kTile * D];
  __shared__ float p_s[kMaxGroup * kTile];
  __shared__ float m_s[kMaxGroup];
  __shared__ float l_s[kMaxGroup];
  __shared__ float alpha_s[kMaxGroup];

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int length = lengths[b];
  const int n_pages = (length + page_size - 1) / page_size;
  // First page holding an in-window key (0 when the window is off).
  const int first = window > 0 ? max(length - window, 0) / page_size : 0;
  const size_t tok_stride = (size_t)KVH * D;  // elements between tokens

  float qr[kMaxGroup][kElems];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      qr[g][e] = g < G
          ? __bfloat162float(
                q[((size_t)b * H + (size_t)kh * G + g) * D + lane * kElems + e]) *
                scale
          : 0.f;
    }
  }
  if (tid < kMaxGroup) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const int d_own = tid % D;
  const int g_own = tid / D;
  float acc[kAccRows];
#pragma unroll
  for (int j = 0; j < kAccRows; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int p = first; p < n_pages; ++p) {
    const int page_id = max(block_tables[(size_t)b * max_pages + p], 0);
    const size_t page_base = (size_t)page_id * page_size;
    for (int t0 = 0; t0 < page_size; t0 += kTile) {
      const int pos0 = p * page_size + t0;
      if (pos0 >= length) break;
      const int n = min(kTile, page_size - t0);

      // Stage n token rows of this kv head: [n, D] for K and for V.
      for (int i = tid; i < n * kChunks; i += kThreads) {
        const int t = i / kChunks;
        const int c = i - t * kChunks;
        const size_t src = (page_base + t0 + t) * tok_stride + (size_t)kh * D + c * 8;
        reinterpret_cast<uint4*>(k_s)[t * kChunks + c] =
            *reinterpret_cast<const uint4*>(k_pages + src);
        reinterpret_cast<uint4*>(v_s)[t * kChunks + c] =
            *reinterpret_cast<const uint4*>(v_pages + src);
      }
      __syncthreads();

      // Scores: warp w takes tokens w, w + 4, ...; each lane holds
      // kElems head dims and the warp reduces the dot products.
      for (int t = warp; t < n; t += kWarps) {
        float kf[kElems];
#pragma unroll
        for (int e = 0; e < kElems; ++e)
          kf[e] = __bfloat162float(k_s[t * D + lane * kElems + e]);
        const int pos = pos0 + t;
        const bool valid =
            pos < length && (window <= 0 || pos >= length - window);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < G) {
            float s = 0.f;
#pragma unroll
            for (int e = 0; e < kElems; ++e) s += qr[g][e] * kf[e];
            s = warp_sum(s);
            if (lane == 0) {
              if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
              p_s[g * kTile + t] = valid ? s : kNegInf;
            }
          }
        }
      }
      __syncthreads();

      // Online softmax: warp w takes query rows w, w + 4; each lane
      // covers tokens lane and lane + 32 of the tile.
      for (int g = warp; g < G; g += kWarps) {
        const float s0 = lane < n ? p_s[g * kTile + lane] : -CUDART_INF_F;
        const float s1 = lane + 32 < n ? p_s[g * kTile + lane + 32] : -CUDART_INF_F;
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
        const float e0 = lane < n ? expf(s0 - m_new) : 0.f;
        const float e1 = lane + 32 < n ? expf(s1 - m_new) : 0.f;
        if (lane < n) p_s[g * kTile + lane] = e0;
        if (lane + 32 < n) p_s[g * kTile + lane + 32] = e1;
        const float sum = warp_sum(e0 + e1);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          alpha_s[g] = alpha;
          l_s[g] = l_s[g] * alpha + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();

      // acc = acc * alpha + p . V, one head dim per thread.
#pragma unroll
      for (int j = 0; j < kAccRows; ++j) {
        const int g = g_own + j * kRowStep;
        if (g < G) {
          float a = acc[j] * alpha_s[g];
          for (int t = 0; t < n; ++t)
            a += p_s[g * kTile + t] * __bfloat162float(v_s[t * D + d_own]);
          acc[j] = a;
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < kAccRows; ++j) {
    const int g = g_own + j * kRowStep;
    if (g < G) {
      out[((size_t)b * H + (size_t)kh * G + g) * D + d_own] =
          __float2bfloat16(acc[j] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream); allocates nothing.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a shape the kernel does not take.
extern "C" int kubeai_paged_decode_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* lengths, void* out,
    int B, int H, int KVH, int D, int page_size, int max_pages,
    float scale, float softcap, int window, void* stream) {
  if (B <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || H / KVH > kMaxGroup || page_size <= 0 ||
      max_pages <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(KVH, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k_pages);
  const auto* vp = static_cast<const __nv_bfloat16*>(v_pages);
  const auto* bt = static_cast<const int*>(block_tables);
  const auto* ln = static_cast<const int*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D == 128) {
    paged_decode_kernel<128><<<grid, kThreads, 0, s>>>(
        qp, kp, vp, bt, ln, op, H, KVH, page_size, max_pages, scale, softcap,
        window);
  } else if (D == 64) {
    paged_decode_kernel<64><<<grid, kThreads, 0, s>>>(
        qp, kp, vp, bt, ln, op, H, KVH, page_size, max_pages, scale, softcap,
        window);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
