// Fused paged decode attention over the stacked page pool, for Hopper
// (sm_90a), bf16 in and out.
//
// Replaces the Pallas TPU kernel in kubeai_tpu/ops/paged_attention.py:
// `_paged_fused_pallas` / `_paged_fused_kernel` (B4), entry
// `paged_decode_attention_fused`. One new query token per slot attends over
// the slot's resident K/V pages of ONE layer of the stacked [NL, P, page,
// KVH, D] pool, read in place (no per-layer slice), plus the new token's own
// K/V, which is not in the pool yet and is merged as one extra column that
// is always valid. The caller writes every layer's new K/V in one scatter
// after the layer loop. GQA, optional tanh softcap and sliding window.
//
// What bounds it on this card: bytes, as B1. Each step reads every resident
// K/V byte of the layer once, about G flops per byte; the least time is the
// K+V bytes the mask keeps over 3.35 TB/s.
//
// Design: B1's (csrc/paged_decode.cu) with three changes.
//   - Layer offset: the pool pointers move by layer * P * page * KVH * D
//     elements, computed in 64 bits (one layer of an 8B-shape pool is tens
//     of MB, the stack GBs).
//   - Which tokens count: the old tokens are those at positions < pos (the
//     new token's position); the window keeps keys >= pos + 1 - window. The
//     page walk stops at ceil(pos / page), bounded by the block table. A
//     masked entry gets P = 0.
//   - New token: after the page walk, each query row's score against k_new
//     joins the online softmax once and v_new joins the accumulator, then
//     the rows are normalised. At pos = 0 there are no old tokens and the
//     output is exactly v_new.
// One CTA (128 threads) per (slot, kv head); 64-token tiles staged in
// shared memory with 16-byte loads; the G query rows in registers, scaled,
// in f32; m, l and the accumulator in f32.
//
// Known limit, as B1's: 64 CTAs at 8 slots x 8 kv heads for 132 SMs, and
// no overlap of loads with math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
paged_decode_fused_kernel(const __nv_bfloat16* __restrict__ q,        // [B, H, D]
                          const __nv_bfloat16* __restrict__ k_pages,  // [NL, P, page, KVH, D]
                          const __nv_bfloat16* __restrict__ v_pages,
                          const __nv_bfloat16* __restrict__ k_new,    // [B, KVH, D]
                          const __nv_bfloat16* __restrict__ v_new,
                          const int* __restrict__ block_tables,       // [B, MP]
                          const int* __restrict__ positions,          // [B] old lengths
                          __nv_bfloat16* __restrict__ out,            // [B, H, D]
                          int H, int KVH, int num_pages, int page_size,
                          int max_pages, int layer, float scale, float softcap,
                          int window) {
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
  __shared__ float pnew_s[kMaxGroup];

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pos = positions[b];  // old tokens sit at positions < pos
  const int n_pages = min((pos + page_size - 1) / page_size, max_pages);
  // First in-window key position, and its page (0 when the window is off).
  const int lo = window > 0 ? max(pos + 1 - window, 0) : 0;
  const int first = lo / page_size;
  const size_t tok_stride = (size_t)KVH * D;  // elements between tokens
  const size_t layer_off = (size_t)layer * num_pages * page_size * tok_stride;
  const __nv_bfloat16* kl = k_pages + layer_off;
  const __nv_bfloat16* vl = v_pages + layer_off;

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
      if (pos0 >= pos) break;
      const int n = min(kTile, page_size - t0);

      // Stage n token rows of this kv head: [n, D] for K and for V.
      for (int i = tid; i < n * kChunks; i += kThreads) {
        const int t = i / kChunks;
        const int c = i - t * kChunks;
        const size_t src = (page_base + t0 + t) * tok_stride + (size_t)kh * D + c * 8;
        reinterpret_cast<uint4*>(k_s)[t * kChunks + c] =
            *reinterpret_cast<const uint4*>(kl + src);
        reinterpret_cast<uint4*>(v_s)[t * kChunks + c] =
            *reinterpret_cast<const uint4*>(vl + src);
      }
      __syncthreads();

      // Scores: warp w takes tokens w, w + 4, ...; each lane holds
      // kElems head dims and the warp reduces the dot products.
      for (int t = warp; t < n; t += kWarps) {
        float kf[kElems];
#pragma unroll
        for (int e = 0; e < kElems; ++e)
          kf[e] = __bfloat162float(k_s[t * D + lane * kElems + e]);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < G) {
            float s = 0.f;
#pragma unroll
            for (int e = 0; e < kElems; ++e) s += qr[g][e] * kf[e];
            s = warp_sum(s);
            if (lane == 0) {
              if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
              p_s[g * kTile + t] = s;
            }
          }
        }
      }
      __syncthreads();

      // Online softmax: warp w takes query rows w, w + 4; each lane
      // covers tokens lane and lane + 32 of the tile. Masked entries
      // score NEG_INF and get P = 0.
      const bool ok0 = lane < n && pos0 + lane < pos && pos0 + lane >= lo;
      const bool ok1 =
          lane + 32 < n && pos0 + lane + 32 < pos && pos0 + lane + 32 >= lo;
      for (int g = warp; g < G; g += kWarps) {
        const float s0 = ok0 ? p_s[g * kTile + lane] : kNegInf;
        const float s1 = ok1 ? p_s[g * kTile + lane + 32] : kNegInf;
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
        const float e0 = ok0 ? expf(s0 - m_new) : 0.f;
        const float e1 = ok1 ? expf(s1 - m_new) : 0.f;
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

  // The new token: one more column, always valid (it is the query's own
  // position, inside any window). Warp w scores rows w, w + 4.
  const size_t new_base = ((size_t)b * KVH + kh) * D;
  float kn[kElems];
#pragma unroll
  for (int e = 0; e < kElems; ++e)
    kn[e] = __bfloat162float(k_new[new_base + lane * kElems + e]);
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < G && g % kWarps == warp) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < kElems; ++e) s += qr[g][e] * kn[e];
      s = warp_sum(s);
      if (lane == 0) {
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        const float m_old = m_s[g];
        const float m_fin = fmaxf(m_old, s);
        const float pn = expf(s - m_fin);
        const float alpha = expf(m_old - m_fin);
        alpha_s[g] = alpha;
        pnew_s[g] = pn;
        l_s[g] = l_s[g] * alpha + pn;
      }
    }
  }
  __syncthreads();

  const float vn = __bfloat162float(v_new[new_base + d_own]);
#pragma unroll
  for (int j = 0; j < kAccRows; ++j) {
    const int g = g_own + j * kRowStep;
    if (g < G) {
      const float a = acc[j] * alpha_s[g] + pnew_s[g] * vn;
      out[((size_t)b * H + (size_t)kh * G + g) * D + d_own] =
          __float2bfloat16(a / fmaxf(l_s[g], 1e-30f));
    }
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream); allocates nothing.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a shape the kernel does not take.
extern "C" int kubeai_paged_decode_fused_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_new, const void* v_new,
    const void* block_tables, const void* positions, void* out,
    int B, int H, int KVH, int D, int num_pages, int page_size, int max_pages,
    int layer, float scale, float softcap, int window, void* stream) {
  if (B <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || H / KVH > kMaxGroup || num_pages <= 0 ||
      page_size <= 0 || max_pages <= 0 || layer < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(KVH, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k_pages);
  const auto* vp = static_cast<const __nv_bfloat16*>(v_pages);
  const auto* kn = static_cast<const __nv_bfloat16*>(k_new);
  const auto* vn = static_cast<const __nv_bfloat16*>(v_new);
  const auto* bt = static_cast<const int*>(block_tables);
  const auto* ps = static_cast<const int*>(positions);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D == 128) {
    paged_decode_fused_kernel<128><<<grid, kThreads, 0, s>>>(
        qp, kp, vp, kn, vn, bt, ps, op, H, KVH, num_pages, page_size,
        max_pages, layer, scale, softcap, window);
  } else if (D == 64) {
    paged_decode_fused_kernel<64><<<grid, kThreads, 0, s>>>(
        qp, kp, vp, kn, vn, bt, ps, op, H, KVH, num_pages, page_size,
        max_pages, layer, scale, softcap, window);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
