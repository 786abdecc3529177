// Paged speculative-verify attention for Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas TPU kernel in kubeai_tpu/ops/paged_attention.py:
// `_paged_verify_pallas` / `_paged_verify_kernel` (B3), entry
// `paged_verify_attention`. A window of K query tokens per slot (the last
// emitted token and K - 1 proposals) attends over the slot's resident K/V
// pages through its block table. Query k sits at position pos + k and sees
// the keys at positions <= pos + k, and > pos + k - window when a sliding
// window is set; the window's own K/V are already in the pages. GQA: the G
// query heads of one kv head and the K window tokens make K*G rows.
//
// What bounds it on this card: bytes. Each call reads every resident K/V
// byte of a slot once and does 4 flops per K/V element pair per row, about
// K*G flops per byte (20 at K=5, G=4): far below the ~295 flops/byte where
// the tensor cores become the limit. The least time is the K+V bytes the
// mask keeps over 3.35 TB/s.
//
// Design: B1's (csrc/paged_decode.cu). One CTA (256 threads) per (slot,
// kv head) reads its own block-table row and walks pages first..last,
// where `first` skips pages wholly below query 0's window and `last` is
// the page of the last window token, bounded by the block table (near
// max_seq_len a window reaches past it; those positions were written to
// scratch page 0 and have no keys here, as in the reference). Pages are
// staged in shared memory in 32-token tiles with 16-byte loads; K rows are
// padded by 16 bytes so the 8 lanes of a 16-byte shared-memory phase hit
// disjoint banks. The K*G (<= 64) query rows are staged once in shared
// memory, since B1's registers cannot hold 64 rows.
//   Scores: lane t of every warp owns token t of the tile, warp w owns rows
//   w, w + 8, ...; a lane's dot products need no shuffles. The online
//   softmax of a row then lives in the registers of its warp (m and l per
//   row, f32), with one max and one sum shuffle-reduction per row and tile.
//   Each row has its own causal edge pos + row/G and window edge. A masked
//   entry gets P = 0, so a row masked everywhere writes 0 (as the TPU
//   kernel's zero_masked_p does).
//   P.V: each thread owns one head dim of D and rows r0, r0 + 256/D, ...,
//   with the f32 accumulators in registers; the output is written once, in
//   bf16, in the [B, K, H, D] layout the caller gave, so no transposes.
//
// Known limit, as B1's: 64 CTAs at 8 slots x 8 kv heads for 132 SMs, and
// no overlap of loads with math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                         // tokens per tile, one per lane
constexpr int kMaxRows = 64;                      // K * G rows per kv head
constexpr int kRowsPerWarp = kMaxRows / kWarps;   // score rows per warp
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

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_verify_kernel(const __nv_bfloat16* __restrict__ q,        // [B, K, H, D]
                    const __nv_bfloat16* __restrict__ k_pages,  // [P, page, KVH, D]
                    const __nv_bfloat16* __restrict__ v_pages,
                    const int* __restrict__ block_tables,       // [B, MP]
                    const int* __restrict__ positions,          // [B]
                    __nv_bfloat16* __restrict__ out,            // [B, K, H, D]
                    int K, int H, int KVH, int page_size, int max_pages,
                    float scale, float softcap, int window) {
  constexpr int kChunks = D / 8;          // 16-byte chunks per token row
  constexpr int kKStride = D + 8;         // padded K row in shared memory
  constexpr int kRowStep = kThreads / D;  // rows per pass in p.v
  constexpr int kAccRows = kMaxRows / kRowStep;

  __shared__ __align__(16) __nv_bfloat16 q_s[kMaxRows * D];
  __shared__ __align__(16) __nv_bfloat16 k_s[kTile * kKStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[kTile * D];
  __shared__ float p_s[kMaxRows * kTile];
  __shared__ float alpha_s[kMaxRows];
  __shared__ float l_s[kMaxRows];

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KVH;
  const int R = K * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pos = positions[b];
  const int end = pos + K;  // keys exist at positions < pos + K
  // Pages holding window keys, bounded by the block table.
  const int n_pages = min((end + page_size - 1) / page_size, max_pages);
  // First page with a key inside query 0's window (0 when it is off).
  const int first = window > 0 ? max(pos - window + 1, 0) / page_size : 0;
  const size_t tok_stride = (size_t)KVH * D;  // elements between tokens

  // Row r is window token r / G and query head kh * G + r % G.
  for (int i = tid; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const size_t src =
        (((size_t)b * K + r / G) * H + (size_t)kh * G + r % G) * D + c * 8;
    reinterpret_cast<uint4*>(q_s)[r * kChunks + c] =
        *reinterpret_cast<const uint4*>(q + src);
  }
  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
  }
  const int d_own = tid % D;
  const int r_own = tid / D;
  float acc[kAccRows];
#pragma unroll
  for (int j = 0; j < kAccRows; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int p = first; p < n_pages; ++p) {
    const int page_id = max(block_tables[(size_t)b * max_pages + p], 0);
    const size_t page_base = (size_t)page_id * page_size;
    for (int t0 = 0; t0 < page_size; t0 += kTile) {
      const int pos0 = p * page_size + t0;
      if (pos0 >= end) break;
      const int n = min(kTile, page_size - t0);

      // Stage n token rows of this kv head: [n, D] for K and for V.
      for (int i = tid; i < n * kChunks; i += kThreads) {
        const int t = i / kChunks;
        const int c = i - t * kChunks;
        const size_t src = (page_base + t0 + t) * tok_stride + (size_t)kh * D + c * 8;
        *reinterpret_cast<uint4*>(k_s + t * kKStride + c * 8) =
            *reinterpret_cast<const uint4*>(k_pages + src);
        reinterpret_cast<uint4*>(v_s)[t * kChunks + c] =
            *reinterpret_cast<const uint4*>(v_pages + src);
      }
      __syncthreads();

      // Scores: this lane's token against this warp's rows.
      float s[kRowsPerWarp];
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) s[j] = 0.f;
      if (lane < n) {
        for (int c = 0; c < kChunks; ++c) {
          float kf[8];
          unpack8(*reinterpret_cast<const uint4*>(k_s + lane * kKStride + c * 8), kf);
#pragma unroll
          for (int j = 0; j < kRowsPerWarp; ++j) {
            const int r = warp + j * kWarps;
            if (r < R) {
              float qf[8];
              unpack8(reinterpret_cast<const uint4*>(q_s)[r * kChunks + c], qf);
#pragma unroll
              for (int e = 0; e < 8; ++e) s[j] += qf[e] * kf[e];
            }
          }
        }
      }

      // Online softmax of each of this warp's rows over the tile.
      const int col = pos0 + lane;
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const int r = warp + j * kWarps;
        if (r < R) {
          const int q_abs = pos + r / G;
          const bool valid = lane < n && col <= q_abs &&
                             (window <= 0 || col > q_abs - window);
          float sv = s[j] * scale;
          if (softcap > 0.f) sv = tanhf(sv / softcap) * softcap;
          sv = valid ? sv : kNegInf;
          const float m_new = fmaxf(m[j], warp_max(sv));
          const float pr = valid ? expf(sv - m_new) : 0.f;
          const float alpha = expf(m[j] - m_new);
          l[j] = l[j] * alpha + warp_sum(pr);
          m[j] = m_new;
          p_s[r * kTile + lane] = pr;
          if (lane == 0) alpha_s[r] = alpha;
        }
      }
      __syncthreads();

      // acc = acc * alpha + p . V, one head dim per thread.
#pragma unroll
      for (int j = 0; j < kAccRows; ++j) {
        const int r = r_own + j * kRowStep;
        if (r < R) {
          float a = acc[j] * alpha_s[r];
          for (int t = 0; t < n; ++t)
            a += p_s[r * kTile + t] * __bfloat162float(v_s[t * D + d_own]);
          acc[j] = a;
        }
      }
      __syncthreads();
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = warp + j * kWarps;
      if (r < R) l_s[r] = l[j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kAccRows; ++j) {
    const int r = r_own + j * kRowStep;
    if (r < R) {
      const size_t dst =
          (((size_t)b * K + r / G) * H + (size_t)kh * G + r % G) * D + d_own;
      out[dst] = __float2bfloat16(acc[j] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream); allocates nothing.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a shape the kernel does not take.
extern "C" int kubeai_paged_verify_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* positions, void* out,
    int B, int K, int H, int KVH, int D, int page_size, int max_pages,
    float scale, float softcap, int window, void* stream) {
  if (B <= 0) return 0;
  if (K <= 0 || KVH <= 0 || H % KVH != 0 || K * (H / KVH) > kMaxRows ||
      page_size <= 0 || max_pages <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(KVH, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k_pages);
  const auto* vp = static_cast<const __nv_bfloat16*>(v_pages);
  const auto* bt = static_cast<const int*>(block_tables);
  const auto* ps = static_cast<const int*>(positions);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D == 128) {
    paged_verify_kernel<128><<<grid, kThreads, 0, s>>>(
        qp, kp, vp, bt, ps, op, K, H, KVH, page_size, max_pages, scale,
        softcap, window);
  } else if (D == 64) {
    paged_verify_kernel<64><<<grid, kThreads, 0, s>>>(
        qp, kp, vp, bt, ps, op, K, H, KVH, page_size, max_pages, scale,
        softcap, window);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
