// Fused paged decode attention over the stacked page pool, for Hopper
// (sm_90a), bf16 in and out: a split page walk and a fixed-order combine.
//
// Replaces the Pallas TPU kernel in kubeai_tpu/ops/paged_attention.py:
// `_paged_fused_pallas` / `_paged_fused_kernel` (B4), entry
// `paged_decode_attention_fused`. One new query token per slot attends over
// the slot's resident K/V pages of ONE layer of the stacked [NL, P, page,
// KVH, D] pool, read in place, plus the new token's own K/V, which is not in
// the pool yet and is merged as one extra column that is always valid.
//
// What bounds it on this card: bytes. G <= 8 query rows per kv head make
// about 4 flops per byte of K/V, far below the ~295 where math would be the
// limit; the least time is the K+V bytes the mask keeps over 3.35 TB/s
// (0.0094 ms at 8 slots x 8 kv heads x old lengths <= 2047). The earlier
// design, one CTA per (slot, kv head) walking the whole table, took 0.40 ms
// there on an H100.
//
// Walk: paged_split_walk.cuh, shared with B1 (paged_decode.cu), with
// kNewColumn set: old keys in [pos + 1 - window, pos), the layer's offset
// into the stacked pool in 64 bits. Its header says what it does about the
// bytes: the walk split across CTAs, a per-warp cp.async ring of 16-token
// tiles, a half-warp dot per token, and a build per group bound (4 or 8).
// Combine: a second kernel, one CTA per (slot, kv head, query row), merges
// the S f32 partials (m, l, acc[G, D]) in a fixed order (four interleaved
// runs of splits, each in split order, then added in order), then the new
// token's column, then normalises. No atomics: two calls give the same
// bits. At pos = 0 no split has a kept key, the new column gets weight
// exp(0) = 1 and the output is v_new exactly; a split with no kept key adds
// nothing. The partials live in scratch the wrapper allocates; the kernels
// allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_split_walk.cuh"

namespace {

// One CTA of kCombineWays * D threads per (slot, kv head, query row g): 1,024
// at D = 256, the most a CTA takes.
// The CTA reduces the row's S partials' max and weighted sum in a fixed
// order and keeps each split's weight in shared memory (S floats). Thread
// (r, d) sums element d over splits r, r + kCombineWays, ... in order; the
// kCombineWays sums then add up in order of r, the new token's column last,
// and thread (0, d) writes out[b, kh * G + g, d].
constexpr int kCombineWays = 4;

template <int D>
__global__ void __launch_bounds__(kCombineWays * D)
paged_fused_combine_kernel(const __nv_bfloat16* __restrict__ q,      // [B, H, D]
                           const __nv_bfloat16* __restrict__ k_new,  // [B, KVH, D]
                           const __nv_bfloat16* __restrict__ v_new,
                           const float* __restrict__ part,
                           __nv_bfloat16* __restrict__ out,          // [B, H, D]
                           int H, int KVH, int S, float scale, float softcap) {
  constexpr int kN = kCombineWays * D;
  constexpr int kCtaWarps = kN / 32;
  extern __shared__ float w_s[];  // [S] each split's weight
  __shared__ float red_s[kCtaWarps];
  __shared__ float sum_s[kCombineWays][D];
  __shared__ float snew_s;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int g = blockIdx.z;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int r = tid / D;
  const int d = tid - r * D;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t new_base = ((size_t)b * KVH + kh) * D;
  const size_t row = ((size_t)b * H + (size_t)kh * G + g) * D;
  const size_t cta0 = ((size_t)b * KVH + kh) * S;
  const size_t n_cta = (size_t)gridDim.y * KVH * S;
  const float* ml = part + cta0 * 2 * G;  // split s: m[G], then l[G]

  // The new token's score for this row.
  if (warp == 0) {
    float x = 0.f;
    for (int e = lane; e < D; e += 32)
      x += __bfloat162float(q[row + e]) * scale * __bfloat162float(k_new[new_base + e]);
    x = warp_sum(x);
    if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
    if (lane == 0) snew_s = x;
  }
  // Max over the splits with a kept key (l > 0) and the new column.
  float mx = kNegInf;
  for (int s = tid; s < S; s += kN)
    if (ml[s * 2 * G + G + g] > 0.f) mx = fmaxf(mx, ml[s * 2 * G + g]);
  mx = warp_max(mx);
  if (lane == 0) red_s[warp] = mx;
  __syncthreads();
  const float s_new = snew_s;
  float mm = s_new;
#pragma unroll
  for (int w = 0; w < kCtaWarps; ++w) mm = fmaxf(mm, red_s[w]);
  __syncthreads();  // red_s is read; reuse it for the sums

  // Each split's weight, and the row's sum.
  float ll = 0.f;
  for (int s = tid; s < S; s += kN) {
    const float ls = ml[s * 2 * G + G + g];
    const float e = ls > 0.f ? expf(ml[s * 2 * G + g] - mm) : 0.f;
    w_s[s] = e;
    ll += ls * e;
  }
  ll = warp_sum(ll);
  if (lane == 0) red_s[warp] = ll;
  __syncthreads();

  // Element d over this thread's share of the splits. A split with no kept
  // key has weight 0 and its acc, never written, is not read.
  const float* pacc = part + n_cta * 2 * G + cta0 * G * D + (size_t)g * D + d;
  float aa = 0.f;
#pragma unroll 4
  for (int s = r; s < S; s += kCombineWays) {
    const float e = w_s[s];
    if (e > 0.f) aa += pacc[(size_t)s * G * D] * e;
  }
  sum_s[r][d] = aa;
  __syncthreads();
  if (r == 0) {
    ll = 0.f;
#pragma unroll
    for (int w = 0; w < kCtaWarps; ++w) ll += red_s[w];
    aa = 0.f;
#pragma unroll
    for (int i = 0; i < kCombineWays; ++i) aa += sum_s[i][d];
    const float pn = expf(s_new - mm);
    ll += pn;
    aa += pn * __bfloat162float(v_new[new_base + d]);
    out[row + d] = __float2bfloat16(aa / fmaxf(ll, 1e-30f));
  }
}

template <int D, int MG>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* kp, const __nv_bfloat16* vp,
           const __nv_bfloat16* kn, const __nv_bfloat16* vn, const int* bt,
           const int* ps, __nv_bfloat16* out, float* part, int B, int H, int KVH,
           int num_pages, int page_size, int max_pages, int layer, int num_splits,
           int pages_per_split, float scale, float softcap, int window,
           cudaStream_t s) {
  constexpr int kSmem = Layout<D, MG>::kSmemBytes;
  // The combine keeps S weights; the wrapper keeps S to a few hundred.
  const size_t combine_smem = (size_t)num_splits * sizeof(float);
  if (combine_smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;  // idempotent; a race sets it twice
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_split_walk_kernel<D, MG, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  paged_split_walk_kernel<D, MG, true><<<dim3(KVH, B, num_splits), kThreads, kSmem, s>>>(
      q, kp, vp, bt, ps, part, H, KVH, num_pages, page_size, max_pages, layer,
      pages_per_split, scale, softcap, window);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_fused_combine_kernel<D><<<dim3(KVH, B, H / KVH), kCombineWays * D, combine_smem, s>>>(
      q, kn, vn, part, out, H, KVH, num_splits, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches two kernels on `stream` (PyTorch's current stream): the split
// walk, then the combine. `scratch` holds B * KVH * num_splits * G * (D + 2)
// floats, allocated by the caller; the kernels allocate nothing. Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// shape the kernels do not take.
extern "C" int kubeai_paged_decode_fused_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_new, const void* v_new,
    const void* block_tables, const void* positions, void* out, void* scratch,
    int B, int H, int KVH, int D, int num_pages, int page_size, int max_pages,
    int layer, int num_splits, int pages_per_split,
    float scale, float softcap, int window, void* stream) {
  if (B <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || H / KVH > kMaxGroup || num_pages <= 0 ||
      page_size <= 0 || max_pages <= 0 || layer < 0 || num_splits <= 0 ||
      pages_per_split <= 0 || pages_per_split > kMaxSplitPages ||
      (long long)num_splits * pages_per_split < max_pages ||
      (long long)max_pages * page_size > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k_pages);
  const auto* vp = static_cast<const __nv_bfloat16*>(v_pages);
  const auto* kn = static_cast<const __nv_bfloat16*>(k_new);
  const auto* vn = static_cast<const __nv_bfloat16*>(v_new);
  const auto* bt = static_cast<const int*>(block_tables);
  const auto* ps = static_cast<const int*>(positions);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* part = static_cast<float*>(scratch);
  // One build per head size (64, 128 and Gemma's 256) and group bound: 4
  // rows (Llama-3, Mistral, Gemma-2-9B) or 8.
  const bool small = H / KVH <= 4;
#define KUBEAI_FUSED_LAUNCH(D_, MG_)                                              \
  return launch<D_, MG_>(qp, kp, vp, kn, vn, bt, ps, op, part, B, H, KVH,       \
                         num_pages, page_size, max_pages, layer, num_splits,   \
                         pages_per_split, scale, softcap, window, s)
  if (D == 128 && small) KUBEAI_FUSED_LAUNCH(128, 4);
  if (D == 128) KUBEAI_FUSED_LAUNCH(128, 8);
  if (D == 64 && small) KUBEAI_FUSED_LAUNCH(64, 4);
  if (D == 64) KUBEAI_FUSED_LAUNCH(64, 8);
  if (D == 256 && small) KUBEAI_FUSED_LAUNCH(256, 4);
  if (D == 256) KUBEAI_FUSED_LAUNCH(256, 8);
#undef KUBEAI_FUSED_LAUNCH
  return (int)cudaErrorInvalidValue;
}
