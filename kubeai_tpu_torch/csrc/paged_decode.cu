// Paged decode attention for Hopper (sm_90a), bf16 in and out: a split page
// walk and a fixed-order combine.
//
// Replaces the Pallas TPU kernel in kubeai_tpu/ops/paged_attention.py:
// `_paged_pallas` / `_paged_kernel` (B1), entry `paged_decode_attention`.
// One new query token per slot attends over the slot's resident K/V pages
// through its block table, the new token's own K/V among them, with GQA (G
// query heads share one kv head), an optional tanh softcap and an optional
// sliding window: keys in [max(len - window, 0), min(len, MP * page)). A
// length past the block table keeps only the table's keys, as the TPU
// kernel's (B, MP) grid does, and a slot with no kept key writes 0.
//
// What bounds it on this card: bytes. Each call reads every kept K/V byte
// once and does 4 flops per K/V element pair per query head, about G flops
// per byte: far below the ~295 flops/byte where the tensor cores become the
// limit. At 8 slots x 8 kv heads x lengths <= 2048 that is 41.8 MB, a bound
// of 0.0125 ms at 3.35 TB/s. The first design, one CTA (128 threads) per
// (slot, kv head) walking the whole table, took 0.387 ms there on an H100:
// 64 CTAs for 132 SMs, no loads in flight during math, four barriers a
// 64-token tile, and a p.V loop serial over the tile.
//
// Walk: paged_split_walk.cuh, shared with B4 (paged_decode_fused.cu), with
// kNewColumn unset, on a one-layer [P, page, KVH, D] pool. Its header says
// what it does about the bytes: the walk split across CTAs as fused_split
// chooses (8 splits of 4 pages, 512 CTAs, at the case above), a per-warp
// cp.async ring of 16-token tiles, a half-warp dot per token, and a build
// per group bound (4 for Llama-3 and Mistral, or 8).
// Combine: a second kernel, one warp per (slot, kv head, query row, 32 head
// dims), merges the S f32 partials (m, l, acc) in split order, the loads of
// 32 splits' acc in flight at once, and normalises. No atomics: two calls
// give the same bits. A split where the row keeps no key (l = 0) adds
// nothing; a row with no kept key in any split (length 0, or a window
// wholly past the table) writes 0, as the TPU kernel's finalize does. It
// merges no extra column: the new token is in the pool. The partials live
// in scratch the wrapper allocates; the kernels allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_split_walk.cuh"

namespace {

// One warp per (slot, kv head, row g, 32 head dims), kCombineWarps warps a
// CTA. Lane i holds the (m, l) of splits i, i + 32, ...; the row's max over
// the splits with a kept key (l > 0) and its sum l are butterfly
// reductions, which every warp of the row computes alike. Lane i then adds
// its head dim of every split's acc in split order, with the loads of 32
// splits in flight at once. A split where the row keeps no key has weight 0
// and its acc, never written, is read but not used.
constexpr int kCombineWarps = 4;

template <int D>
__global__ void __launch_bounds__(kCombineWarps * 32)
paged_decode_combine_kernel(const float* __restrict__ part,
                            __nv_bfloat16* __restrict__ out,  // [B, H, D]
                            int H, int KVH, int S) {
  constexpr int kChunks = D / 32;  // warps a row
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.z * kCombineWarps + (threadIdx.x >> 5);
  const int G = H / KVH;
  const int g = w / kChunks;
  if (g >= G) return;
  const int d = (w % kChunks) * 32 + lane;
  const size_t cta0 = ((size_t)b * KVH + kh) * S;
  const size_t n_cta = (size_t)gridDim.y * KVH * S;
  const float* ml = part + cta0 * 2 * G + g;  // split s: m at s * 2G, l at + G
  const float* acc = part + n_cta * 2 * G + cta0 * G * D + (size_t)g * D + d;

  float mx = kNegInf;
  for (int s = lane; s < S; s += 32) {
    const float m = ml[(size_t)s * 2 * G];
    if (ml[(size_t)s * 2 * G + G] > 0.f) mx = fmaxf(mx, m);
  }
  mx = warp_max(mx);
  float ll = 0.f, aa = 0.f;
  for (int s0 = 0; s0 < S; s0 += 32) {
    float wt = 0.f;
    if (s0 + lane < S) {
      const float ls = ml[(size_t)(s0 + lane) * 2 * G + G];
      wt = ls > 0.f ? expf(ml[(size_t)(s0 + lane) * 2 * G] - mx) : 0.f;
      ll += ls * wt;
    }
    const int n = min(32, S - s0);
    float x[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) x[j] = j < n ? acc[(size_t)(s0 + j) * G * D] : 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float wj = __shfl_sync(0xffffffffu, wt, j);
      aa += wj > 0.f ? x[j] * wj : 0.f;
    }
  }
  ll = warp_sum(ll);
  // No kept key in any split: ll = aa = 0 and the row writes 0.
  out[((size_t)b * H + (size_t)kh * G + g) * D + d] =
      __float2bfloat16(aa / fmaxf(ll, 1e-30f));
}

template <int D, int MG>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* kp, const __nv_bfloat16* vp,
           const int* bt, const int* ln, __nv_bfloat16* out, float* part, int B, int H,
           int KVH, int page_size, int max_pages, int num_splits, int pages_per_split,
           float scale, float softcap, int window, cudaStream_t s) {
  constexpr int kSmem = Layout<D, MG>::kSmemBytes;
  static bool attr_set = false;  // idempotent; a race sets it twice
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(paged_split_walk_kernel<D, MG, false>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  // A one-layer pool: layer 0, so the layer offset is 0 whatever the pool's
  // page count.
  paged_split_walk_kernel<D, MG, false><<<dim3(KVH, B, num_splits), kThreads, kSmem, s>>>(
      q, kp, vp, bt, ln, part, H, KVH, /*num_pages=*/0, page_size, max_pages,
      /*layer=*/0, pages_per_split, scale, softcap, window);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int warps = H / KVH * (D / 32);
  paged_decode_combine_kernel<D>
      <<<dim3(KVH, B, (warps + kCombineWarps - 1) / kCombineWarps), kCombineWarps * 32, 0, s>>>(
          part, out, H, KVH, num_splits);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches two kernels on `stream` (PyTorch's current stream): the split
// walk, then the combine. `scratch` holds B * KVH * num_splits * G * (D + 2)
// floats, allocated by the caller; the kernels allocate nothing. Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// shape the kernels do not take.
extern "C" int kubeai_paged_decode_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* lengths, void* out, void* scratch,
    int B, int H, int KVH, int D, int page_size, int max_pages,
    int num_splits, int pages_per_split, float scale, float softcap, int window,
    void* stream) {
  if (B <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || H / KVH > kMaxGroup || page_size <= 0 ||
      max_pages <= 0 || num_splits <= 0 || pages_per_split <= 0 ||
      pages_per_split > kMaxSplitPages ||
      (long long)num_splits * pages_per_split < max_pages ||
      (long long)(max_pages + pages_per_split) * page_size > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k_pages);
  const auto* vp = static_cast<const __nv_bfloat16*>(v_pages);
  const auto* bt = static_cast<const int*>(block_tables);
  const auto* ln = static_cast<const int*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* part = static_cast<float*>(scratch);
  // One build per head size and group bound: 4 rows (Llama-3, Mistral) or 8.
  const bool small = H / KVH <= 4;
#define KUBEAI_DECODE_LAUNCH(D_, MG_)                                               \
  return launch<D_, MG_>(qp, kp, vp, bt, ln, op, part, B, H, KVH, page_size,       \
                         max_pages, num_splits, pages_per_split, scale, softcap, \
                         window, s)
  if (D == 128 && small) KUBEAI_DECODE_LAUNCH(128, 4);
  if (D == 128) KUBEAI_DECODE_LAUNCH(128, 8);
  if (D == 64 && small) KUBEAI_DECODE_LAUNCH(64, 4);
  if (D == 64) KUBEAI_DECODE_LAUNCH(64, 8);
#undef KUBEAI_DECODE_LAUNCH
  return (int)cudaErrorInvalidValue;
}
