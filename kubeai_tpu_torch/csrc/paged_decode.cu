// Paged decode attention for Hopper (sm_90a), bf16 in and out: a split page
// walk and a fixed-order combine, over bf16 pages or int8 pages with their
// per-token scales.
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
//
// Int8 pool (`kubeai_paged_decode_int8`): the JAX package attends over an
// int8 pool (kubeai_tpu/ops/kv_quant.py) only through its reference path
// (kubeai_tpu/ops/paged_attention.py, `ref_paged_decode_attention`), whose
// gather of every page into a dense f32 view would cost the step ~20x B1's
// time here. This entry runs a walk of its own, designed for int8 rows
// (paged_split_walk_int8.cuh: the score on tensor cores with one scale per
// dot, V's scale folded into P, a split from the wrapper's int8_split and a
// deeper ring), with B1's combine, partial layout and edge rules, at D 64,
// 128 and 256. Its bound is the kept rows' D + 4 bytes each against
// bf16's 2D, about half of B1's at D = 128 and 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_split_walk.cuh"
#include "paged_split_walk_int8.cuh"

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

// Sets a kernel's dynamic shared memory bound once; idempotent, so a race
// sets it twice.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done = true;
  return e;
}

template <int D, int MG, bool kInt8>
int launch(const __nv_bfloat16* q, const void* kp, const void* vp, const float* ks,
           const float* vs, const int* bt, const int* ln, __nv_bfloat16* out, float* part,
           int B, int H, int KVH, int page_size, int max_pages, int num_splits,
           int pages_per_split, float scale, float softcap, int window, cudaStream_t s) {
  if constexpr (kInt8) {
    using W = int8_walk::Layout<D, MG>;
    static bool attr_set = false;
    const cudaError_t a = allow_smem(int8_walk::paged_split_walk_int8_kernel<D, MG>,
                                     W::kSmemBytes, attr_set);
    if (a != cudaSuccess) return (int)a;
    int8_walk::paged_split_walk_int8_kernel<D, MG>
        <<<dim3(KVH, B, num_splits), int8_walk::kThreads, W::kSmemBytes, s>>>(
            q, static_cast<const int8_t*>(kp), static_cast<const int8_t*>(vp), ks, vs, bt, ln,
            part, H, KVH, page_size, max_pages, pages_per_split, scale, softcap, window);
  } else {
    constexpr int kSmem = Layout<D, MG>::kSmemBytes;
    static bool attr_set = false;
    const cudaError_t a = allow_smem(paged_split_walk_kernel<D, MG, false>, kSmem, attr_set);
    if (a != cudaSuccess) return (int)a;
    // A one-layer pool: layer 0, so the layer offset is 0 whatever the
    // pool's page count.
    paged_split_walk_kernel<D, MG, false><<<dim3(KVH, B, num_splits), kThreads, kSmem, s>>>(
        q, static_cast<const __nv_bfloat16*>(kp), static_cast<const __nv_bfloat16*>(vp), bt,
        ln, part, H, KVH, /*num_pages=*/0, page_size, max_pages, /*layer=*/0,
        pages_per_split, scale, softcap, window);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int warps = H / KVH * (D / 32);
  paged_decode_combine_kernel<D>
      <<<dim3(KVH, B, (warps + kCombineWarps - 1) / kCombineWarps), kCombineWarps * 32, 0, s>>>(
          part, out, H, KVH, num_splits);
  return (int)cudaGetLastError();
}

// The checks and the build choice both entries share: one build per head
// size (64, 128, 256) and group bound, 4 rows (Llama-3, Mistral,
// Gemma-7B, Gemma-2-9B) or 8.
template <bool kInt8>
int dispatch(const void* q, const void* k_pages, const void* v_pages, const float* ks,
             const float* vs, const void* block_tables, const void* lengths, void* out,
             void* scratch, int B, int H, int KVH, int D, int page_size, int max_pages,
             int num_splits, int pages_per_split, float scale, float softcap, int window,
             void* stream) {
  constexpr int kMaxPages = kInt8 ? int8_walk::kMaxSplitPages : kMaxSplitPages;
  constexpr int kGroup = kInt8 ? int8_walk::kMaxGroup : kMaxGroup;
  if (B <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || H / KVH > kGroup || page_size <= 0 ||
      max_pages <= 0 || num_splits <= 0 || pages_per_split <= 0 ||
      pages_per_split > kMaxPages ||
      (long long)num_splits * pages_per_split < max_pages ||
      (long long)(max_pages + pages_per_split) * page_size > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* bt = static_cast<const int*>(block_tables);
  const auto* ln = static_cast<const int*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* part = static_cast<float*>(scratch);
  const bool small = H / KVH <= 4;
#define KUBEAI_DECODE_LAUNCH(D_, MG_)                                                   \
  return launch<D_, MG_, kInt8>(qp, k_pages, v_pages, ks, vs, bt, ln, op, part, B, H,  \
                                KVH, page_size, max_pages, num_splits, pages_per_split, \
                                scale, softcap, window, s)
  if (D == 128 && small) KUBEAI_DECODE_LAUNCH(128, 4);
  if (D == 128) KUBEAI_DECODE_LAUNCH(128, 8);
  if (D == 64 && small) KUBEAI_DECODE_LAUNCH(64, 4);
  if (D == 64) KUBEAI_DECODE_LAUNCH(64, 8);
  // Gemma's head size: Gemma-7B (16 over 16 kv heads) and Gemma-2-9B (16
  // over 8) at MG 4, Gemma-2B (8 over 1) at MG 8. The bf16 walk keeps
  // one CTA an SM there (paged_split_walk.cuh); the int8 walk a 3-deep
  // ring of 8,320-byte stages a warp, 102 KB of shared memory at MG 8,
  // two CTAs an SM (paged_split_walk_int8.cuh, its header has the card's
  // times), with int8_split's D = 256 splits.
  if (D == 256 && small) KUBEAI_DECODE_LAUNCH(256, 4);
  if (D == 256) KUBEAI_DECODE_LAUNCH(256, 8);
#undef KUBEAI_DECODE_LAUNCH
  return (int)cudaErrorInvalidValue;
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
  return dispatch<false>(q, k_pages, v_pages, nullptr, nullptr, block_tables, lengths,
                         out, scratch, B, H, KVH, D, page_size, max_pages, num_splits,
                         pages_per_split, scale, softcap, window, stream);
}

// The int8 walk and B1's combine over an int8 pool: `k_pages` and
// `v_pages` are int8 [P, page, KVH, D], `k_scales` and `v_scales` f32
// [P, page, KVH]; `q` and `out` bf16 [B, H, D]. Same scratch layout and
// return codes; the split comes from the wrapper's int8_split.
extern "C" int kubeai_paged_decode_int8(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, const void* block_tables, const void* lengths, void* out,
    void* scratch, int B, int H, int KVH, int D, int page_size, int max_pages,
    int num_splits, int pages_per_split, float scale, float softcap, int window,
    void* stream) {
  return dispatch<true>(q, k_pages, v_pages, static_cast<const float*>(k_scales),
                        static_cast<const float*>(v_scales), block_tables, lengths, out,
                        scratch, B, H, KVH, D, page_size, max_pages, num_splits,
                        pages_per_split, scale, softcap, window, stream);
}
