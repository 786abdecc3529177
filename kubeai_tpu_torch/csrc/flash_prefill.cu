// Causal flash attention for prefill on Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas TPU kernel in kubeai_tpu/ops/pallas_attention.py:
// `_flash_bhsd` / `_flash_kernel` (B2), entry `flash_causal_prefill`.
// Causal self-attention over a prompt, q [B, S, H, D] against k, v
// [B, S, KVH, D]; q head h reads kv head h / (H / KVH).
//
// What bounds it on this card: at long S, tensor-core flops. The causal
// product does about 2 * 2 * B * H * S^2 / 2 * D flops against
// 2 * B * S * (H + 2 * KVH) * D bytes, i.e. ~S/2 flops per byte: above
// the ~295 flops/byte ridge once S passes a few hundred tokens. At short
// S it is bound by bytes.
//
// Design: one CTA (4 warps) per (64-row q block, q head, batch row). Q is
// staged once in shared memory; the CTA then walks 64-key blocks up to
// its causal frontier (blocks past it are never read), staging each K/V
// block of kv head h / group in shared memory, so GQA costs no expanded
// K/V. Both products run on the tensor cores through WMMA (bf16 inputs,
// 16x16x16 tiles, f32 accumulation); each warp owns 16 query rows. The
// online softmax runs in f32 over the score tile in shared memory; the
// f32 output tile also lives in shared memory, where each row is
// rescaled before P.V accumulates into it. Rows are padded in shared
// memory to spread banks. The ragged tail needs no padding of S: query
// rows past S are computed on zeros and not written, key rows past S are
// zero-filled and masked. Head dims 64 and 128 are taken.
//
// Known limits: no overlap of the next K/V load with the math, and WMMA
// instead of wgmma; TMA, wgmma and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per block
constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr float kNegInf = -1e30f;  // the JAX package's finite NEG_INF

template <int D>
struct Layout {
  static constexpr int kLdQ = D + 8;    // bf16 row stride of Q, K, V tiles
  static constexpr int kLdS = kBK + 4;  // f32 row stride of the score tile
  static constexpr int kLdP = kBK + 8;  // bf16 row stride of the P tile
  static constexpr int kLdO = D + 4;    // f32 row stride of the output tile
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(bf16) * kBQ * kLdQ;
  static constexpr size_t v_off = k_off + sizeof(bf16) * kBK * kLdQ;
  static constexpr size_t s_off = v_off + sizeof(bf16) * kBK * kLdQ;
  static constexpr size_t p_off = s_off + sizeof(float) * kBQ * kLdS;
  static constexpr size_t o_off = p_off + sizeof(bf16) * kBQ * kLdP;
  static constexpr size_t m_off = o_off + sizeof(float) * kBQ * kLdO;
  static constexpr size_t l_off = m_off + sizeof(float) * kBQ;
  static constexpr size_t bytes = l_off + sizeof(float) * kBQ;
  // WMMA needs 32-byte aligned tile pointers.
  static_assert(k_off % 32 == 0 && v_off % 32 == 0 && s_off % 32 == 0 &&
                    p_off % 32 == 0 && o_off % 32 == 0,
                "shared-memory tiles must be 32-byte aligned");
};

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

// Copy rows [row0, row0 + 64) of one head ([rows, D] bf16, row stride
// `stride` elements) into a padded shared tile; rows past `n_rows` are
// zero-filled.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           size_t stride, int row0,
                                           int n_rows) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * Layout<D>::kLdQ + c * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const bf16* __restrict__ q,  // [B, S, H, D]
                     const bf16* __restrict__ k,  // [B, S, KVH, D]
                     const bf16* __restrict__ v,
                     bf16* __restrict__ out,      // [B, S, H, D]
                     int S, int H, int KVH, float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* k_s = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* v_s = reinterpret_cast<bf16*>(smem + L::v_off);
  float* s_s = reinterpret_cast<float*>(smem + L::s_off);
  bf16* p_s = reinterpret_cast<bf16*>(smem + L::p_off);
  float* o_s = reinterpret_cast<float*>(smem + L::o_off);
  float* m_s = reinterpret_cast<float*>(smem + L::m_off);
  float* l_s = reinterpret_cast<float*>(smem + L::l_off);

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16;  // this warp's first query row

  // Per-head row views: row s of head h starts at ((b*S + s)*H + h)*D.
  const size_t q_stride = (size_t)H * D;
  const size_t kv_stride = (size_t)KVH * D;
  const bf16* q_head = q + ((size_t)b * S * H + h) * D;
  const bf16* k_head = k + ((size_t)b * S * KVH + kvh) * D;
  const bf16* v_head = v + ((size_t)b * S * KVH + kvh) * D;

  stage_rows<D>(q_s, q_head, q_stride, q0, S);
  for (int i = tid; i < kBQ * D; i += kThreads)
    o_s[(i / D) * L::kLdO + (i % D)] = 0.f;
  for (int i = tid; i < kBQ; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  // Causal frontier: key blocks past the last query row are all masked.
  const int q_last = min(q0 + kBQ, S);
  const int n_kb = (q_last + kBK - 1) / kBK;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // every warp is done with the previous K/V tile
    stage_rows<D>(k_s, k_head, kv_stride, k0, S);
    stage_rows<D>(v_s, v_head, kv_stride, k0, S);
    __syncthreads();

    // Scores for this warp's 16 rows: S = Q K^T.
#pragma unroll
    for (int n0 = 0; n0 < kBK; n0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kt;
        wmma::load_matrix_sync(a, q_s + r0 * L::kLdQ + d0, L::kLdQ);
        wmma::load_matrix_sync(kt, k_s + n0 * L::kLdQ + d0, L::kLdQ);
        wmma::mma_sync(acc, a, kt, acc);
      }
      wmma::store_matrix_sync(s_s + r0 * L::kLdS + n0, acc, L::kLdS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax over the 16 rows; each lane covers keys lane and
    // lane + 32 of the block.
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const int qpos = q0 + r;
      const int kp0 = k0 + lane;
      const int kp1 = k0 + lane + 32;
      float s0 = s_s[r * L::kLdS + lane] * scale;
      float s1 = s_s[r * L::kLdS + lane + 32] * scale;
      if (kp0 > qpos || kp0 >= S) s0 = kNegInf;
      if (kp1 > qpos || kp1 >= S) s1 = kNegInf;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float e0 = expf(s0 - m_new);
      const float e1 = expf(s1 - m_new);
      p_s[r * L::kLdP + lane] = __float2bfloat16(e0);
      p_s[r * L::kLdP + lane + 32] = __float2bfloat16(e1);
      const float sum = warp_sum(e0 + e1);
      const float alpha = expf(m_old - m_new);
      for (int d = lane; d < D; d += 32) o_s[r * L::kLdO + d] *= alpha;
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
      }
    }
    __syncwarp();

    // O += P V for this warp's 16 rows.
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, o_s + r0 * L::kLdO + d0, L::kLdO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(a, p_s + r0 * L::kLdP + kk, L::kLdP);
        wmma::load_matrix_sync(vb, v_s + kk * L::kLdQ + d0, L::kLdQ);
        wmma::mma_sync(acc, a, vb, acc);
      }
      wmma::store_matrix_sync(o_s + r0 * L::kLdO + d0, acc, L::kLdO,
                              wmma::mem_row_major);
    }
  }
  __syncwarp();

  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr;
    if (q0 + r >= S) break;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
    bf16* dst = out + (((size_t)b * S + q0 + r) * H + h) * D;
    for (int d = lane; d < D; d += 32)
      dst[d] = __float2bfloat16(o_s[r * L::kLdO + d] * inv);
  }
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B,
           int S, int H, int KVH, float scale, cudaStream_t stream) {
  constexpr size_t bytes = Layout<D>::bytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_prefill_kernel<D><<<grid, kThreads, bytes, stream>>>(q, k, v, out, S,
                                                             H, KVH, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` (PyTorch's current stream); allocates nothing.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a shape the kernel does not take.
extern "C" int kubeai_flash_prefill_bf16(const void* q, const void* k,
                                         const void* v, void* out, int B,
                                         int S, int H, int KVH, int D,
                                         float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  auto* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch<128>(qp, kp, vp, op, B, S, H, KVH, scale, s);
  if (D == 64) return launch<64>(qp, kp, vp, op, B, S, H, KVH, scale, s);
  return (int)cudaErrorInvalidValue;
}
