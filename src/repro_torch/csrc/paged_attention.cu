// Paged decode attention through a page table, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention` (`_paged_kernel`) in
// src/repro/kernels/paged_attention/kernel.py.  Same contract: one query
// token per sequence, K/V read from a shared page pool [P, page_size, KVH, D]
// through a per-sequence page table, positions >= length masked, online
// softmax in fp32, output in the input type, length 0 -> zeros.
//
// What bounds it on an H100: bytes.  Each valid K/V row is read once
// (2 * length * KVH * D * itemsize per sequence) and does 4 * rep * D flops
// per row, far below the ~295 flops/byte the card needs before its math
// units are the limit.  What the design does about it:
//   * one block per (sequence, KV head): the `rep` query heads that share a
//     KV head are loaded once into registers, so each K/V row is read from
//     device memory once per group, not once per query head;
//   * the page loop stops at ceil(length / page_size) instead of walking
//     every `pages_per_seq` entry as the TPU grid does, so the bytes read
//     follow the live length, not the table width;
//   * a warp reads one token's D-wide row for its head as one contiguous
//     run (D = 64 bf16 is 128 bytes), rows sit KVH * D apart;
//   * the four warps of a block take pages round-robin, each keeping its
//     own online-softmax state (m, l, acc) in fp32 registers, merged once
//     through shared memory at the end.
// Known limit (left for a later change): at the serving shapes there are
// only B * KVH blocks (24 for smollm-135m at batch 8) on 132 SMs, and a
// short sequence keeps only one or two warps of its block busy; splitting
// long sequences over pages across blocks is the next step.
//
// Padded query heads: q and out are [B, H, D] where only the first
// `num_heads` heads are real (rep = num_heads / KVH, head i reads KV head
// i / rep).  Heads >= num_heads are written as zeros: their rows of the
// output projection are zero, so they contribute nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRep = 8;      // query heads per KV head
constexpr int kMaxD = 256;      // head_dim
constexpr float kNegInf = -2.0e38f;   // same mask value as the Pallas kernel

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// EPL: elements of one D-wide row each lane holds (lane + 32 * i).
template <typename T, int EPL>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ table,
    const int* __restrict__ lengths, T* __restrict__ out, int H,
    int num_heads, int kvh, int D, int num_pool_pages, int page_size,
    int pages_per_seq, float scale) {
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rep = num_heads / kvh;

  // the rep queries of this KV head, in fp32 registers
  const T* qb = q + ((int64_t)b * H + (int64_t)g * rep) * D;
  float qr[kMaxRep][EPL];
  float m[kMaxRep], l[kMaxRep], acc[kMaxRep][EPL];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int d = lane + 32 * i;
      qr[r][i] = (r < rep && d < D) ? to_float(qb[(int64_t)r * D + d]) : 0.f;
      acc[r][i] = 0.f;
    }
  }

  int len = lengths[b];
  len = max(0, min(len, pages_per_seq * page_size));
  const int n_pages = (len + page_size - 1) / page_size;
  const int64_t row = (int64_t)kvh * D;   // elements from one token to the next

  for (int pi = warp; pi < n_pages; pi += kWarps) {
    const int page = table[(int64_t)b * pages_per_seq + pi];
    if (page < 0 || page >= num_pool_pages) continue;   // never read outside the pool
    const int t_end = min(page_size, len - pi * page_size);
    const int64_t base = (int64_t)page * page_size * row + (int64_t)g * D;
    const T* kp = k_pool + base;
    const T* vp = v_pool + base;
    for (int t = 0; t < t_end; ++t) {
      float kv[EPL], vv[EPL];
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        const int d = lane + 32 * i;
        kv[i] = d < D ? to_float(kp[t * row + d]) : 0.f;
        vv[i] = d < D ? to_float(vp[t * row + d]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < rep) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < EPL; ++i) s += qr[r][i] * kv[i];
          s = warp_sum(s) * scale;
          const float m_new = fmaxf(m[r], s);
          const float corr = expf(m[r] - m_new);
          const float p = expf(s - m_new);
          l[r] = l[r] * corr + p;
#pragma unroll
          for (int i = 0; i < EPL; ++i) acc[r][i] = acc[r][i] * corr + p * vv[i];
          m[r] = m_new;
        }
      }
    }
  }

  // merge the warps' online-softmax states
  __shared__ float sm_m[kWarps][kMaxRep];
  __shared__ float sm_l[kWarps][kMaxRep];
  __shared__ float sm_acc[kWarps][kMaxRep][kMaxD];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r < rep) {
      if (lane == 0) {
        sm_m[warp][r] = m[r];
        sm_l[warp][r] = l[r];
      }
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) sm_acc[warp][r][d] = acc[r][i];
      }
    }
  }
  __syncthreads();

  T* ob = out + ((int64_t)b * H + (int64_t)g * rep) * D;
  for (int idx = threadIdx.x; idx < rep * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][r] - mx);
      lsum += sm_l[w][r] * c;
      a += sm_acc[w][r][d] * c;
    }
    store(ob + idx, a / fmaxf(lsum, 1e-37f));   // same clamp as the Pallas kernel
  }
  if (g == 0) {   // padded query heads: zeros
    T* pad = out + ((int64_t)b * H + num_heads) * D;
    for (int idx = threadIdx.x; idx < (H - num_heads) * D; idx += kThreads) store(pad + idx, 0.f);
  }
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k_pool, const void* v_pool,
                         const int* table, const int* lengths, void* out, int B,
                         int H, int num_heads, int kvh, int D, int num_pool_pages,
                         int page_size, int pages_per_seq, float scale,
                         cudaStream_t stream) {
  const dim3 grid(B, kvh);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k_pool);
  const T* vt = static_cast<const T*>(v_pool);
  T* ot = static_cast<T*>(out);
#define REPRO_LAUNCH(EPL)                                                    \
  paged_attention_kernel<T, EPL><<<grid, kThreads, 0, stream>>>(             \
      qt, kt, vt, table, lengths, ot, H, num_heads, kvh, D, num_pool_pages,  \
      page_size, pages_per_seq, scale)
  if (D <= 32) REPRO_LAUNCH(1);
  else if (D <= 64) REPRO_LAUNCH(2);
  else if (D <= 128) REPRO_LAUNCH(4);
  else REPRO_LAUNCH(8);
#undef REPRO_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 = launched); the caller checks shapes and the limits below.
extern "C" int repro_paged_attention(const void* q, const void* k_pool,
                                     const void* v_pool, const int* table,
                                     const int* lengths, void* out, int dtype,
                                     int B, int H, int num_heads, int kvh, int D,
                                     int num_pool_pages, int page_size,
                                     int pages_per_seq, float scale,
                                     void* stream) {
  if (D > kMaxD || num_heads % kvh != 0 || num_heads / kvh > kMaxRep ||
      num_heads > H)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_typed<float>(q, k_pool, v_pool, table, lengths, out, B, H,
                              num_heads, kvh, D, num_pool_pages, page_size,
                              pages_per_seq, scale, s);
  else if (dtype == 1)
    err = launch_typed<__nv_bfloat16>(q, k_pool, v_pool, table, lengths, out,
                                      B, H, num_heads, kvh, D, num_pool_pages,
                                      page_size, pages_per_seq, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
