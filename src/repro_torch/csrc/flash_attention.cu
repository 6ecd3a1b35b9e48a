// Flash attention (prefill self-attention) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` (`_flash_kernel`) in
// src/repro/kernels/flash_attention/kernel.py.  Same contract: q [B,H,Sq,D],
// k/v [B,KVH,Sk,D], a causal mask (k_pos <= q_pos) and/or a sliding window
// (q_pos - k_pos < window) on positions counted from 0 at the top left,
// Sq/Sk ragged, an online softmax in fp32, the output in the input type.
// One addition: `num_heads` real query heads out of H.  Real head h reads KV
// head h / (num_heads / KVH); heads >= num_heads are padding and are written
// as zeros (their rows of the output projection are zero).
//
// What bounds it on an H100: operations, at the prefill shapes.  A causal
// 4096-token prompt of qwen2-1.5b (12 heads, head_dim 128) has 8.4 M visible
// (q, k) pairs per head: 4 * 128 * 12 * 8.4e6 = 51.5 GFLOP for 25 MB of q, k,
// v and o in bf16, ~2000 flops per byte, far above the ~295 the card needs
// before its tensor cores and not its memory are the limit.  What the design
// does about it (a simple, correct first kernel; see PERF.md for its times):
//   * bf16: the products QK^T and PV run on the tensor cores with
//     mma.sync.m16n8k16 (fp32 accumulate).  The score tile stays in
//     registers between the two products: the accumulator layout of the
//     first product is the A-operand layout of the second (the
//     FlashAttention-2 register reuse), so P never goes through memory.
//   * fp32: plain FMA on the CUDA cores (no TF32), so fp32 stays exact to
//     the plain version's tolerance.
//   * the KV loop of a q tile runs only over the tiles that can hold a
//     visible key: up to q_hi - 1 under the causal mask, from
//     q_lo - window + 1 under a window.  On the TPU the grid walked every KV
//     tile and `pl.when` skipped the masked ones; here the loop bounds skip
//     them, so a causal prompt does half the work of a full one.
//   * q, k, v and o are read and written through their strides (the model
//     passes its [B,S,H,D] tensors as [B,H,S,D] views, no copy), with 16-byte
//     loads when the strides and the pointers allow it.  K/V tiles are staged
//     in shared memory, ragged rows and columns are zero-filled there and
//     masked in the kernel: no padding copies.
//   * a row that sees no key in a tile keeps p = 0 (its running max stays
//     -inf and the exponent is taken against 0); a row that sees no key at
//     all gives zeros.  Nothing becomes NaN.
// Known limits (for a later change): no TMA/wgmma pipeline, K/V loads are
// not overlapped with the products, one 64-row q tile per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // q rows per block
constexpr int kMaxD = 128;       // head_dim

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_sh, q_ss;      // element strides: batch, head, position
  int64_t k_sb, k_sh, k_ss;      // (the head_dim stride is 1)
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int H, num_heads, kvh, D, Sq, Sk;
  int causal, window;            // window <= 0: no window
  float scale;
  int vec;                       // 16-byte loads are valid for q, k and v
};

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(const Args& a, int qp, int kp) {
  return kp < a.Sk && (!a.causal || kp <= qp) && (a.window <= 0 || qp - kp < a.window);
}

// Rows [0, rows) x columns [0, DP) of a [*, D] tile at `g` (row stride
// `ld_g` elements) into shared memory (row stride `LD`); rows >= valid and
// columns >= D are zero.
template <typename T, int ROWS, int DP, int LD, int THREADS>
__device__ __forceinline__ void load_tile(T* s, const T* g, int64_t ld_g, int valid,
                                          int D, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = DP / VEC;
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * VEC;
    T* dst = s + r * LD + c;
    if (vec && r < valid && c < D) {   // vec implies D % VEC == 0
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(g + r * ld_g + c);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        dst[e] = (r < valid && c + e < D) ? g[r * ld_g + c + e] : from_float<T>(0.f);
    }
  }
}

// Zeros for the rows of a padded query head.
template <typename T, int THREADS>
__device__ void zero_rows(const Args& a, T* o, int q_lo) {
  const int rows = min(kBQ, a.Sq - q_lo);
  for (int idx = threadIdx.x; idx < rows * a.D; idx += THREADS)
    o[(int64_t)(q_lo + idx / a.D) * a.o_ss + idx % a.D] = from_float<T>(0.f);
}

// KV range [start, end) that can hold a visible key for q rows [q_lo, q_hi).
__device__ __forceinline__ void kv_range(const Args& a, int q_lo, int q_hi, int* start,
                                         int* end) {
  *end = a.causal ? min(a.Sk, q_hi) : a.Sk;
  *start = a.window > 0 ? max(0, q_lo - a.window + 1) : 0;
}

// ------------------------------------------------------------------- bf16

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (lo) at the lower address
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[16x8] += a[16x16] * b[16x8], bf16 in, fp32 accumulate.  Fragments as in
// the PTX ISA for m16n8k16 (g = lane / 4, t = lane % 4):
//   a: {row g, k 2t..2t+1}, {row g+8, k 2t..}, {row g, k 2t+8..}, {row g+8, k 2t+8..}
//   b: {k 2t..2t+1, col g}, {k 2t+8..2t+9, col g}
//   d: {row g, col 2t, 2t+1}, {row g+8, col 2t, 2t+1}
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four warps, each owning 16 q rows of the block's 64; KV tiles of 64 keys.
template <int DP>
__global__ void __launch_bounds__(128) flash_bf16_kernel(Args a) {
  using T = __nv_bfloat16;
  constexpr int kThreads = 128, kBK = 64, LD = DP + 8;   // +16 bytes: no bank conflicts
  constexpr int KC = DP / 16;                            // k-chunks of QK^T
  constexpr int NT = kBK / 8;                            // 8-key column tiles of S
  constexpr int OT = DP / 8;                             // 8-wide column tiles of O
  extern __shared__ uint4 smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kBQ * LD;
  T* sV = sK + kBK * LD;

  const int q_lo = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
  if (h >= a.num_heads) {
    zero_rows<T, kThreads>(a, o, q_lo);
    return;
  }
  const int g_kv = h / (a.num_heads / a.kvh);
  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh + q_lo * a.q_ss;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + g_kv * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + g_kv * a.v_sh;
  const bool vec = a.vec != 0;
  const int q_hi = min(q_lo + kBQ, a.Sq);

  load_tile<T, kBQ, DP, LD, kThreads>(sQ, qg, a.q_ss, q_hi - q_lo, a.D, vec);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16 + g;                 // this thread's rows: r0, r0 + 8
  const int qp[2] = {q_lo + r0, q_lo + r0 + 8};

  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const T* p = sQ + r0 * LD + kc * 16 + 2 * t;
    qf[kc][0] = ld32(p);
    qf[kc][1] = ld32(p + 8 * LD);
    qf[kc][2] = ld32(p + 8);
    qf[kc][3] = ld32(p + 8 * LD + 8);
  }

  float acc[OT][4];
#pragma unroll
  for (int i = 0; i < OT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};                      // this thread's part of the row sum

  int kv_start, kv_end;
  kv_range(a, q_lo, q_hi, &kv_start, &kv_end);
  for (int k0 = (kv_start / kBK) * kBK; k0 < kv_end; k0 += kBK) {
    __syncthreads();                            // the previous tile is consumed
    const int kvalid = min(kBK, a.Sk - k0);
    load_tile<T, kBK, DP, LD, kThreads>(sK, kg + k0 * a.k_ss, a.k_ss, kvalid, a.D, vec);
    load_tile<T, kBK, DP, LD, kThreads>(sV, vg + k0 * a.v_ss, a.v_ss, kvalid, a.D, vec);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const T* p = sK + (nt * 8 + g) * LD + kc * 16 + 2 * t;
        mma_bf16(s[nt], qf[kc], ld32(p), ld32(p + 8));
      }
    }

    // scale, mask, online softmax (rows r0 and r0 + 8; a row's 4 threads
    // are lanes 4g..4g+3 of this warp)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e / 2;
        const int kp = k0 + nt * 8 + 2 * t + (e % 2);
        const float x = visible(a, qp[row], kp) ? s[nt][e] * a.scale : -INFINITY;
        s[nt][e] = x;
        mx[row] = fmaxf(mx[row], x);
      }
    }
    float mu[2], corr[2];
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 1));
      mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 2));
      const float m_new = fmaxf(m[row], mx[row]);
      mu[row] = m_new == -INFINITY ? 0.f : m_new;   // no key yet: exp(-inf - 0) = 0
      corr[row] = expf(m[row] - mu[row]);
      m[row] = m_new;
      l[row] *= corr[row];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - mu[e / 2]);
        s[nt][e] = p;
        l[e / 2] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < OT; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }

    // O += P V: P in bf16 straight from the S accumulators
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const T* v0 = sV + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int i = 0; i < OT; ++i) {
        const T* p = v0 + i * 8;
        mma_bf16(acc[i], pa, pack(p[0], p[LD]), pack(p[8 * LD], p[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int row = 0; row < 2; ++row) {
    l[row] += __shfl_xor_sync(0xffffffffu, l[row], 1);
    l[row] += __shfl_xor_sync(0xffffffffu, l[row], 2);
    const float inv = l[row] > 0.f ? 1.f / l[row] : 0.f;
    if (qp[row] >= a.Sq) continue;
    T* orow = o + (int64_t)qp[row] * a.o_ss;
#pragma unroll
    for (int i = 0; i < OT; ++i) {
      const int d = i * 8 + 2 * t;
      if (d < a.D) orow[d] = __float2bfloat16(acc[i][2 * row] * inv);
      if (d + 1 < a.D) orow[d + 1] = __float2bfloat16(acc[i][2 * row + 1] * inv);
    }
  }
}

// ------------------------------------------------------------------- fp32

// 256 threads: four per q row (t = 0..3), each taking keys t, t+4, ... of a
// 32-key tile for the scores and columns 4 * (t + 4 i) .. + 3 of the output.
template <int DP>
__global__ void __launch_bounds__(256) flash_f32_kernel(Args a) {
  constexpr int kThreads = 256, kBK = 32, LD = DP + 4, LP = kBK + 1;
  constexpr int NJ = kBK / 4;        // keys per thread
  constexpr int NO = DP / 16;        // float4 output columns per thread
  extern __shared__ uint4 smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sP = sV + kBK * LD;

  const int q_lo = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  float* o = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;
  if (h >= a.num_heads) {
    zero_rows<float, kThreads>(a, o, q_lo);
    return;
  }
  const int g_kv = h / (a.num_heads / a.kvh);
  const float* qg = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh + q_lo * a.q_ss;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_sb + g_kv * a.k_sh;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_sb + g_kv * a.v_sh;
  const bool vec = a.vec != 0;
  const int q_hi = min(q_lo + kBQ, a.Sq);

  load_tile<float, kBQ, DP, LD, kThreads>(sQ, qg, a.q_ss, q_hi - q_lo, a.D, vec);

  const int r = threadIdx.x / 4, t = threadIdx.x % 4;
  const int qp = q_lo + r;
  float acc[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m = -INFINITY, l = 0.f;

  int kv_start, kv_end;
  kv_range(a, q_lo, q_hi, &kv_start, &kv_end);
  for (int k0 = (kv_start / kBK) * kBK; k0 < kv_end; k0 += kBK) {
    __syncthreads();
    const int kvalid = min(kBK, a.Sk - k0);
    load_tile<float, kBK, DP, LD, kThreads>(sK, kg + k0 * a.k_ss, a.k_ss, kvalid, a.D, vec);
    load_tile<float, kBK, DP, LD, kThreads>(sV, vg + k0 * a.v_ss, a.v_ss, kvalid, a.D, vec);
    __syncthreads();

    float s[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j] = 0.f;
    const float4* q4 = reinterpret_cast<const float4*>(sQ + r * LD);
#pragma unroll 4
    for (int d4 = 0; d4 < DP / 4; ++d4) {
      const float4 x = q4[d4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 y = reinterpret_cast<const float4*>(sK + (t + 4 * j) * LD)[d4];
        s[j] = fmaf(x.x, y.x, s[j]);
        s[j] = fmaf(x.y, y.y, s[j]);
        s[j] = fmaf(x.z, y.z, s[j]);
        s[j] = fmaf(x.w, y.w, s[j]);
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[j] = visible(a, qp, k0 + t + 4 * j) ? s[j] * a.scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float mu = m_new == -INFINITY ? 0.f : m_new;
    const float corr = expf(m - mu);
    m = m_new;
    l *= corr;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float p = expf(s[j] - mu);
      l += p;
      sP[r * LP + t + 4 * j] = p;
    }
    __syncwarp();                      // a row's four threads share one warp
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      acc[i][0] *= corr;
      acc[i][1] *= corr;
      acc[i][2] *= corr;
      acc[i][3] *= corr;
    }
    for (int j = 0; j < kBK; ++j) {
      const float p = sP[r * LP + j];
      const float4* v4 = reinterpret_cast<const float4*>(sV + j * LD);
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        const float4 y = v4[t + 4 * i];
        acc[i][0] = fmaf(p, y.x, acc[i][0]);
        acc[i][1] = fmaf(p, y.y, acc[i][1]);
        acc[i][2] = fmaf(p, y.z, acc[i][2]);
        acc[i][3] = fmaf(p, y.w, acc[i][3]);
      }
    }
  }

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  const float inv = l > 0.f ? 1.f / l : 0.f;
  if (qp >= a.Sq) return;
  float* orow = o + (int64_t)qp * a.o_ss;
#pragma unroll
  for (int i = 0; i < NO; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 4 * (t + 4 * i) + c;
      if (d < a.D) orow[d] = acc[i][c] * inv;
    }
  }
}

// ----------------------------------------------------------------- launch

template <int DP>
cudaError_t launch_dp(int dtype, int B, const Args& a, cudaStream_t s) {
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, B);
  size_t smem;
  cudaError_t err;
  if (dtype == 1) {
    smem = sizeof(__nv_bfloat16) * (kBQ + 2 * 64) * (DP + 8);
    err = cudaFuncSetAttribute(flash_bf16_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_bf16_kernel<DP><<<grid, 128, smem, s>>>(a);
  } else {
    smem = sizeof(float) * ((kBQ + 2 * 32) * (DP + 4) + kBQ * 33);
    err = cudaFuncSetAttribute(flash_f32_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_f32_kernel<DP><<<grid, 256, smem, s>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the head_dim
// stride must be 1.  window <= 0 means no window.  Returns
// cudaGetLastError() after the launch (0 = launched); the caller checks the
// shapes, and this function refuses what the kernels do not take.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss,
    int B, int H, int num_heads, int kvh, int D, int Sq, int Sk, int causal, int window,
    float scale, int vec, void* stream) {
  if (D < 1 || D > kMaxD || kvh < 1 || num_heads < 1 || num_heads > H ||
      num_heads % kvh != 0 || B < 1 || B > 65535 || H > 65535 || Sq < 1 || Sk < 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
         H, num_heads, kvh, D, Sq, Sk, causal, window, scale, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 16) return static_cast<int>(launch_dp<16>(dtype, B, a, s));
  if (D <= 32) return static_cast<int>(launch_dp<32>(dtype, B, a, s));
  if (D <= 64) return static_cast<int>(launch_dp<64>(dtype, B, a, s));
  return static_cast<int>(launch_dp<128>(dtype, B, a, s));
}
