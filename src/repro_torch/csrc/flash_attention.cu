// Flash attention (prefill self-attention) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` (`_flash_kernel`) in
// src/repro/kernels/flash_attention/kernel.py:84.  Same contract: q
// [B,H,Sq,D], k/v [B,KVH,Sk,D], a causal mask (k_pos <= q_pos) and/or a
// sliding window (q_pos - k_pos < window) on positions counted from 0 at the
// top left, Sq/Sk ragged, an online softmax in fp32, the output in the input
// type.  Two additions: `num_heads` real query heads, and `head_offset`, the
// global head of q's first head (a tensor-parallel rank holds heads
// [head_offset, head_offset + H)).  Global head g < num_heads reads KV head
// g / (num_heads / KVH); heads g >= num_heads are padding and are written as
// zeros (their rows of the output projection are zero).  A (q tile, head,
// sequence) tile does the same work whatever the offset, so a shard's heads
// are bitwise those of the launch over every head.
//
// What bounds it on an H100: operations, at the prefill shapes.  A causal
// 4096-token prompt of qwen2-1.5b (12 heads, head_dim 128) has 8.4 M visible
// (q, k) pairs per head: 4 * 128 * 12 * 8.4e6 = 51.5 GFLOP for 25 MB of q, k,
// v and o in bf16, ~2000 flops per byte, far above the ~295 the card needs
// before its tensor cores and not its memory are the limit.  So the products
// must run at the tensor cores' full rate, which on Hopper only `wgmma`
// reaches, fed from shared memory without stalling on loads.
//
// Two kernels, chosen by the wrapper (kernels/flash_attention/kernel.py)
// before the launch; this file never switches between them by itself.
//
// flash_attention_sm90_kernel: bf16, head_dim 64 or 128, q/k/v views that a
// TMA tensor map can describe (16-byte aligned bases, byte strides that are
// multiples of 16).  What its design does about the bound:
//   * one CTA per (128-row q tile, real head, sequence): two consumer
//     warpgroups of 64 q rows each and one producer warpgroup, whose
//     registers go to the consumers (setmaxnreg 24 / 240);
//   * the producer's one thread loads Q once and keeps a 2-stage ring of
//     128-key K and V tiles in flight by TMA (128-byte swizzle, a D-128 row
//     as two 64-column boxes), with full/empty mbarriers per stage and per
//     operand, so loads overlap the products.  The tensor maps describe the
//     model's [B,S,H,D] tensors as 4-D (D, S, head, batch) views: rows past
//     Sq/Sk come back as zeros, never as another head's rows;
//   * S = Q K^T on wgmma m64n128k16 from shared memory (K as stored,
//     K-major); O += P V on wgmma m64nDk16 with P from registers (the S
//     accumulators packed to bf16) and V from shared memory as stored
//     [keys, D], read through the instruction's transpose;
//   * software-pipelined inside a warpgroup: QK^T of KV tile j and PV of
//     tile j - 1 are issued together, and the softmax of tile j runs while
//     that PV is on the tensor cores.  The softmax works in place in S's
//     registers and P is packed only after PV has read the previous P: a
//     register that an asynchronous product still reads must not be
//     written, or the compiler serializes every product of the kernel;
//   * fp32 online softmax in exp2 with scale * log2(e) folded in; the mask
//     is evaluated only on tiles that cross the causal diagonal, the window
//     edge or Sk; interior tiles skip it;
//   * longest causal q tiles are launched first (blockIdx.x walks the q
//     tiles from the last), padded heads last, so the short tiles fill the
//     tail of the schedule.
//
// flash_bf16_kernel / flash_f32_kernel: everything else (fp32 as FMA with no
// TF32, exact to 2e-5; head dims other than 64/128; views TMA cannot
// describe).  One block per (64-row q tile, head, sequence); bf16 on
// mma.sync.m16n8k16 with the score tile kept in registers between QK^T and
// PV; K/V staged in shared memory by all threads, zero-filled at ragged
// edges; 16-byte loads where strides and pointers allow.
//
// Both: the KV loop of a q tile runs only over the tiles that can hold a
// visible key (up to q_hi - 1 under the causal mask, from q_lo - window + 1
// under a window), where the TPU grid walked every tile and `pl.when` skipped
// the masked ones.  A row that sees no key in a tile keeps p = 0 (its running
// max stays -inf and the exponent is taken against 0); a row that sees no key
// at all gives zeros.  Nothing becomes NaN.  No atomics: the result is
// deterministic.
// Known limits (for a later change): the sm90 kernel is not persistent (one
// CTA per tile: each pays its own start, Q load and pipeline fill) and
// writes O with plain stores; the two consumer warpgroups are not ordered
// against each other (taking turns measured no faster); the generic
// kernels keep the synchronous loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

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
  int H, num_heads, head_offset, kvh, D, Sq, Sk;
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
  if (a.head_offset + h >= a.num_heads) {
    zero_rows<T, kThreads>(a, o, q_lo);
    return;
  }
  const int g_kv = (a.head_offset + h) / (a.num_heads / a.kvh);
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
  if (a.head_offset + h >= a.num_heads) {
    zero_rows<float, kThreads>(a, o, q_lo);
    return;
  }
  const int g_kv = (a.head_offset + h) / (a.num_heads / a.kvh);
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

// --------------------------------------------------------------- sm90 bf16

namespace fa90 {

constexpr int kRows = 128;                 // q rows of a CTA; keys of a KV tile
constexpr int kStages = 2;                 // depth of the K/V ring
constexpr int kThreads = 384;              // warpgroups 0, 1: consumers; 2: producer
constexpr int kBoxCols = 64;               // bf16 columns of one 128-byte swizzled box
constexpr uint32_t kBoxBytes = kRows * 128;
constexpr int kConsumerThreads = 256;

struct Args {
  __nv_bfloat16* o;
  int64_t o_sb, o_sh, o_ss;                // element strides of the output
  int B, H;
  int n_real;                              // real heads of this launch: a prefix of H
  int head_offset, group;                  // global head of head 0; q heads per KV head
  int kvh, Sq, Sk, causal, window, n_qt;
  float scale_log2;                        // softmax scale * log2(e)
};

// Shared memory, from a 1024-byte aligned base: Q | K0 V0 | K1 V1 | barriers.
// A tile is D / 64 boxes of 128 rows x 128 bytes (160 KB in all at D 128).
template <int D>
struct Layout {
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr uint32_t kTile = kBoxes * kBoxBytes;
  static constexpr uint32_t kKV = kTile;   // stage s: K at kKV + 2 s kTile, V after it
  static constexpr uint32_t kBar = kTile * (1 + 2 * kStages);
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 4 * kStages) + 1024;  // + alignment
};

__device__ __forceinline__ bool visible(const Args& a, int qp, int kp) {
  return kp < a.Sk && (!a.causal || kp <= qp) && (a.window <= 0 || qp - kp < a.window);
}

template <int D>
__device__ void zero_tile(const Args& a, int id) {
  const int pad = a.H - a.n_real;
  const int per = pad * a.B;
  const int qt = id / per, h = a.n_real + (id % per) % pad, b = (id % per) / pad;
  __nv_bfloat16* o = a.o + b * a.o_sb + h * a.o_sh;
  const int q_lo = qt * kRows, rows = min(kRows, a.Sq - q_lo);
  constexpr int kChunks = D / 8;           // 16-byte chunks of a row
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads)
    *reinterpret_cast<uint4*>(o + (int64_t)(q_lo + idx / kChunks) * a.o_ss +
                              (idx % kChunks) * 8) = make_uint4(0, 0, 0, 0);
}

// S = Q K^T for one warpgroup: 64 rows x 128 keys in D / 16 steps along
// head_dim; a step is 32 bytes into a 128-byte swizzled row, 4 steps a box.
// dq, dk: descriptors of the tiles' first step; a step adds a constant to
// the start address (in 16-byte units), so one descriptor is built a tile.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t step = ((kk / 4) * kBoxBytes + (kk % 4) * 32) >> 4;
    sm90::wgmma_ss_n128(s, dq + step, dk + step, kk > 0);
  }
  sm90::wgmma_commit();
}

// O += P V in 8 steps of 16 keys.  V as stored [keys, D] is the transposed
// (MN-major) B operand: 8-key groups 1024 bytes apart, 64-column boxes
// kBoxBytes apart; dv describes its first step.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[32],
                                         uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    const uint64_t step = (kk * 16 * 128) >> 4;
    if constexpr (D == 128) {
      sm90::wgmma_rs_n128_tb(o, p + 4 * kk, dv + step);
    } else {
      sm90::wgmma_rs_n64_tb(o, p + 4 * kk, dv + step);
    }
  }
  sm90::wgmma_commit();
}

// One score tile through the online softmax, in place: S becomes the
// unnormalised P in fp32 (exp2 in log2 units against the new running max).
// It stays in S's registers until the product in flight has read the
// previous P, so no new registers are defined while a product reads them.
// kMask: the tile crosses Sk, the causal diagonal or the window edge
// (interior tiles skip the mask).  A row with no key yet takes its exponent
// against 0, so exp2(-inf) = 0 and nothing becomes NaN.  Returns in corr
// the factor the row's O must take (its sum has taken it).
template <bool kMask>
__device__ __forceinline__ void softmax_tile(const Args& a, float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&corr)[2], int qp0, int kp0) {
  if (kMask) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (!visible(a, qp0 + 8 * ((i / 2) % 2), kp0 + 8 * (i / 4) + i % 2)) s[i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * a.scale_log2);
    mu[r] = m_new == -INFINITY ? 0.f : m_new;
    corr[r] = sm90::ex2(m[r] - mu[r]);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = sm90::ex2(fmaf(s[i], a.scale_log2, -mu[(i / 2) % 2]));
    l[(i / 2) % 2] += s[i];
  }
}

// The tile's softmax, masked only where it crosses Sk, the causal diagonal
// or the window edge.
__device__ __forceinline__ void softmax_tile(const Args& a, float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&corr)[2], int q_lo, int row0,
                                             int col0, int k0) {
  if (k0 + kRows > a.Sk || (a.causal && k0 + kRows - 1 > q_lo) ||
      (a.window > 0 && q_lo + kRows - 1 - k0 >= a.window)) {
    softmax_tile<true>(a, s, m, l, corr, q_lo + row0, k0 + col0);
  } else {
    softmax_tile<false>(a, s, m, l, corr, q_lo + row0, k0 + col0);
  }
}

// P in bf16 pairs: the accumulator layout of S is the A-operand layout of PV.
__device__ __forceinline__ void pack_p(uint32_t (&p)[32], const float (&s)[64]) {
#pragma unroll
  for (int j = 0; j < 32; ++j) p[j] = pack(s[2 * j], s[2 * j + 1]);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = Layout<D>;
  // blockIdx.x -> (q tile, head, sequence): every real head's last q tile
  // (the longest under a causal mask) first, the first tiles after them,
  // then the padded heads, which only write zeros
  const int real = a.n_real * a.B;
  if (static_cast<int>(blockIdx.x) >= a.n_qt * real) {
    zero_tile<D>(a, blockIdx.x - a.n_qt * real);
    return;
  }
  const int qt = a.n_qt - 1 - static_cast<int>(blockIdx.x) / real;
  const int h = (blockIdx.x % real) % a.n_real, b = (blockIdx.x % real) / a.n_real;
  const int g_kv = (a.head_offset + h) / a.group;
  const int q_lo = qt * kRows;
  const int q_hi = min(q_lo + kRows, a.Sq);
  const int kv_end = a.causal ? min(a.Sk, q_hi) : a.Sk;
  const int kv_start = a.window > 0 ? max(0, q_lo - a.window + 1) : 0;
  const int t_hi = (kv_end + kRows - 1) / kRows;
  const int n_kv = max(0, t_hi - kv_start / kRows);   // KV tiles, walked from t_hi - 1 down

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  // full: the tile has landed (TMA bytes); empty: both consumer warpgroups
  // are done with it (K after QK^T, V after PV)
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;
  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full_k + s, 1);
      sm90::mbar_init(full_v + s, 1);
      sm90::mbar_init(empty_k + s, kConsumerThreads);
      sm90::mbar_init(empty_v + s, kConsumerThreads);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup index through a shuffle: the compiler then knows it is
  // uniform, and the wgmma descriptors derived from it stay in uniform
  // registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 2 * 128) {
      sm90::mbar_expect_tx(bar_q, L::kTile);
      for (int c = 0; c < L::kBoxes; ++c)
        sm90::tma_load_4d(smem + c * kBoxBytes, &tq, bar_q, c * kBoxCols, q_lo, h, b);
      for (int it = 0; it < n_kv; ++it) {
        const int st = it % kStages;
        const uint32_t parity = (it / kStages - 1) & 1;   // the stage's previous use
        const int k0 = (t_hi - 1 - it) * kRows;
        uint8_t* sk = smem + L::kKV + 2 * st * L::kTile;
        if (it >= kStages) sm90::mbar_wait(empty_k + st, parity);
        sm90::mbar_expect_tx(full_k + st, L::kTile);
        for (int c = 0; c < L::kBoxes; ++c)
          sm90::tma_load_4d(sk + c * kBoxBytes, &tk, full_k + st, c * kBoxCols, k0, g_kv, b);
        if (it >= kStages) sm90::mbar_wait(empty_v + st, parity);
        sm90::mbar_expect_tx(full_v + st, L::kTile);
        for (int c = 0; c < L::kBoxes; ++c)
          sm90::tma_load_4d(sk + L::kTile + c * kBoxBytes, &tv, full_v + st, c * kBoxCols, k0,
                            g_kv, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows 64 wg .. 64 wg + 63 of the tile.
    // Software-pipelined over KV tiles: the QK^T of tile it runs on the
    // tensor cores while PV of tile it - 1 is issued behind it, and the
    // softmax of tile it runs while that PV is still in flight.
    sm90::reg_alloc<240>();
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int row0 = wg * 64 + (tid / 32) * 16 + lane / 4;   // rows row0, row0 + 8
    const int col0 = 2 * (lane % 4);
    // descriptors: this warpgroup's rows of Q; stage 0's K and V (a stage
    // is 2 kTile further, in 16-byte units)
    const uint64_t dq = sm90::desc_sw128(smem + wg * 64 * 128, 16, 1024);
    const uint64_t dk0 = sm90::desc_sw128(smem + L::kKV, 16, 1024);
    const uint64_t dv0 = sm90::desc_sw128(smem + L::kKV + L::kTile, kBoxBytes, 1024);
    constexpr uint64_t kStageStep = 2 * L::kTile >> 4;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};                    // running max, log2 units
    float l[2] = {0.f, 0.f};                                // this thread's part of the sum
    float s[64], corr[2];                                   // S: QK^T's accumulator
    uint32_t p[32];                                         // P in bf16, PV's A operand

    sm90::mbar_wait(bar_q, 0);
    __syncwarp();                                           // reconverge before wgmma
    if (n_kv > 0) {
      // the first tile: S, then P (O is still zero); peeled off, so the
      // loop below issues its products unconditionally
      sm90::mbar_wait(full_k, 0);
      __syncwarp();
      sm90::wgmma_fence();
      issue_qk<D>(s, dq, dk0);
      sm90::wgmma_wait<0>();
      sm90::reg_fence(s);
      sm90::mbar_arrive(empty_k);
      softmax_tile(a, s, m, l, corr, q_lo, row0, col0, (t_hi - 1) * kRows);
      pack_p(p, s);
    }
    for (int it = 1; it < n_kv; ++it) {
      const int st = it % kStages, prev = (it - 1) % kStages;
      // QK^T of this tile, then PV of the previous one behind it, issued
      // back to back once both tiles have landed
      sm90::mbar_wait(full_k + st, (it / kStages) & 1);
      sm90::mbar_wait(full_v + prev, ((it - 1) / kStages) & 1);
      __syncwarp();
      // o and p were last written below: pin those writes before the fence,
      // or the compiler sinks them between the products
      sm90::reg_fence(o);
      sm90::reg_fence(p);
      sm90::wgmma_fence();
      issue_qk<D>(s, dq, dk0 + st * kStageStep);
      issue_pv<D>(o, p, dv0 + prev * kStageStep);
      sm90::wgmma_wait<1>();                                // QK^T done, PV in flight
      sm90::reg_fence(s);
      sm90::mbar_arrive(empty_k + st);
      softmax_tile(a, s, m, l, corr, q_lo, row0, col0, (t_hi - 1 - it) * kRows);
      sm90::wgmma_wait<0>();                                // PV of the previous tile done
      sm90::reg_fence(o);
      sm90::reg_fence(p);
      sm90::mbar_arrive(empty_v + prev);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i / 2) % 2];
      pack_p(p, s);
    }
    if (n_kv > 0) {                                         // PV of the last tile
      const int st = (n_kv - 1) % kStages;
      sm90::mbar_wait(full_v + st, ((n_kv - 1) / kStages) & 1);
      __syncwarp();
      sm90::reg_fence(o);
      sm90::reg_fence(p);
      sm90::wgmma_fence();
      issue_pv<D>(o, p, dv0 + st * kStageStep);
      sm90::wgmma_wait<0>();
      sm90::reg_fence(o);
      sm90::reg_fence(p);
      sm90::mbar_arrive(empty_v + st);
    }

    __nv_bfloat16* ob = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
      const int qp = q_lo + row0 + 8 * r;
      if (qp >= a.Sq) continue;
      __nv_bfloat16* orow = ob + (int64_t)qp * a.o_ss + col0;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint32_t*>(orow + 8 * c) =
            pack(o[4 * c + 2 * r] * inv, o[4 * c + 2 * r + 1] * inv);
    }
  }
}

template <int D>
cudaError_t launch(const CUtensorMap* maps, const Args& a, cudaStream_t s) {
  constexpr uint32_t bytes = Layout<D>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  flash_attention_sm90_kernel<D>
      <<<a.n_qt * a.H * a.B, kThreads, bytes, s>>>(maps[0], maps[1], maps[2], a);
  return cudaGetLastError();
}

}  // namespace fa90

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
    int B, int H, int num_heads, int head_offset, int kvh, int D, int Sq, int Sk, int causal,
    int window, float scale, int vec, void* stream) {
  if (D < 1 || D > kMaxD || kvh < 1 || num_heads < 1 || head_offset < 0 ||
      num_heads % kvh != 0 || B < 1 || B > 65535 || H > 65535 || Sq < 1 || Sk < 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
         H, num_heads, head_offset, kvh, D, Sq, Sk, causal, window, scale, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 16) return static_cast<int>(launch_dp<16>(dtype, B, a, s));
  if (D <= 32) return static_cast<int>(launch_dp<32>(dtype, B, a, s));
  if (D <= 64) return static_cast<int>(launch_dp<64>(dtype, B, a, s));
  return static_cast<int>(launch_dp<128>(dtype, B, a, s));
}

// The sm90 kernel: bf16, D 64 or 128.  `geometry` holds, for q, k and v in
// turn, the tensor map the wrapper computed: dims[4] (D, S, heads, B),
// byte strides[3] (S, heads, B) and box[4], innermost first.  Returns 0 when
// launched, a cudaError_t when refused (shapes, alignment, launch), or
// -CUresult when a tensor map could not be encoded.  It never falls back
// to the other kernels.
extern "C" int repro_flash_attention_sm90(
    const void* q, const void* k, const void* v, void* o, const int64_t* geometry,
    int64_t o_sb, int64_t o_sh, int64_t o_ss, int B, int H, int num_heads, int head_offset,
    int kvh, int D, int Sq, int Sk, int causal, int window, float scale, void* stream) {
  const int64_t n_qt = (Sq + fa90::kRows - 1) / fa90::kRows;
  if ((D != 64 && D != 128) || B < 1 || kvh < 1 || num_heads < 1 || head_offset < 0 ||
      num_heads % kvh != 0 || Sq < 1 || Sk < 1 || n_qt * H * B > 0x7fffffff ||
      reinterpret_cast<uintptr_t>(o) % 16 != 0 || o_sb % 8 != 0 || o_sh % 8 != 0 ||
      o_ss % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* base[3] = {q, k, v};
  const int64_t want[3][4] = {{D, Sq, H, B}, {D, Sk, kvh, B}, {D, Sk, kvh, B}};
  const int64_t box[4] = {fa90::kBoxCols, fa90::kRows, 1, 1};
  CUtensorMap maps[3];
  for (int t = 0; t < 3; ++t) {
    const int64_t* g = geometry + 11 * t;   // dims[4], strides[3], box[4]
    bool ok = reinterpret_cast<uintptr_t>(base[t]) % 16 == 0;
    for (int i = 0; i < 4; ++i) ok = ok && g[i] == want[t][i] && g[7 + i] == box[i];
    for (int i = 0; i < 3; ++i) ok = ok && g[4 + i] > 0 && g[4 + i] % 16 == 0 &&
                                    g[4 + i] < (int64_t(1) << 40);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    const CUresult r = sm90::encode_bf16_4d(&maps[t], base[t], g, g + 4, g + 7);
    if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  }
  // the real heads of this launch are a prefix: global heads below num_heads
  const int left = num_heads > head_offset ? num_heads - head_offset : 0;
  const int n_real = left < H ? left : H;
  const fa90::Args a{static_cast<__nv_bfloat16*>(o), o_sb, o_sh, o_ss, B, H, n_real,
                     head_offset, num_heads / kvh, kvh, Sq, Sk, causal, window,
                     static_cast<int>(n_qt), scale * 1.4426950408889634f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(D == 64 ? fa90::launch<64>(maps, a, s) : fa90::launch<128>(maps, a, s));
}
