// Paged decode attention through a page table, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention` (`_paged_kernel`) in
// src/repro/kernels/paged_attention/kernel.py.  Same contract: one query
// token per sequence, K/V read from a shared page pool [P, page_size, KVH, D]
// through a per-sequence page table, positions >= length masked, lengths
// clamped to pages_per_seq * page_size, table entries outside [0, P) skipped
// (never read), online softmax in fp32, output in the input type, a row of
// length 0 gives zeros.  Two additions: `num_heads` real query heads out
// of H; head i reads KV head i / (num_heads / KVH), heads >= num_heads are
// written as zeros (their rows of the output projection are zero).  And a
// sliding `window` (0: none), the rule of the JAX package's paged decode
// (`decode_attention` on the gathered pages): only positions
// [len - window, len) are visible.
//
// What bounds it on an H100: bytes.  Each valid K/V row is read once
// (2 * length * KVH * D * itemsize per sequence) for 4 * rep * D operations
// (rep = num_heads / KVH <= 8), under 20 operations per byte, far below the
// ~295 the card needs before its math units matter.  So the design is about
// keeping enough bytes in flight (Little's law: 3.35 TB/s x ~0.6 us ~ 2 MB,
// ~16 KB per SM) and launching few, cheap instructions per byte:
//
//   * Split the KV axis over blocks.  The grid is (split, KV head,
//     sequence); a split is `pages_per_split` consecutive table entries.
//     The wrapper picks pages_per_split from the table width, B * KVH and
//     the SM count only (about 4 blocks per SM over the table, at least 128
//     tokens a split): qwen2-1.5b's decode, B=4, KVH=2, 264 pages, gets 33
//     splits of 8 pages.  It never reads `lengths` or the table on the host; a block
//     whose split starts at or past its sequence's length exits at once
//     (idle engine lanes have length 0).
//   * A window moves the splits: they start at the page that holds
//     position len - window (sequence by sequence, on the device) and the
//     wrapper plans them over at most ceil((window - 1) / page_size) + 1
//     pages, so a block never reads a page the window cannot see.  The
//     tokens of that first page before the window are zero-filled by the
//     copy and masked, like the tokens past the length in the last.
//   * Copy engine: cp.async, 16 bytes a thread, into a ring of 3 stages in
//     shared memory (64 tokens of K and V a stage in bf16, 32 in fp32), so a
//     block keeps up to two stages (a whole 128-token split: 64 KB at D 128
//     bf16) in flight while it scores the third.  Out-of-range tokens and
//     pages are zero-filled by the copy (src-size 0) and never read.  The
//     block reads its page ids from the table once, into shared memory.
//     TMA was not taken: a tensor map per layer pool per call costs host
//     time on a decode step that is host-bound already, and rows of a page
//     are KVH * D apart, which cp.async addresses per thread just as well.
//   * bf16 scores a 16-token tile at a time on the tensor cores: each warp
//     takes one tile of every stage, QK^T for all rep query heads with
//     mma.sync.m16n8k16 (rep rows padded to 16, K fragments by ldmatrix),
//     the online softmax once per tile, then PV with P kept in registers
//     (the accumulator layout of QK^T is the A layout of PV) and V by
//     ldmatrix.trans.  Rows rep..15 of the A tiles are zero and their
//     outputs are discarded, so they never reach a real head.  wgmma was not
//     taken: it needs 64-row A tiles and rep <= 8 would leave 7/8 of the
//     unit idle; the products are not what bounds this kernel.
//   * fp32 uses FMA on the CUDA cores: for QK^T the lanes go over tokens
//     (8 tokens a warp, 4 lanes a token over D), for PV over D, with one
//     warp reduction per 8-token tile, not per token.
//   * Merge.  Each block merges its 4 warps through shared memory.  With
//     one split it writes the output itself; otherwise it writes its partial
//     (m, l, acc) in fp32 to scratch [B, KVH, splits, rep, D] (+ m, l) that
//     the wrapper allocates, and a second kernel, launched from the same C
//     entry point on the same stream, merges the live splits of each
//     (sequence, KV head) in split order: deterministic, no atomics, no
//     count kept across blocks (a last-arriving-block merge would need one,
//     which a faulted launch could leave stale).  Empty splits contribute
//     nothing; masked scores are -inf and every exponent is taken against a
//     finite max (0 where nothing is visible), so a length-0 row gives zeros,
//     never NaN; l is clamped at 1e-37 as in the Pallas kernel.
//
// ptxas -v (sm_90a, CUDA 12.8, from `chip_smoke.py`'s build report): no
// spills and no stack frame in any instantiation.  Registers and dynamic
// shared memory per block (the ring, plus fp32's q and p buffers, plus
// 4 bytes a page of the split), by head-dim class DP:
//
//   DP                     16       32       64      128      256
//   bf16 split  regs       40       55       72      119      215
//               smem   18,432   30,720   55,296  104,448  202,752
//   fp32 split  regs       70       79       77      104      136
//               smem   16,896   29,696   55,296  106,496  208,896
//   merge (both types)     40 registers, 4 * (2 * splits + 1) bytes
//
// So at qwen2's D 128 two bf16 blocks fit an SM (its 33 x 8 grid has 178
// live blocks at the measured lengths, all resident at once).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRep = 8;            // query heads per KV head
constexpr int kMaxD = 256;            // head_dim
constexpr int kStages = 3;            // cp.async ring depth
constexpr int kMaxSplitPages = 1024;  // page ids a block holds in shared memory
constexpr int kMaxSplits = 1024;

// Tokens a warp scores per stage, and the row padding of a staged K/V tile
// (16 bytes: rows land on distinct banks for ldmatrix and float4 reads).
template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> { static constexpr int kTok = 16, kPad = 8; };
template <> struct Tile<float> { static constexpr int kTok = 8, kPad = 4; };

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* table;
  const int* lengths;
  void* out;
  float* scratch;              // acc [B,KVH,splits,rep,D], then m, then l
  int B, H, num_heads, kvh, D, num_pool_pages, page_size, pages_per_seq;
  int pages_per_split, splits;
  int window;                  // 0: none
  float scale;
  int vec;                     // rows are 16-byte aligned: cp.async
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ int seq_len(const Args& a, int b) {
  return max(0, min(a.lengths[b], a.pages_per_seq * a.page_size));
}

// What sequence b's query sees: positions [lo, len), read from the page
// that holds lo on; split s covers tokens [first + s * split_tok, ...).
struct Span {
  int len, lo, first;
};
__device__ __forceinline__ Span visible_span(const Args& a, int b) {
  const int len = seq_len(a, b);
  const int lo = a.window > 0 ? max(0, len - a.window) : 0;
  return {len, lo, lo / a.page_size * a.page_size};
}

// Scratch offsets of (b, g, split, r): index into m / l; times D into acc.
__device__ __forceinline__ int64_t part_index(const Args& a, int b, int g, int s, int r) {
  const int rep = a.num_heads / a.kvh;
  return ((int64_t)(b * a.kvh + g) * a.splits + s) * rep + r;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One stage: tokens [tok0, tok0 + ST) of the split into sK / sV ([ST][LD]).
// A thread takes one 16-byte chunk of a row of K and the same chunk of V;
// the 16 (bf16, D 128) threads of a row read its 256 bytes together.
// Tokens before n_lo (ahead of the window) or past n_tok, on a skipped
// page, and columns >= D are zeros.
template <typename T, int DP>
__device__ __forceinline__ void load_stage(const Args& a, T* sK, T* sV, const int* sPage,
                                           const T* kg, const T* vg, int tok0, int n_lo,
                                           int n_tok) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = DP / VEC;                        // 16-byte chunks a row
  constexpr int ST = kWarps * Tile<T>::kTok;
  constexpr int LD = DP + Tile<T>::kPad;
  const int64_t row = (int64_t)a.kvh * a.D;           // one token to the next
  for (int idx = threadIdx.x; idx < ST * CH; idx += kThreads) {
    const int r = idx / CH;
    const int c = (idx % CH) * VEC;
    const int tk = tok0 + r;
    const int page = tk >= n_lo && tk < n_tok ? sPage[tk / a.page_size] : -1;
    const bool ok = page >= 0 && c < a.D;
    const int64_t off = ok ? ((int64_t)page * a.page_size + tk % a.page_size) * row + c : 0;
    T* dk = sK + r * LD + c;
    T* dv = sV + r * LD + c;
    if (a.vec) {                                      // vec: D % VEC == 0
      cp_async16(dk, kg + off, ok ? 16 : 0);          // src-size 0: zeros, nothing read
      cp_async16(dv, vg + off, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const bool in = page >= 0 && c + e < a.D;
        dk[e] = in ? kg[off + e] : from_float<T>(0.f);
        dv[e] = in ? vg[off + e] : from_float<T>(0.f);
      }
    }
  }
}

// ------------------------------------------------------------------- bf16

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (lo) at the lower address
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// d[16x8] += a[16x16] * b[16x8] (bf16 in, fp32 accumulate) where rows 8..15
// of a are zero: only the top half of d (row g = lane / 4, columns 2t, 2t+1,
// t = lane % 4) is kept.  a0 = {row g, k 2t..2t+1}, a2 = {row g, k 2t+8..};
// b0 = {k 2t..2t+1, col g}, b1 = {k 2t+8..2t+9, col g} (PTX ISA, m16n8k16).
__device__ __forceinline__ void mma_top(float* d, uint32_t a0, uint32_t a2, uint32_t b0,
                                        uint32_t b1) {
  float x2, x3;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(x2), "=f"(x3)
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1), "f"(d[0]), "f"(d[1]),
        "f"(0.f), "f"(0.f));
}

// Per-warp state of the bf16 path: this lane holds row g (query head g of
// the group) at columns n * 8 + 2t, 2t + 1.
template <int DP>
struct StateBf16 {
  uint32_t qa[DP / 16][2];     // A fragments of q (rows >= rep are zero)
  float acc[DP / 8][2];
  float m, l;                  // l: this lane's part of the row sum

  __device__ void init(const Args& a, const __nv_bfloat16* qg, int rep) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = kc * 16 + half * 8 + 2 * t;
        const float lo = (g < rep && d < a.D) ? to_float(qg[g * a.D + d]) : 0.f;
        const float hi = (g < rep && d + 1 < a.D) ? to_float(qg[g * a.D + d + 1]) : 0.f;
        qa[kc][half] = pack(lo, hi);
      }
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = 0.f;
    m = -INFINITY;
    l = 0.f;
  }

  // Tokens [tk0, tk0 + 16) of the split, staged at rows [row0, row0 + 16).
  __device__ void tile(const Args& a, const __nv_bfloat16* sK, const __nv_bfloat16* sV,
                       const int* sPage, int row0, int tk0, int n_lo, int n_tok) {
    constexpr int LD = DP + Tile<__nv_bfloat16>::kPad;
    const int lane = threadIdx.x % 32, t = lane % 4;
    const int mi = lane / 8, ri = lane % 8;           // ldmatrix: matrix, row
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
      uint32_t b[4];
      ldsm_x4(b, sK + (row0 + (mi / 2) * 8 + ri) * LD + kc * 16 + (mi % 2) * 8);
      mma_top(s[0], qa[kc][0], qa[kc][1], b[0], b[1]);
      mma_top(s[1], qa[kc][0], qa[kc][1], b[2], b[3]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tk = tk0 + nt * 8 + 2 * t + e;
        const bool ok = tk >= n_lo && tk < n_tok && sPage[tk / a.page_size] >= 0;
        s[nt][e] = ok ? s[nt][e] * a.scale : -INFINITY;
        mx = fmaxf(mx, s[nt][e]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float mu = m_new == -INFINITY ? 0.f : m_new;   // nothing visible yet
    const float corr = expf(m - mu);
    m = m_new;
    l *= corr;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = expf(s[nt][e] - mu);
        l += s[nt][e];
      }
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= corr;
      acc[n][1] *= corr;
    }
    const uint32_t p0 = pack(s[0][0], s[0][1]);           // {row g, tokens 2t..}
    const uint32_t p2 = pack(s[1][0], s[1][1]);           // {row g, tokens 2t+8..}
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      uint32_t b[4];
      ldsm_x4_trans(b, sV + (row0 + (mi % 2) * 8 + ri) * LD + j * 16 + (mi / 2) * 8);
      mma_top(acc[2 * j], p0, p2, b[0], b[1]);
      mma_top(acc[2 * j + 1], p0, p2, b[2], b[3]);
    }
  }

  // This warp's (m, l, acc) into the block's merge buffers.
  __device__ void stash(float* sm_m, float* sm_l, float* sm_acc, int warp, int rep) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    float lr = l;
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    if (g >= rep) return;
    if (t == 0) {
      sm_m[warp * kMaxRep + g] = m;
      sm_l[warp * kMaxRep + g] = lr;
    }
    float* row = sm_acc + (warp * kMaxRep + g) * DP;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      row[n * 8 + 2 * t] = acc[n][0];
      row[n * 8 + 2 * t + 1] = acc[n][1];
    }
  }
};

// ------------------------------------------------------------------- fp32

// Per-warp state of the fp32 path: lane = j + 8 * part scores token j of the
// warp's 8-token tile over the float4 columns part, part + 4, ... of D, and
// accumulates the output columns lane, lane + 32, ...
template <int DP>
struct StateF32 {
  static constexpr int EPL = DP / 32 > 0 ? DP / 32 : 1;
  float acc[kMaxRep][EPL];
  float m[kMaxRep], l[kMaxRep];   // l: this lane's token's part of the sum

  __device__ void init() {
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
    }
  }

  __device__ void tile(const Args& a, const float* sK, const float* sV, const float* sQ,
                       float* sP, const int* sPage, int row0, int tk0, int n_lo, int n_tok,
                       int rep) {
    constexpr int LD = DP + Tile<float>::kPad;
    constexpr int TT = Tile<float>::kTok;
    const int lane = threadIdx.x % 32, j = lane % TT, part = lane / TT;
    const int tk = tk0 + j;
    const bool ok = tk >= n_lo && tk < n_tok && sPage[tk / a.page_size] >= 0;
    float sc[kMaxRep];
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) sc[r] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(sK + (row0 + j) * LD);
#pragma unroll 4
    for (int i = 0; i < DP / 16; ++i) {
      const float4 kv = k4[part + 4 * i];
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < rep) {
          const float4 qv = reinterpret_cast<const float4*>(sQ + r * DP)[part + 4 * i];
          sc[r] = fmaf(qv.x, kv.x, fmaf(qv.y, kv.y, fmaf(qv.z, kv.z, fmaf(qv.w, kv.w, sc[r]))));
        }
      }
    }
    float corr[kMaxRep];
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      corr[r] = 1.f;
      if (r < rep) {
        float x = sc[r];
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        x = ok ? x * a.scale : -INFINITY;
        float mx = x;
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float m_new = fmaxf(m[r], mx);
        const float mu = m_new == -INFINITY ? 0.f : m_new;
        corr[r] = expf(m[r] - mu);
        const float p = expf(x - mu);
        m[r] = m_new;
        l[r] = l[r] * corr[r] + p;
        if (part == 0) sP[r * TT + j] = p;
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
        float pj[TT];
#pragma unroll
        for (int jj = 0; jj < TT; ++jj) pj[jj] = sP[r * TT + jj];
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const int d = lane + 32 * e;
          float v = acc[r][e] * corr[r];
          if (d < DP) {
#pragma unroll
            for (int jj = 0; jj < TT; ++jj) v = fmaf(pj[jj], sV[(row0 + jj) * LD + d], v);
          }
          acc[r][e] = v;
        }
      }
    }
    __syncwarp();                   // sP is rewritten by the next tile
  }

  __device__ void stash(float* sm_m, float* sm_l, float* sm_acc, int warp, int rep) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
        float lr = lane < Tile<float>::kTok ? l[r] : 0.f;   // part 0 lanes: one per token
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        lr += __shfl_xor_sync(0xffffffffu, lr, 4);
        if (lane == 0) {
          sm_m[warp * kMaxRep + r] = m[r];
          sm_l[warp * kMaxRep + r] = lr;
        }
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const int d = lane + 32 * e;
          if (d < DP) sm_acc[(warp * kMaxRep + r) * DP + d] = acc[r][e];
        }
      }
    }
  }
};

// ----------------------------------------------------------------- kernels

template <typename T, int DP>
struct Smem {
  static constexpr int ST = kWarps * Tile<T>::kTok;         // tokens a stage
  static constexpr int LD = DP + Tile<T>::kPad;
  static constexpr size_t kRing = sizeof(T) * kStages * 2 * ST * LD;
  static constexpr size_t kMerge = sizeof(float) * kWarps * kMaxRep * (DP + 2);
  static constexpr size_t kQ = sizeof(T) == 4 ? sizeof(float) * kMaxRep * DP : 0;
  static constexpr size_t kP = sizeof(T) == 4 ? sizeof(float) * kWarps * kMaxRep * Tile<T>::kTok : 0;
  static_assert(kMerge <= kRing, "the merge buffers reuse the ring");
  static size_t bytes(int pages_per_split) {
    return kRing + kQ + kP + sizeof(int) * pages_per_split;
  }
};

// Zeros for query heads [h0, h1) of sequence b.
template <typename T>
__device__ void zero_heads(const Args& a, int b, int h0, int h1) {
  T* o = static_cast<T*>(a.out) + ((int64_t)b * a.H + h0) * a.D;
  for (int idx = threadIdx.x; idx < (h1 - h0) * a.D; idx += kThreads) o[idx] = from_float<T>(0.f);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) paged_attention_split_kernel(Args a) {
  using S = Smem<T, DP>;
  constexpr int ST = S::ST, LD = S::LD, TT = Tile<T>::kTok;
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int rep = a.num_heads / a.kvh;
  const Span sp = visible_span(a, b);
  const int split_tok = a.pages_per_split * a.page_size;
  const int start = sp.first + split * split_tok;
  if (a.splits == 1 && g == 0) zero_heads<T>(a, b, a.num_heads, a.H);   // padded heads
  if (start >= sp.len) {                    // nothing of this sequence here
    if (a.splits == 1) zero_heads<T>(a, b, g * rep, (g + 1) * rep);
    return;
  }
  const int n_tok = min(split_tok, sp.len - start);
  const int n_lo = max(0, sp.lo - start);   // the split's tokens ahead of the window

  extern __shared__ uint4 smem_raw[];
  char* smem = reinterpret_cast<char*>(smem_raw);
  T* ring = reinterpret_cast<T*>(smem);
  float* sQ = reinterpret_cast<float*>(smem + S::kRing);
  float* sP = reinterpret_cast<float*>(smem + S::kRing + S::kQ);
  int* sPage = reinterpret_cast<int*>(smem + S::kRing + S::kQ + S::kP);

  // the split's page ids, each read once; pages past the length are not
  // read from the table (nor, a fortiori, from the pool)
  const int first_page = start / a.page_size;
  const int n_pages = (n_tok + a.page_size - 1) / a.page_size;
  for (int i = threadIdx.x; i < n_pages; i += kThreads) {
    const int p = a.table[(int64_t)b * a.pages_per_seq + first_page + i];
    sPage[i] = (p >= 0 && p < a.num_pool_pages) ? p : -1;
  }
  const T* qg = static_cast<const T*>(a.q) + ((int64_t)b * a.H + g * rep) * a.D;
  if constexpr (sizeof(T) == 4) {
    for (int idx = threadIdx.x; idx < kMaxRep * DP; idx += kThreads) {
      const int r = idx / DP, d = idx % DP;
      sQ[idx] = (r < rep && d < a.D) ? to_float(qg[r * a.D + d]) : 0.f;
    }
  }
  __syncthreads();

  const T* kg = static_cast<const T*>(a.k_pool) + (int64_t)g * a.D;
  const T* vg = static_cast<const T*>(a.v_pool) + (int64_t)g * a.D;
  auto slot_k = [&](int st) { return ring + (st % kStages) * 2 * ST * LD; };
  const int n_st = (n_tok + ST - 1) / ST;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_st)
      load_stage<T, DP>(a, slot_k(st), slot_k(st) + ST * LD, sPage, kg, vg, st * ST, n_lo, n_tok);
    cp_async_commit();
  }

  using State = typename std::conditional<sizeof(T) == 2, StateBf16<DP>, StateF32<DP>>::type;
  State state;
  if constexpr (sizeof(T) == 2) state.init(a, qg, rep);
  else state.init();

  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<kStages - 2>();          // stage st has landed
    __syncthreads();                        // ... for every thread; stage st-1 is consumed
    const int nx = st + kStages - 1;
    if (nx < n_st)
      load_stage<T, DP>(a, slot_k(nx), slot_k(nx) + ST * LD, sPage, kg, vg, nx * ST, n_lo, n_tok);
    cp_async_commit();
    const int row0 = warp * TT;
    const int tk0 = st * ST + row0;
    if (tk0 < n_tok) {
      const T* sK = slot_k(st);
      if constexpr (sizeof(T) == 2)
        state.tile(a, sK, sK + ST * LD, sPage, row0, tk0, n_lo, n_tok);
      else
        state.tile(a, sK, sK + ST * LD, sQ, sP + warp * kMaxRep * TT, sPage, row0, tk0, n_lo,
                   n_tok, rep);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                          // the ring is free: merge buffers

  float* sm_acc = reinterpret_cast<float*>(smem);
  float* sm_m = sm_acc + kWarps * kMaxRep * DP;
  float* sm_l = sm_m + kWarps * kMaxRep;
  state.stash(sm_m, sm_l, sm_acc, warp, rep);
  __syncthreads();

  for (int idx = threadIdx.x; idx < rep * a.D; idx += kThreads) {
    const int r = idx / a.D, d = idx % a.D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * kMaxRep + r]);
    const float mu = mx == -INFINITY ? 0.f : mx;
    float lsum = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w * kMaxRep + r] - mu);
      lsum += sm_l[w * kMaxRep + r] * c;
      acc += sm_acc[(w * kMaxRep + r) * DP + d] * c;
    }
    if (a.splits == 1) {
      T* o = static_cast<T*>(a.out) + ((int64_t)b * a.H + g * rep) * a.D;
      o[idx] = from_float<T>(acc / fmaxf(lsum, 1e-37f));   // same clamp as the Pallas kernel
    } else {
      const int64_t pi = part_index(a, b, g, split, r);
      const int64_t n_part = (int64_t)a.B * a.kvh * a.splits * rep;
      a.scratch[pi * a.D + d] = acc;
      if (d == 0) {
        a.scratch[n_part * a.D + pi] = mx;
        a.scratch[n_part * (a.D + 1) + pi] = lsum;
      }
    }
  }
}

// Merges the live splits of one (query head of the group, KV head,
// sequence) in split order: warp 0 takes the split weights with its lanes
// over splits, then every thread sums its output columns over the splits,
// eight loads in flight at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attention_merge_kernel(Args a) {
  const int r = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int rep = a.num_heads / a.kvh;
  const Span sp = visible_span(a, b);
  const int split_tok = a.pages_per_split * a.page_size;
  const int n = (sp.len - sp.first + split_tok - 1) / split_tok;   // splits that ran
  extern __shared__ float sw[];             // [splits] weights, the sum, [splits] l
  float* sl = sw + a.splits + 1;
  const int64_t n_part = (int64_t)a.B * a.kvh * a.splits * rep;
  const int64_t p0 = part_index(a, b, g, 0, r);           // split s at p0 + s * rep
  const float* pm = a.scratch + n_part * a.D + p0;
  const float* pl = a.scratch + n_part * (a.D + 1) + p0;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float mx = -INFINITY;
    for (int s = lane; s < n; s += 32) {      // m and l of a split in one round trip
      const float m = pm[(int64_t)s * rep];
      sw[s] = m;
      sl[s] = pl[(int64_t)s * rep];
      mx = fmaxf(mx, m);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float mu = mx == -INFINITY ? 0.f : mx;
    float lsum = 0.f;
    for (int s = lane; s < n; s += 32) {      // each lane rereads only its own entries
      const float w = expf(sw[s] - mu);
      sw[s] = w;
      lsum += sl[s] * w;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
    if (lane == 0) sw[a.splits] = fmaxf(lsum, 1e-37f);   // same clamp as the Pallas kernel
  }
  __syncthreads();
  const float* pacc = a.scratch + p0 * a.D;
  const int64_t step = (int64_t)rep * a.D;                // one split to the next
  T* o = static_cast<T*>(a.out) + ((int64_t)b * a.H + g * rep + r) * a.D;
  for (int d = threadIdx.x; d < a.D; d += kThreads) {
    float acc = 0.f;
#pragma unroll 8
    for (int s = 0; s < n; ++s) acc = fmaf(sw[s], pacc[s * step + d], acc);
    o[d] = from_float<T>(acc / sw[a.splits]);
  }
  if (g == 0 && r == 0) zero_heads<T>(a, b, a.num_heads, a.H);   // padded heads
}

template <typename T, int DP>
cudaError_t launch_dp(const Args& a, cudaStream_t stream) {
  const size_t smem = Smem<T, DP>::bytes(a.pages_per_split);
  auto* kernel = paged_attention_split_kernel<T, DP>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(a.splits, a.kvh, a.B), kThreads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const size_t merge_smem = sizeof(float) * (2 * a.splits + 1);
  paged_attention_merge_kernel<T>
      <<<dim3(a.num_heads / a.kvh, a.kvh, a.B), kThreads, merge_smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const Args& a, cudaStream_t s) {
  if (a.D <= 16) return launch_dp<T, 16>(a, s);
  if (a.D <= 32) return launch_dp<T, 32>(a, s);
  if (a.D <= 64) return launch_dp<T, 64>(a, s);
  if (a.D <= 128) return launch_dp<T, 128>(a, s);
  return launch_dp<T, 256>(a, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window: 0 (none) or the sliding
// window.  The caller picks pages_per_split and splits to cover the visible
// span (pages_per_seq, or with a window min(pages_per_seq,
// ceil((window - 1) / page_size) + 1) pages: splits * pages_per_split >=
// span > (splits - 1) * pages_per_split) and, for splits > 1, passes fp32
// scratch of B * KVH * splits * rep * (D + 2) elements.  vec:
// k_pool / v_pool are 16-byte aligned and D * itemsize is a multiple of 16.
// Launches one kernel, or two for splits > 1, on `stream`; returns
// cudaGetLastError() after them (0 = launched).  Refuses what the kernels do
// not take.
extern "C" int repro_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                     const int* table, const int* lengths, void* out,
                                     float* scratch, int dtype, int B, int H, int num_heads,
                                     int kvh, int D, int num_pool_pages, int page_size,
                                     int pages_per_seq, int pages_per_split, int splits,
                                     int window, float scale, int vec, void* stream) {
  const int64_t span =
      window > 0 && page_size > 0
          ? std::min<int64_t>(pages_per_seq, ((int64_t)window - 1 + page_size - 1) / page_size + 1)
          : pages_per_seq;
  if (B < 1 || B > 65535 || kvh < 1 || kvh > 65535 || D < 1 || D > kMaxD ||
      num_heads < 1 || num_heads > H || num_heads % kvh != 0 || num_heads / kvh > kMaxRep ||
      page_size < 1 || pages_per_seq < 1 || pages_per_split < 1 ||
      pages_per_split > kMaxSplitPages || splits < 1 || splits > kMaxSplits ||
      window < 0 || (int64_t)splits * pages_per_split < span ||
      (int64_t)(splits - 1) * pages_per_split >= span ||
      (int64_t)pages_per_seq * page_size > INT32_MAX || (splits > 1 && scratch == nullptr) ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pool, v_pool, table, lengths, out, scratch, B, H, num_heads, kvh, D,
               num_pool_pages, page_size, pages_per_seq, pages_per_split, splits, window,
               scale, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch_typed<float>(a, s)
                                     : launch_typed<__nv_bfloat16>(a, s);
  return static_cast<int>(err);
}
