// Layered whole-page gather and scatter for Hopper (sm_90a): the on-device
// UFFDIO_COPY analogue.
//
// Replaces the Pallas TPU kernels `page_gather` (`_copy_kernel`) and
// `page_scatter` (`_copy_kernel_scatter`) in
// src/repro/kernels/page_gather/kernel.py, and with a layer axis the
// reference's `pool.at[:, ids].set(...)` over every layer of a pool
// (src/repro/serve/engine.py `_install_pages`, the copy-on-write):
//   gather:  out[l, i]       = pool[l, ids[i]]
//   scatter: pool[l, ids[i]] = pages[l, i]          (in place; ids unique)
// over pools viewed as [L, P, row_bytes] of any element type: rows
// contiguous, any layer stride (the Pallas contract is L = 1).  A scatter
// reads each layer's source as one run of `src_valid` bytes (the prefilled
// tokens, where they lie) and writes the rest of the n pages as zeros: the
// reference's jnp.pad before the install, with no staging copy.  Page ids
// follow the reference (jnp.take / .at[].set): an id in [-P, 0) means page
// P + id; a gather row whose id lies outside [-P, P) is written with the
// fill pattern the caller passes (jnp.take's fill for the dtype: NaN,
// the signed minimum or the unsigned maximum), and a scatter drops such an
// id.  The kernel never touches memory outside the pool.  Duplicate ids
// after wrapping are undefined for a scatter, as in the reference.
//
// What bounds it on an H100: bytes (each byte read once and written once,
// no arithmetic).  What the design does about it:
// * one launch moves every layer of a pool, so an install or a
//   copy-on-write costs one launch per pool, not one per layer and pool;
// * `bulk` variant: a grid sized to the card (4 CTAs per SM), each CTA
//   walking (layer, page, 8 KB chunk) items.  One thread keeps a ring of 4
//   shared-memory stages in flight with 1-D TMA bulk copies: global ->
//   shared completing on an mbarrier, shared -> global in bulk groups,
//   a stage reused once its store has read it.  No register of the SM
//   carries the data.  A scatter's zero tail and a gather's fill rows are
//   stored from a pad stage the CTA's threads wrote once.  Needs 16-byte
//   aligned rows, layer strides, bases and source runs;
// * `generic` variant, for everything else (rows of 7 or 1000 elements,
//   pools off 16 bytes): the same layered grid, a block copying a row in
//   16-byte vectors where it is aligned and byte by byte where not.
// A copy of 1-2 pages a layer stays at launch and DRAM latency whatever
// the body does; what moves it is the layered launch, which pays that
// latency once per pool and not once per layer.
// Visibility: a copy runs on the caller's stream, so any later kernel on
// that stream sees whole pages only; other streams must order themselves
// after it with an event.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kStages = 4;
constexpr int kStageBytes = 8192;
constexpr int kBulkThreads = 128;     // all zero the tail stage; one copies
constexpr int kBulkCtasPerSm = 4;
constexpr int kBulkSmem = (kStages + 1) * kStageBytes + kStages * 8;
constexpr int kGenericThreads = 256;
constexpr int kGenericCtasPerSm = 8;

struct Copy {
  const char* src;
  const int* src_ids;   // source row i is src_ids[i], or i without ids
  int64_t src_layer;    // bytes between layers
  char* dst;
  const int* dst_ids;
  int64_t dst_layer;
  int64_t row_bytes;
  int64_t src_valid;    // bytes of each layer's source run; pad past it
  int64_t chunk;        // bytes of one item (the whole row in `generic`)
  int64_t chunks;       // items per row
  int64_t items;        // layers * n * chunks
  int n, bound;         // bound: the pool's page count, on the indexed side
  int4 pad;             // 16 bytes written where nothing is read: zeros for a
                        // scatter's tail, the fill pattern for a gather
};

struct Item {
  const char* src;
  char* dst;
  int64_t size;    // bytes of this chunk
  int64_t valid;   // of them read from src; the rest are pad
  bool write;      // false: the destination id is out of range, skipped
};

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo, int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ Item locate(const Copy& c, int64_t j) {
  const int64_t row = j / c.chunks;
  const int64_t off = (j - row * c.chunks) * c.chunk;
  const int i = static_cast<int>(row % c.n);
  const int64_t l = row / c.n;
  // an id in [-P, 0) wraps to P + id (64-bit: no overflow at INT_MIN)
  int64_t s = c.src_ids ? __ldg(c.src_ids + i) : i;
  int64_t d = c.dst_ids ? __ldg(c.dst_ids + i) : i;
  if (c.src_ids && s < 0) s += c.bound;
  if (c.dst_ids && d < 0) d += c.bound;
  const bool read = !c.src_ids || (s >= 0 && s < c.bound);
  Item it;
  it.write = !c.dst_ids || (d >= 0 && d < c.bound);
  it.src = c.src + l * c.src_layer + s * c.row_bytes + off;
  it.dst = c.dst + l * c.dst_layer + d * c.row_bytes + off;
  it.size = clamp64(c.row_bytes - off, 0, c.chunk);
  it.valid = read ? clamp64(c.src_valid - static_cast<int64_t>(i) * c.row_bytes - off, 0, it.size)
                  : 0;
  return it;
}

__global__ void __launch_bounds__(kBulkThreads) bulk_copy_kernel(const Copy c) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* pad = smem + kStages * kStageBytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(pad + kStageBytes);
  // a zero tail, or a gather that may meet an out-of-range id: one stage of pad
  if (c.src_valid < c.n * c.row_bytes || c.src_ids) {
    for (int j = threadIdx.x; j < kStageBytes / 16; j += kBulkThreads)
      reinterpret_cast<int4*>(pad)[j] = c.pad;
    sm90::fence_proxy_async_shared();
    __syncthreads();
  }
  if (threadIdx.x != 0) return;

  // this CTA's items: first, first + step, ... (the grid is <= items)
  const int64_t first = blockIdx.x, step = gridDim.x;
  const int64_t mine = (c.items - first + step - 1) / step;
  for (int s = 0; s < kStages; ++s) sm90::mbar_init(&bar[s], 1);
  sm90::fence_barrier_init();

  // item k into stage k % kStages; a skipped or all-pad item arrives
  // with no bytes, so every stage completes one phase per item
  auto load = [&](int64_t k) {
    const int s = static_cast<int>(k % kStages);
    const Item it = locate(c, first + k * step);
    const uint32_t bytes = it.write ? static_cast<uint32_t>(it.valid) : 0u;
    sm90::mbar_expect_tx(&bar[s], bytes);
    if (bytes) sm90::bulk_load(smem + s * kStageBytes, it.src, bytes, &bar[s]);
  };
  for (int64_t k = 0; k < mine && k < kStages; ++k) load(k);
  for (int64_t k = 0; k < mine; ++k) {
    const int s = static_cast<int>(k % kStages);
    const Item it = locate(c, first + k * step);
    sm90::mbar_wait(&bar[s], static_cast<uint32_t>((k / kStages) & 1));
    if (it.write) {
      if (it.valid) sm90::bulk_store(it.dst, smem + s * kStageBytes, static_cast<uint32_t>(it.valid));
      if (it.valid < it.size)
        sm90::bulk_store(it.dst + it.valid, pad, static_cast<uint32_t>(it.size - it.valid));
    }
    sm90::bulk_commit();
    // refill the stage of item k - 1 once its stores have read it; item
    // k's stores stay in flight meanwhile
    if (k >= 1 && k - 1 + kStages < mine) {
      sm90::bulk_wait_read<1>();
      load(k - 1 + kStages);
    }
  }
  sm90::bulk_wait<0>();
}

__global__ void __launch_bounds__(kGenericThreads) generic_copy_kernel(const Copy c) {
  for (int64_t j = blockIdx.x; j < c.items; j += gridDim.x) {
    const Item it = locate(c, j);
    if (!it.write) continue;
    const char* s = it.src;
    char* d = it.dst;
    const char* pad = reinterpret_cast<const char*>(&c.pad);   // from an element start
    int64_t done = 0;
    if (((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(d)) & 15) == 0) {
      const int64_t nvec = it.size / 16;
      for (int64_t v = threadIdx.x; v < nvec; v += kGenericThreads) {
        const int64_t o = v * 16;
        if (o + 16 <= it.valid) {
          reinterpret_cast<int4*>(d)[v] = reinterpret_cast<const int4*>(s)[v];
        } else if (o >= it.valid) {
          reinterpret_cast<int4*>(d)[v] = c.pad;
        } else {
          for (int b = 0; b < 16; ++b) d[o + b] = o + b < it.valid ? s[o + b] : pad[b];
        }
      }
      done = nvec * 16;
    }
    for (int64_t b = done + threadIdx.x; b < it.size; b += kGenericThreads)
      d[b] = b < it.valid ? s[b] : pad[b & 15];
  }
}

}  // namespace

// Copy `layers` x `n` rows of `row_bytes` from src to dst (see the note at
// the top; gather: src_ids set, src_valid = n * row_bytes; scatter: dst_ids
// set).  pad_lo, pad_hi: the 16 bytes written where nothing is read (little
// endian; zeros for a scatter, the gather's fill pattern repeated).  bulk: 1
// for the TMA bulk variant, whose every address and size the caller has
// checked to be 16-byte aligned; 0 for the generic one.  sms: the card's SM
// count, which sizes the grid.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int repro_page_copy(const void* src, const int* src_ids, long long src_layer,
                               void* dst, const int* dst_ids, long long dst_layer, int layers,
                               int n, long long row_bytes, long long src_valid, int num_pages,
                               unsigned long long pad_lo, unsigned long long pad_hi,
                               int bulk, int sms, void* stream) {
  if (layers <= 0 || n <= 0 || row_bytes <= 0) return 0;
  Copy c;
  c.src = static_cast<const char*>(src);
  c.src_ids = src_ids;
  c.src_layer = src_layer;
  c.dst = static_cast<char*>(dst);
  c.dst_ids = dst_ids;
  c.dst_layer = dst_layer;
  c.row_bytes = row_bytes;
  c.src_valid = src_valid;
  c.chunk = bulk ? (row_bytes < kStageBytes ? row_bytes : kStageBytes) : row_bytes;
  c.chunks = (row_bytes + c.chunk - 1) / c.chunk;
  c.items = static_cast<int64_t>(layers) * n * c.chunks;
  c.n = n;
  c.bound = num_pages;
  c.pad = make_int4(static_cast<int>(pad_lo & 0xffffffffu), static_cast<int>(pad_lo >> 32),
                    static_cast<int>(pad_hi & 0xffffffffu), static_cast<int>(pad_hi >> 32));
  const auto st = static_cast<cudaStream_t>(stream);
  const int64_t cap = static_cast<int64_t>(sms > 0 ? sms : 1) *
                      (bulk ? kBulkCtasPerSm : kGenericCtasPerSm);
  const unsigned grid = static_cast<unsigned>(c.items < cap ? c.items : cap);
  if (bulk)
    bulk_copy_kernel<<<grid, kBulkThreads, kBulkSmem, st>>>(c);
  else
    generic_copy_kernel<<<grid, kGenericThreads, 0, st>>>(c);
  return static_cast<int>(cudaGetLastError());
}

// Host -> device copy of `bytes` from host memory at `src` (pageable or
// pinned) on `stream`, by address: the caller hands over read-only memory
// (a page buffer's read-lease views) without wrapping it in a tensor.
// Returns the cudaError of cudaMemcpyAsync (0 = enqueued).
extern "C" int repro_copy_h2d(void* dst, const void* src, long long bytes, void* stream) {
  return static_cast<int>(cudaMemcpyAsync(dst, src, static_cast<size_t>(bytes),
                                          cudaMemcpyHostToDevice,
                                          static_cast<cudaStream_t>(stream)));
}

// The bulk variant's launch shape: stages, bytes a stage, threads and CTAs
// per SM, dynamic shared memory a CTA (ptxas reports static memory only).
extern "C" void repro_page_copy_bulk_shape(int* out) {
  out[0] = kStages;
  out[1] = kStageBytes;
  out[2] = kBulkThreads;
  out[3] = kBulkCtasPerSm;
  out[4] = kBulkSmem;
}
