// Whole-page gather and scatter for Hopper (sm_90a): the on-device
// UFFDIO_COPY analogue.
//
// Replaces the Pallas TPU kernels `page_gather` (`_copy_kernel`) and
// `page_scatter` (`_copy_kernel_scatter`) in
// src/repro/kernels/page_gather/kernel.py:
//   gather:  out[i]       = pool[ids[i]]
//   scatter: pool[ids[i]] = pages[i]        (in place; ids unique)
// over a pool viewed as [P, row_bytes] of any element type.
//
// What bounds it on an H100: bytes (each page read once and written once,
// no arithmetic).  What the design does about it: one block per page, each
// thread moving 16-byte vectors (int4) so a warp moves 512 contiguous
// bytes per instruction; a byte-wise tail covers a row whose size is not a
// multiple of 16, and a row whose address is not 16-byte aligned is copied
// byte-wise whole.  A page id outside [0, P) is skipped: the kernel never
// touches memory outside the pool.
// Visibility: a scatter runs on the caller's stream, so any later kernel on
// that stream sees whole pages only; other streams must order themselves
// after it with an event.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// src row i = src_ids ? src_ids[i] : i (same for dst); `bound` is the pool's
// page count, checked on the indexed side.
__global__ void __launch_bounds__(kThreads) copy_pages_kernel(
    const char* __restrict__ src, const int* __restrict__ src_ids,
    char* __restrict__ dst, const int* __restrict__ dst_ids, int64_t row_bytes,
    int bound) {
  const int i = blockIdx.x;
  const int s_row = src_ids ? src_ids[i] : i;
  const int d_row = dst_ids ? dst_ids[i] : i;
  if ((src_ids && (s_row < 0 || s_row >= bound)) ||
      (dst_ids && (d_row < 0 || d_row >= bound)))
    return;
  const char* s = src + (int64_t)s_row * row_bytes;
  char* d = dst + (int64_t)d_row * row_bytes;
  int64_t done = 0;
  if (((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(d)) & 15) == 0) {
    const int64_t nvec = row_bytes / 16;
    const int4* s4 = reinterpret_cast<const int4*>(s);
    int4* d4 = reinterpret_cast<int4*>(d);
    for (int64_t j = threadIdx.x; j < nvec; j += kThreads) d4[j] = s4[j];
    done = nvec * 16;
  }
  for (int64_t j = done + threadIdx.x; j < row_bytes; j += kThreads) d[j] = s[j];
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched).
extern "C" int repro_page_gather(const void* pool, const int* ids, void* out,
                                 int n, long long row_bytes, int num_pages,
                                 void* stream) {
  if (n <= 0) return 0;
  copy_pages_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(pool), ids, static_cast<char*>(out), nullptr,
      row_bytes, num_pages);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_page_scatter(void* pool, const int* ids, const void* pages,
                                  int n, long long row_bytes, int num_pages,
                                  void* stream) {
  if (n <= 0) return 0;
  copy_pages_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(pages), nullptr, static_cast<char*>(pool), ids,
      row_bytes, num_pages);
  return static_cast<int>(cudaGetLastError());
}
