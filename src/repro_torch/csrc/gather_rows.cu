// Row gather (VELOC device-side delta capture: pack the dirty chunks
// contiguously before the device-to-host copy) for Hopper.
//
// Replaces the TPU kernel gather_rows_pallas
// (src/repro/kernels/checksum.py:149): out[j] = x[idx[j]] for rows of
// `chunk` uint32 words.  x is a flat buffer of n_words words; its last row
// may be ragged, and the words of a gathered row past n_words are written
// as 0 (the zero padding the fingerprint kernels hash).
//
// Bound: device-memory bytes, 2 * n_out * chunk * 4 (each selected row read
// once and written once).  At 1% dirty that is a few MB, so the launch
// itself dominates; the kernel is kept simple rather than tuned.
//
// Design: on the TPU the index vector rides in scalar-prefetch memory and
// the grid DMAs one selected row per step.  Here the grid is (n_out, blocks
// per row): each block reads its row's index itself and copies a 16 KiB
// slice of the row with 16-byte loads and stores (neighbouring threads on
// neighbouring addresses), so a 64 KiB row spreads over 4 blocks.  The
// wrapper checks 0 <= idx < rows on the host, where the indices come from.
// 16-byte accesses need a 16-byte aligned x and chunk % 4 == 0; otherwise
// the kernel copies single words.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;
constexpr int kWordsPerBlock = kThreads * kVecPerThread * 4;  // 16 KiB

__device__ __forceinline__ uint32_t word_or_zero(const uint32_t* x,
                                                 long long g,
                                                 long long n_words) {
  return g < n_words ? __ldg(x + g) : 0u;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const uint32_t* __restrict__ x, long long n_words,
                   int chunk, const int* __restrict__ idx,
                   uint32_t* __restrict__ out) {
  const long long start = static_cast<long long>(idx[blockIdx.x]) * chunk;
  const long long avail = n_words - start;
  uint32_t* dst = out + static_cast<long long>(blockIdx.x) * chunk;
  const int lo = blockIdx.y * kWordsPerBlock;
  const int hi = min(lo + kWordsPerBlock, chunk);
  if (kVec) {
    const uint4* src = reinterpret_cast<const uint4*>(x + start);
    uint4* dv = reinterpret_cast<uint4*>(dst);
    for (int v = (lo >> 2) + threadIdx.x; v < (hi >> 2); v += kThreads) {
      const long long w = 4LL * v;
      uint4 q;
      if (w + 4 <= avail) {
        q = __ldg(src + v);
      } else {  // the ragged tail of the last row
        q.x = word_or_zero(x, start + w, n_words);
        q.y = word_or_zero(x, start + w + 1, n_words);
        q.z = word_or_zero(x, start + w + 2, n_words);
        q.w = word_or_zero(x, start + w + 3, n_words);
      }
      dv[v] = q;
    }
  } else {
    for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
      dst[i] = word_or_zero(x, start + i, n_words);
    }
  }
}

}  // namespace

// x: n_words uint32 words in rows of `chunk`; idx: n_out int32 row indices
// on the device, each in [0, ceil(n_words / chunk)); out: (n_out, chunk)
// uint32, 16-byte aligned.  n_out > 0.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int veloc_gather_rows(const void* x, long long n_words, int chunk,
                                 const void* idx, long long n_out, void* out,
                                 void* stream) {
  const dim3 grid(static_cast<unsigned int>(n_out),
                  (chunk + kWordsPerBlock - 1) / kWordsPerBlock);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xw = static_cast<const uint32_t*>(x);
  const auto* ix = static_cast<const int*>(idx);
  auto* o = static_cast<uint32_t*>(out);
  if (chunk % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0
      && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    gather_rows_kernel<true><<<grid, kThreads, 0, s>>>(xw, n_words, chunk, ix,
                                                       o);
  } else {
    gather_rows_kernel<false><<<grid, kThreads, 0, s>>>(xw, n_words, chunk,
                                                        ix, o);
  }
  return static_cast<int>(cudaGetLastError());
}
