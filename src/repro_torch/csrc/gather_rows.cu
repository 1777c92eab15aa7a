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
// once and written once) plus the 4 * n_out bytes of the indices.  A 1 %
// version of the delta path's largest leaf gathers 10 rows of 64 KiB (a
// 0.39 us bound that no launch reaches: there launch and one DRAM round
// trip are the floor); a 10 % version gathers 100 rows, 13.1 MB, where the
// bytes can bound it.
//
// Design.  On the TPU the index vector rides in scalar-prefetch memory and
// the grid DMAs one selected row per step.  Hopper's counterpart is the
// kernel's parameter space: the C entry point copies the host's indices by
// value into the launch parameters (CUDA 12.1 and later take up to 32,764
// bytes of them), so no index tensor is made on the card and nothing is
// copied from host to device before the launch.  Every block reads its
// row's index from the constant bank, which broadcasts it to the block.
// The parameter struct is declared __grid_constant__: indexing a by-value
// kernel parameter with blockIdx would otherwise let the compiler copy the
// whole struct (up to 32 KB) into each thread's local memory; as a grid
// constant it is read in place.  The launch copies the whole struct, so
// three capacities (64, 1,024 and 8,000 indices) keep a 10-row list at
// 300 bytes: on an H100 80GB HBM3 at 700 W one capacity of 8,000 took
// 0.0023 ms more a launch at 10 and at 100 rows.  The Python wrapper
// splits a longer list into launches of at most 8,000.
//
// The grid is (slices of a row, rows): each block copies a 4 KiB slice, so
// a 64 KiB row spreads over 16 blocks and a 10-row gather runs 160 blocks on
// the 132 SMs.  Each thread issues both of its 16-byte loads before its
// first store (a fixed, unrolled count; neighbouring threads on neighbouring
// addresses), and stores stream (st.global.cs): the only reader of the
// output is the device-to-host copy that follows.  Slices of 2, 4 and
// 16 KiB timed within 0.0003 ms of each other there, at 10 rows (an empty
// kernel's time plus ~0.001 ms) and at 100 (an empty kernel's time plus
// the bytes at the memory's rate): what is left is the launch.  The
// wrapper checks 0 <= idx < rows on the host, where the indices come from.
// 16-byte accesses need a 16-byte aligned x and out and chunk % 4 == 0;
// otherwise the kernel copies single words.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVecPerThread = 2;
constexpr int kWordsPerBlock = kThreads * kVecPerThread * 4;  // 4 KiB
constexpr int kMaxIndices = 8000;  // 32,032 bytes of parameters in all

template <int kCap>
struct GatherParams {
  const uint32_t* x;
  uint32_t* out;
  long long n_words;
  int chunk;
  int idx[kCap];
};

__device__ __forceinline__ uint32_t word_or_zero(const uint32_t* x,
                                                 long long g,
                                                 long long n_words) {
  return g < n_words ? x[g] : 0u;
}

template <bool kVec, int kCap>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const __grid_constant__ GatherParams<kCap> p) {
  const long long start = static_cast<long long>(p.idx[blockIdx.y]) * p.chunk;
  const long long avail = p.n_words - start;
  uint32_t* dst = p.out + static_cast<long long>(blockIdx.y) * p.chunk;
  const int lo = blockIdx.x * kWordsPerBlock;
  const int hi = min(lo + kWordsPerBlock, p.chunk);
  if (kVec) {
    const uint4* src = reinterpret_cast<const uint4*>(p.x + start);
    uint4* dv = reinterpret_cast<uint4*>(dst);
    uint4 q[kVecPerThread];
#pragma unroll
    for (int i = 0; i < kVecPerThread; ++i) {  // every load first
      const int v = (lo >> 2) + i * kThreads + threadIdx.x;
      const long long w = 4LL * v;
      if (v >= (hi >> 2)) {
        q[i] = make_uint4(0u, 0u, 0u, 0u);
      } else if (w + 4 <= avail) {
        q[i] = __ldg(src + v);
      } else {  // the ragged tail of the last row
        q[i] = make_uint4(word_or_zero(p.x, start + w, p.n_words),
                          word_or_zero(p.x, start + w + 1, p.n_words),
                          word_or_zero(p.x, start + w + 2, p.n_words),
                          word_or_zero(p.x, start + w + 3, p.n_words));
      }
    }
#pragma unroll
    for (int i = 0; i < kVecPerThread; ++i) {  // then the stores
      const int v = (lo >> 2) + i * kThreads + threadIdx.x;
      if (v < (hi >> 2)) __stcs(dv + v, q[i]);
    }
  } else {
    for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
      dst[i] = word_or_zero(p.x, start + i, p.n_words);
    }
  }
}

template <int kCap>
int launch(const void* x, long long n_words, int chunk, const int* idx,
           int n_out, void* out, cudaStream_t s) {
  // one struct a host thread, filled only up to n_out (the kernel reads
  // idx[0, n_out)); the launch copies the parameters before it returns
  static thread_local GatherParams<kCap> p;
  p.x = static_cast<const uint32_t*>(x);
  p.out = static_cast<uint32_t*>(out);
  p.n_words = n_words;
  p.chunk = chunk;
  memcpy(p.idx, idx, sizeof(int) * n_out);
  const dim3 grid((chunk + kWordsPerBlock - 1) / kWordsPerBlock,
                  static_cast<unsigned int>(n_out));
  if (chunk % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0
      && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    gather_rows_kernel<true, kCap><<<grid, kThreads, 0, s>>>(p);
  } else {
    gather_rows_kernel<false, kCap><<<grid, kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: n_words uint32 words in rows of `chunk`, on the device; idx: n_out
// int32 row indices in HOST memory, each in [0, ceil(n_words / chunk)),
// 0 < n_out <= 8000 (else cudaErrorInvalidValue, nothing launched); out:
// (n_out, chunk) uint32 on the device.  The indices are copied into the
// launch parameters, so idx may be reused as soon as this returns.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int veloc_gather_rows(const void* x, long long n_words, int chunk,
                                 const void* idx, int n_out, void* out,
                                 void* stream) {
  const auto* ix = static_cast<const int*>(idx);
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_out <= 0 || n_out > kMaxIndices || chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_out <= 64) return launch<64>(x, n_words, chunk, ix, n_out, out, s);
  if (n_out <= 1024) {
    return launch<1024>(x, n_words, chunk, ix, n_out, out, s);
  }
  return launch<kMaxIndices>(x, n_words, chunk, ix, n_out, out, s);
}
