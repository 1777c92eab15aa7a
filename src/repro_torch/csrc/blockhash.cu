// Block fingerprints and fused fingerprint + diff (VELOC incremental
// checkpointing: dirty-chunk detection) for Hopper.
//
// Replaces the TPU kernels blockhash_pallas
// (src/repro/kernels/checksum.py:84) and blockhash_diff_pallas
// (src/repro/kernels/checksum.py:115), which share _blockhash_rows.  A flat
// buffer of n_words uint32 words is cut into rows of `chunk` words; the last
// row may be ragged, and its words past n_words are read as 0 and hashed
// like any other word.  For each word x at position i of its row:
//   y  = (x ^ x>>15) * 0x9E3779B1;  y = (y ^ y>>13) * 0x85EBCA77;  y ^= y>>16
//   h1 += y * (2i+1)
//   h2 += (y ^ w2) * w2,  w2 = ((i+1) * 0xC2B2AE3D) | 1
// all in wrapping uint32.  A zero word adds w2*w2 to h2, so the padding of
// the ragged row must be hashed, not skipped, to match the JAX package.
// blockhash writes (h1, h2) per row; blockhash_diff also compares them with
// the previous pair `prev[row]` and writes dirty[row] = 0 or 1.
//
// Bound: device-memory bytes.  Each word costs about 18 integer operations
// (counting a multiply-add as two), about 0.3-0.5 ps of the H100's 32-bit
// integer throughput, while reading its 4 bytes at 3.35 TB/s takes 1.2 ps;
// so the kernel keeps its loads 16 bytes wide and many rows in flight.
//
// Design: the TPU kernels walk 64-row tiles in grid order with the weights
// as broadcast iotas; here each row is one independent block of 256
// threads (a 64 KiB row is 4096 16-byte vectors, 16 per thread), so there is
// no cross-block sum.  Each thread computes the weights from the word index
// (no weight is read from memory), keeps h1 and h2 in registers, and the
// block reduces them with warp shuffles and one shared-memory step.  uint32
// addition wraps and is associative, so any order is bit-exact.  Both entry
// points share one __device__ row hash, so their fingerprints are identical.
// 16-byte loads need a 16-byte aligned buffer and chunk % 4 == 0; otherwise
// the kernel reads single words.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kMix1 = 0x9E3779B1u;
constexpr uint32_t kMix2 = 0x85EBCA77u;
constexpr uint32_t kMix3 = 0xC2B2AE3Du;

__device__ __forceinline__ void hash_word(uint32_t x, uint32_t i,
                                          uint32_t& h1, uint32_t& h2) {
  uint32_t y = (x ^ (x >> 15)) * kMix1;
  y = (y ^ (y >> 13)) * kMix2;
  y ^= y >> 16;
  h1 += y * (2u * i + 1u);
  const uint32_t w2 = ((i + 1u) * kMix3) | 1u;
  h2 += (y ^ w2) * w2;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ __forceinline__ uint32_t word_or_zero(const uint32_t* x,
                                                 long long g,
                                                 long long n_words) {
  return g < n_words ? __ldg(x + g) : 0u;
}

// Fingerprint pair of row blockIdx.x; valid in thread 0 only.
template <bool kVec>
__device__ __forceinline__ void hash_row(const uint32_t* __restrict__ x,
                                         long long n_words, int chunk,
                                         uint32_t& h1, uint32_t& h2) {
  const long long start = static_cast<long long>(blockIdx.x) * chunk;
  const long long avail = n_words - start;  // >= 1 for every launched row
  h1 = 0u;
  h2 = 0u;
  if (kVec) {
    const uint4* row = reinterpret_cast<const uint4*>(x + start);
    const int nvec = chunk >> 2;
#pragma unroll 4
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
      const long long w = 4LL * v;
      uint4 q;
      if (w + 4 <= avail) {
        q = __ldg(row + v);
      } else {  // the ragged tail of the last row
        q.x = word_or_zero(x, start + w, n_words);
        q.y = word_or_zero(x, start + w + 1, n_words);
        q.z = word_or_zero(x, start + w + 2, n_words);
        q.w = word_or_zero(x, start + w + 3, n_words);
      }
      const uint32_t i = static_cast<uint32_t>(w);
      hash_word(q.x, i, h1, h2);
      hash_word(q.y, i + 1u, h1, h2);
      hash_word(q.z, i + 2u, h1, h2);
      hash_word(q.w, i + 3u, h1, h2);
    }
  } else {
    for (int i = threadIdx.x; i < chunk; i += kThreads) {
      hash_word(word_or_zero(x, start + i, n_words),
                static_cast<uint32_t>(i), h1, h2);
    }
  }
  h1 = warp_sum(h1);
  h2 = warp_sum(h2);
  __shared__ uint32_t s1[kThreads / 32], s2[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s1[warp] = h1;
    s2[warp] = h2;
  }
  __syncthreads();
  if (warp == 0) {
    h1 = lane < kThreads / 32 ? s1[lane] : 0u;
    h2 = lane < kThreads / 32 ? s2[lane] : 0u;
    h1 = warp_sum(h1);
    h2 = warp_sum(h2);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
blockhash_kernel(const uint32_t* __restrict__ x, long long n_words,
                 int chunk, uint32_t* __restrict__ fp) {
  uint32_t h1, h2;
  hash_row<kVec>(x, n_words, chunk, h1, h2);
  if (threadIdx.x == 0) {
    fp[2 * static_cast<size_t>(blockIdx.x)] = h1;
    fp[2 * static_cast<size_t>(blockIdx.x) + 1] = h2;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
blockhash_diff_kernel(const uint32_t* __restrict__ x, long long n_words,
                      int chunk, const uint32_t* __restrict__ prev,
                      uint32_t* __restrict__ fp,
                      uint32_t* __restrict__ dirty) {
  uint32_t h1, h2;
  hash_row<kVec>(x, n_words, chunk, h1, h2);
  if (threadIdx.x == 0) {
    const size_t r = blockIdx.x;
    fp[2 * r] = h1;
    fp[2 * r + 1] = h2;
    dirty[r] = (h1 != prev[2 * r] || h2 != prev[2 * r + 1]) ? 1u : 0u;
  }
}

bool vector_path(const void* x, int chunk) {
  return chunk % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

}  // namespace

// x: n_words uint32 words (n_words > 0), cut into rows = ceil(n_words /
// chunk) rows; fp: (rows, 2) uint32.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int veloc_blockhash(const void* x, long long n_words, int chunk,
                               long long rows, void* fp, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xw = static_cast<const uint32_t*>(x);
  auto* out = static_cast<uint32_t*>(fp);
  if (vector_path(x, chunk)) {
    blockhash_kernel<true><<<static_cast<unsigned int>(rows), kThreads, 0,
                             s>>>(xw, n_words, chunk, out);
  } else {
    blockhash_kernel<false><<<static_cast<unsigned int>(rows), kThreads, 0,
                              s>>>(xw, n_words, chunk, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// As veloc_blockhash, and prev: (rows, 2) uint32 fingerprints of the
// previous version; dirty: (rows,) uint32 0/1.
extern "C" int veloc_blockhash_diff(const void* x, long long n_words,
                                    int chunk, long long rows,
                                    const void* prev, void* fp, void* dirty,
                                    void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xw = static_cast<const uint32_t*>(x);
  const auto* pv = static_cast<const uint32_t*>(prev);
  auto* out = static_cast<uint32_t*>(fp);
  auto* d = static_cast<uint32_t*>(dirty);
  if (vector_path(x, chunk)) {
    blockhash_diff_kernel<true><<<static_cast<unsigned int>(rows), kThreads,
                                  0, s>>>(xw, n_words, chunk, pv, out, d);
  } else {
    blockhash_diff_kernel<false><<<static_cast<unsigned int>(rows),
                                   kThreads, 0, s>>>(xw, n_words, chunk, pv,
                                                     out, d);
  }
  return static_cast<int>(cudaGetLastError());
}
