// Chunked Fletcher-style checksum (VELOC integrity module) for Hopper.
//
// Replaces the TPU kernel checksum_pallas (src/repro/kernels/checksum.py:31).
// Per row of `chunk` uint32 words it computes
//   c1 = sum(x_i)          mod 2^32
//   c2 = sum((i+1) * x_i)  mod 2^32
// and writes the pair to out[2*row], out[2*row+1].
//
// Bound: device-memory bytes.  Each word is read once and costs three integer
// operations, so at 3.35 TB/s the card runs out of bytes long before it runs
// out of integer throughput.
//
// Design: the TPU kernel walks 64-row tiles in order; here every row is one
// independent block, so the ~30k rows of a 250 MB shard spread over all SMs
// with no cross-block reduction.  Each thread reads its words as 16-byte
// vectors (neighbouring threads on neighbouring addresses), keeps c1 and c2
// in registers, and the block reduces them with warp shuffles and one small
// shared-memory step.  uint32 addition wraps and is associative, so the
// result is bit-exact whatever order the threads add in.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
checksum_rows_kernel(const uint4* __restrict__ x, uint32_t* __restrict__ out,
                     int chunk_vec) {
  const uint4* row = x + static_cast<size_t>(blockIdx.x) * chunk_vec;
  uint32_t c1 = 0, c2 = 0;
#pragma unroll 4
  for (int v = threadIdx.x; v < chunk_vec; v += kThreads) {
    const uint4 q = __ldg(row + v);
    const uint32_t w = 4u * static_cast<uint32_t>(v) + 1u;  // weight of q.x
    c1 += q.x + q.y + q.z + q.w;
    c2 += q.x * w + q.y * (w + 1u) + q.z * (w + 2u) + q.w * (w + 3u);
  }
  c1 = warp_sum(c1);
  c2 = warp_sum(c2);
  __shared__ uint32_t s1[kThreads / 32], s2[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s1[warp] = c1;
    s2[warp] = c2;
  }
  __syncthreads();
  if (warp == 0) {
    c1 = lane < kThreads / 32 ? s1[lane] : 0u;
    c2 = lane < kThreads / 32 ? s2[lane] : 0u;
    c1 = warp_sum(c1);
    c2 = warp_sum(c2);
    if (lane == 0) {
      out[2 * static_cast<size_t>(blockIdx.x)] = c1;
      out[2 * static_cast<size_t>(blockIdx.x) + 1] = c2;
    }
  }
}

}  // namespace

// x: (rows, chunk) uint32, 16-byte aligned, chunk % 4 == 0, rows > 0.
// out: (rows, 2) uint32.  Launches on `stream`; returns cudaGetLastError().
extern "C" int veloc_checksum_rows(const void* x, void* out, long long rows,
                                   int chunk, void* stream) {
  checksum_rows_kernel<<<static_cast<unsigned int>(rows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint32_t*>(out), chunk / 4);
  return static_cast<int>(cudaGetLastError());
}
