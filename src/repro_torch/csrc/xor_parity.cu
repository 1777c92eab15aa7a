// XOR parity over K data rows (VELOC L2 erasure encode and reconstruct) for
// Hopper.
//
// Replaces the TPU kernel xor_reduce_pallas
// (src/repro/kernels/xor_parity.py:28): out[n] = x[0][n] ^ ... ^ x[K-1][n]
// over uint32 words, rows `ld` words apart.
//
// Bound: device-memory bytes.  It reads 4*K*N bytes and writes 4*N, with one
// XOR per word read.
//
// Design: the TPU kernel streams 1 MiB tiles of all K rows through VMEM in
// grid order; here a grid-stride loop spreads the word axis over every SM,
// and each thread XORs the K rows of one 16-byte vector in registers, so the
// K loads of an iteration are independent and in flight together.  The
// caller lays the rows out 16-byte aligned (ld % 4 == 0); the last N % 4
// words are a scalar tail.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // a few waves of the H100's 132 SMs

__global__ void __launch_bounds__(kThreads)
xor_reduce_vec_kernel(const uint32_t* __restrict__ x,
                      uint32_t* __restrict__ out, int k, long long n,
                      long long ld) {
  const long long nvec = n >> 2;
  const long long ldv = ld >> 2;
  const long long tid = blockIdx.x * static_cast<long long>(kThreads)
                        + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (long long v = tid; v < nvec; v += step) {
    uint4 acc = __ldg(xv + v);
#pragma unroll 4
    for (int r = 1; r < k; ++r) {
      const uint4 q = __ldg(xv + r * ldv + v);
      acc.x ^= q.x;
      acc.y ^= q.y;
      acc.z ^= q.z;
      acc.w ^= q.w;
    }
    ov[v] = acc;
  }
  for (long long i = (nvec << 2) + tid; i < n; i += step) {
    uint32_t acc = __ldg(x + i);
    for (int r = 1; r < k; ++r) acc ^= __ldg(x + r * ld + i);
    out[i] = acc;
  }
}

}  // namespace

// x: K rows of n uint32 words, row r at x + r*ld; out: n words.  k >= 1,
// n > 0; x and out 16-byte aligned and ld % 4 == 0 when k > 1 (else
// cudaErrorInvalidValue, nothing launched).  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int veloc_xor_reduce(const void* x, void* out, int k, long long n,
                                long long ld, void* stream) {
  if ((k > 1 && ld % 4 != 0) || reinterpret_cast<uintptr_t>(x) % 16 != 0
      || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long work = (n >> 2) > 0 ? (n >> 2) : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  xor_reduce_vec_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), k, n, ld);
  return static_cast<int>(cudaGetLastError());
}
