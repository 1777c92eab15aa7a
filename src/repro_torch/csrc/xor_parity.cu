// XOR parity over K data rows (VELOC L2 erasure encode and reconstruct) and
// the pairwise XOR of the device-level L2 ring, for Hopper.
//
// veloc_xor_reduce replaces the TPU kernel xor_reduce_pallas
// (src/repro/kernels/xor_parity.py:28): out[n] = x[0][n] ^ ... ^ x[K-1][n]
// over uint32 words, rows `ld` words apart.  veloc_xor_pair replaces
// xor_pair_pallas (xor_parity.py:51, _xor_pair_kernel :47): out = a ^ b, the
// combiner of each step of the ring reduce-scatter in core/partner.py.
//
// Bound: device-memory bytes.  xor_reduce reads 4*K*N bytes and writes 4*N,
// xor_pair reads 8*N and writes 4*N, with one XOR per word read.
//
// xor_reduce: the TPU kernel streams 1 MiB tiles of all K rows through VMEM
// in grid order; here a grid-stride loop spreads the word axis over every
// SM, and each thread XORs the K rows of one 16-byte vector in registers,
// so the K loads of an iteration are independent and in flight together.
//
// xor_pair: one pass and no loop.  Each thread loads one 16-byte vector
// of a and one of b, both in flight before its one store (neighbouring
// threads on neighbouring addresses), in blocks of 128 threads: the grid is
// ceil(N / 512) blocks (40,583 at the ring's stripe of 20,778,326 words),
// so no thread waits on a store before its next loads.  At that stripe,
// on an H100 80GB HBM3 at 700 W, this took 0.0797 ms (93 % of its bound)
// against torch.bitwise_xor's 0.0801; 4 vectors a thread took 0.0810,
// evict-first loads (__ldcs) with streaming stores (__stcs) 0.0814, and
// both together 0.0816.  The last block also takes the last N % 4 words.
//
// The caller lays the rows out 16-byte aligned (ld % 4 == 0; aligned a, b,
// out) and misaligned ones are refused.
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

constexpr int kPairThreads = 128;  // one 16-byte vector of a and of b each

__global__ void __launch_bounds__(kPairThreads)
xor_pair_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                uint32_t* __restrict__ out, long long n) {
  const long long nvec = n >> 2;
  const long long v =
      blockIdx.x * static_cast<long long>(kPairThreads) + threadIdx.x;
  if (v < nvec) {
    const uint4 p = __ldg(reinterpret_cast<const uint4*>(a) + v);
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(b) + v);
    reinterpret_cast<uint4*>(out)[v] =
        make_uint4(p.x ^ q.x, p.y ^ q.y, p.z ^ q.z, p.w ^ q.w);
  }
  if (blockIdx.x + 1 == gridDim.x) {  // the last block: the last n % 4 words
    const long long w = (nvec << 2) + threadIdx.x;
    if (w < n) out[w] = __ldg(a + w) ^ __ldg(b + w);
  }
}

long long grid_for(long long n) {
  const long long work = (n >> 2) > 0 ? (n >> 2) : n;
  const long long blocks = (work + kThreads - 1) / kThreads;
  return blocks > kMaxBlocks ? kMaxBlocks : blocks;
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
  xor_reduce_vec_kernel<<<static_cast<unsigned int>(grid_for(n)), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), k, n, ld);
  return static_cast<int>(cudaGetLastError());
}

// a, b, out: n uint32 words each, all 16-byte aligned (else
// cudaErrorInvalidValue, nothing launched); n > 0.  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int veloc_xor_pair(const void* a, const void* b, void* out,
                              long long n, void* stream) {
  if (n <= 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0
      || reinterpret_cast<uintptr_t>(b) % 16 != 0
      || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long nvec = n >> 2;
  const long long blocks =
      nvec > 0 ? (nvec + kPairThreads - 1) / kPairThreads : 1;
  xor_pair_kernel<<<static_cast<unsigned int>(blocks), kPairThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
