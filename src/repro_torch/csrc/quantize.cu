// Block-wise int8 quantize and dequantize (VELOC lossy compression module,
// the "q8" shard encoding) for Hopper.
//
// Replaces the TPU kernels quantize_pallas (src/repro/kernels/quantize.py:27,
// _quant_kernel :18) and dequantize_pallas (quantize.py:50, _dequant_kernel
// :45).  For each block of 256 float32 values:
//   s = max(absmax, 1e-30) * f32(1/127)   (the multiply XLA makes of the
//                                          JAX package's "/ 127.0" under jit)
//   q = clip(rint(x / s), -127, 127)      as int8, round half to even
// and dequantize writes q * s.  A block holding a NaN gets scale NaN (always
// the quiet NaN 0x7FC00000) and codes 0; a block holding +-inf gets scale
// inf and codes 0.  Both restore as NaN, as in the JAX package.
//
// Bound: device-memory bytes.  Quantize reads 4 bytes and writes 1 per value
// (plus 4 per block); dequantize reads 1 and writes 4.  A division and a
// rounding per value are far below the card's float32 rate.
//
// Design: the TPU kernels walk 256-row tiles in grid order; here every
// 256-value block is one warp, so the blocks spread over all SMs with no
// cross-warp step.  Each lane holds 8 consecutive values (two 16-byte loads
// where the base is aligned and the block is whole, scalar loads otherwise),
// the block's absmax is one warp reduction of the values' magnitude bits
// (for non-negative floats the unsigned order of the bits is the float
// order, and every NaN sorts above inf, so a NaN is never lost the way
// fmaxf loses it), and the lane stores its 8 codes in one 8-byte store.
// Values past `n` in the last block read as 0: zeros do not change the
// absmax, so the caller pads nothing.  IEEE arithmetic throughout
// (__fmul_rn, __fdiv_rn, rintf; no fast-math), so the result is bit-exact
// against the plain version and the JAX package.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;         // values per quantization block
constexpr int kPerLane = kBlock / 32;
constexpr int kWarps = 8;           // blocks per CUDA block
constexpr uint32_t kInfBits = 0x7F800000u;
constexpr uint32_t kQuietNaN = 0x7FC00000u;
constexpr float kInv127 = 0x1.020408p-7f;  // float32(1/127)

__device__ __forceinline__ void load8(const float* __restrict__ x,
                                      long long base, long long n,
                                      bool vec, float v[kPerLane]) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(x + base));
    const float4 b = __ldg(reinterpret_cast<const float4*>(x + base) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      v[i] = base + i < n ? __ldg(x + base + i) : 0.0f;
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ s, long long n, long long rows,
                bool aligned) {
  const long long blk = static_cast<long long>(blockIdx.x) * kWarps
                        + (threadIdx.x >> 5);
  if (blk >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const long long base = blk * kBlock + lane * kPerLane;
  float v[kPerLane];
  load8(x, base, n, aligned && blk * kBlock + kBlock <= n, v);

  uint32_t mag = 0;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    mag = max(mag, __float_as_uint(v[i]) & 0x7FFFFFFFu);
  }
  mag = __reduce_max_sync(0xFFFFFFFFu, mag);
  const float scale = mag > kInfBits
      ? __uint_as_float(kQuietNaN)
      : __fmul_rn(fmaxf(__uint_as_float(mag), 1e-30f), kInv127);

  uint32_t packed[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    float r = rintf(__fdiv_rn(v[i], scale));
    if (r != r) r = 0.0f;  // NaN -> 0 before the clamp, which would drop it
    r = fminf(fmaxf(r, -127.0f), 127.0f);
    const uint32_t code = static_cast<uint32_t>(
        static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(r))));
    packed[i >> 2] |= code << (8 * (i & 3));
  }
  *reinterpret_cast<uint2*>(q + base) = make_uint2(packed[0], packed[1]);
  if (lane == 0) s[blk] = scale;
}

__global__ void __launch_bounds__(kWarps * 32)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                  float* __restrict__ out, long long n, long long rows,
                  bool aligned) {
  const long long blk = static_cast<long long>(blockIdx.x) * kWarps
                        + (threadIdx.x >> 5);
  if (blk >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long base = blk * kBlock + lane * kPerLane;
  const uint2 codes = __ldg(reinterpret_cast<const uint2*>(q + base));
  const float scale = __ldg(s + blk);
  float v[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const uint32_t word = i < 4 ? codes.x : codes.y;
    const int8_t c = static_cast<int8_t>((word >> (8 * (i & 3))) & 0xFFu);
    v[i] = __fmul_rn(static_cast<float>(c), scale);
  }
  if (aligned && base + kPerLane <= n) {
    float4* o = reinterpret_cast<float4*>(out + base);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      if (base + i < n) out[base + i] = v[i];
    }
  }
}

unsigned int grid_for(long long rows) {
  return static_cast<unsigned int>((rows + kWarps - 1) / kWarps);
}

}  // namespace

// x: n float32 values (4-byte aligned; 16-byte aligned for the vector
// loads, else scalar loads); q: ceil(n/256)*256 int8 codes, 8-byte aligned;
// s: ceil(n/256) float32 scales.  n > 0 (else cudaErrorInvalidValue,
// nothing launched).  Launches on `stream`; returns cudaGetLastError().
extern "C" int veloc_quantize(const void* x, void* q, void* s, long long n,
                              void* stream) {
  if (n <= 0 || reinterpret_cast<uintptr_t>(x) % 4 != 0
      || reinterpret_cast<uintptr_t>(q) % 8 != 0
      || reinterpret_cast<uintptr_t>(s) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = (n + kBlock - 1) / kBlock;
  quantize_kernel<<<grid_for(rows), kWarps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(s), n, rows,
      reinterpret_cast<uintptr_t>(x) % 16 == 0);
  return static_cast<int>(cudaGetLastError());
}

// q: ceil(n/256)*256 int8 codes, 8-byte aligned; s: ceil(n/256) float32
// scales; out: n float32 values (16-byte aligned for the vector stores,
// else scalar stores).  n > 0 (else cudaErrorInvalidValue).  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int veloc_dequantize(const void* q, const void* s, void* out,
                                long long n, void* stream) {
  if (n <= 0 || reinterpret_cast<uintptr_t>(q) % 8 != 0
      || reinterpret_cast<uintptr_t>(s) % 4 != 0
      || reinterpret_cast<uintptr_t>(out) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = (n + kBlock - 1) / kBlock;
  dequantize_kernel<<<grid_for(rows), kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<float*>(out), n, rows,
      reinterpret_cast<uintptr_t>(out) % 16 == 0);
  return static_cast<int>(cudaGetLastError());
}
