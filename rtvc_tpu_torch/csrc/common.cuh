// Shared helpers of the rtvc_tpu_torch kernels: dtype conversion and warp
// reductions. Every kernel reads and writes float32 or bfloat16 and does
// its arithmetic in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace rtvc {

// dtype codes passed from Python (_build / the op wrappers)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// x rounded to T and widened back (the identity for float)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// _dropout_bits of rtvc_tpu/ops/attention.py: a murmur3-style hash of the
// global (seed, batch, head, query row, key column), uint32 arithmetic with
// wrap-around. A pure function of those coordinates, so any blocking of the
// grid, forward or backward, draws the same bits.
__device__ __forceinline__ uint32_t dropout_bits(uint32_t seed, uint32_t b,
                                                 uint32_t h, uint32_t row,
                                                 uint32_t col) {
  uint32_t x = (row * 0x9E3779B1u) ^ (col * 0x85EBCA77u);
  x ^= seed * 0xC2B2AE3Du;
  x ^= b * 0x27D4EB2Fu + h * 0x165667B1u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace rtvc
