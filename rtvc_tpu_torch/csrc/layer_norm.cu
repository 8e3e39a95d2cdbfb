// K2: row LayerNorm, and K6: residual add + LayerNorm.
//
// Replaces the Pallas kernel rtvc_tpu/ops/layernorm.py _pallas_ln:
//   y = (x - mean) * rsqrt(var + eps) * weight + bias   over the last axis,
// with float32 mean and variance (the variance of the centred row, as the
// TPU kernel takes it) and x, weight, bias and y in one dtype.
//
// What bounds it on an H100. At the decode step's [B, 576] (B = 1 or 8) a
// call moves a few KB (0.01 us at 3.35 TB/s): it is latency, one load round
// trip, two shuffle reductions and a store. At TinyViT's and the teacher's
// [rows, 192-1024] it is bytes: one read of x and one write of y (15.08 us
// for the teacher's bf16 [12336, 1024]). Design: the kernel for the widths
// the paths use (192, 384, 576, 768, 1024) reads each row once, into
// registers, with 16-byte loads, and issues the loads of weight and bias
// while those are in flight. The two float32 statistics come from the
// registers as the TPU kernel takes them: the mean, then the sum of squares
// of the centred row (not E[x^2] - mean^2, which loses the variance of rows
// whose mean is large against their spread). A group of G lanes owns a row
// and reduces with shuffles of width G: G = 8 and 16 for the narrow bf16
// rows (192 and 384 elements, 24 and 48 vectors of 16 bytes), so no lane
// idles, and a warp otherwise. Where the grid would leave SMs without a
// block (the decode's [B, 576]), each block is one warp, so the rows spread
// over SMs. Any other width, or an operand that is not 16-byte aligned,
// takes layer_norm_kernel: one warp a row, a lane loop over the columns and
// the same two statistics from three passes over the row.
//
// K6 replaces the Pallas kernel rtvc_tpu/ops/layernorm.py _pallas_add_ln:
//   y = x + d (stored in x's dtype),  h = LayerNorm(x + d)
// where the norm reads the float32 sum, not the rounded y. It serves the
// CLIP tower's ln_2 site, [B*F*257, 1024] bf16, 24 times per forward. Bound
// by bytes as K2 is: it reads x and d and writes y and h, one pass each in
// device memory, where an add followed by K2 would write y, read it back and
// round the norm's input to bf16 first. A warp owns a row; the float32 sum
// goes to shared memory (4 KB a row at width 1024) so the two reduction
// passes and the normalise pass read it from there and never reread x or d.

#include "common.cuh"
#include "window_attention_sm90.cuh"  // device_sm_count

namespace rtvc {
namespace {

constexpr int kRowsPerBlock = 8;

// the generic K2: any width, any alignment
template <typename T>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ b, T* __restrict__ y, int rows,
                  int width, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + (size_t)row * width;
  T* yr = y + (size_t)row * width;
  const float inv_n = 1.f / (float)width;

  float sum = 0.f;
  for (int c = lane; c < width; c += 32) sum += to_f(xr[c]);
  const float mean = warp_sum(sum) * inv_n;
  float sq = 0.f;
  for (int c = lane; c < width; c += 32) {
    const float d = to_f(xr[c]) - mean;
    sq = fmaf(d, d, sq);
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_n + eps);
  for (int c = lane; c < width; c += 32) {
    const float v = (to_f(xr[c]) - mean) * rstd;
    yr[c] = from_f<T>(v * to_f(w[c]) + to_f(b[c]));
  }
}

// 16 bytes of T as float32 values, and back
__device__ __forceinline__ void unpack16(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack16(const uint4& v, float (&f)[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a bf16 is the high half of the float32 of the same value
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
template <typename T>
__device__ __forceinline__ uint4 pack16(const float* f);
template <>
__device__ __forceinline__ uint4 pack16<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
template <>
__device__ __forceinline__ uint4 pack16<__nv_bfloat16>(const float* f) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    u[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// K2 at a width known at compile time: a group of kGroup lanes owns a row,
// lane l of the group its 16-byte vectors l, l + kGroup, ...
template <typename T, int kWidth, int kGroup>
__global__ void __launch_bounds__(256)
layer_norm_vec_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ b, T* __restrict__ y, int rows,
                      float eps) {
  constexpr int kN = 16 / sizeof(T);                   // elements a vector
  constexpr int kVecs = kWidth / kN;                   // vectors a row
  constexpr int kPer = (kVecs + kGroup - 1) / kGroup;  // vectors a lane
  static_assert(kWidth % kN == 0 && 32 % kGroup == 0, "layout");
  const int lane = threadIdx.x % kGroup;
  const int row = blockIdx.x * (blockDim.x / kGroup) + threadIdx.x / kGroup;
  // whole warps past the last row leave; a warp with a live row keeps all
  // its lanes for the shuffles
  if (row - (int)(threadIdx.x & 31) / kGroup >= rows) return;
  const bool live = row < rows;
  auto has = [&](int i) {
    return kVecs % kGroup == 0 || i * kGroup + lane < kVecs;
  };
  const uint4* xr = reinterpret_cast<const uint4*>(x) + (size_t)row * kVecs;
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  const uint4* br = reinterpret_cast<const uint4*>(b);

  uint4 xv[kPer], wv[kPer], bv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    xv[i] = make_uint4(0, 0, 0, 0);
    if (live && has(i)) xv[i] = __ldg(xr + i * kGroup + lane);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (has(i)) {
      wv[i] = __ldg(wr + i * kGroup + lane);
      bv[i] = __ldg(br + i * kGroup + lane);
    }
  }

  float v[kPer][kN];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    unpack16(xv[i], v[i]);
#pragma unroll
    for (int e = 0; e < kN; ++e) sum += v[i][e];  // zero where !has(i)
  }
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
  }
  const float inv_n = 1.f / (float)kWidth;
  const float mean = sum * inv_n;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (has(i)) {
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float d = v[i][e] - mean;
        sq = fmaf(d, d, sq);
      }
    }
  }
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1) {
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
  }
  const float rstd = rsqrtf(sq * inv_n + eps);
  if (!live) return;
  uint4* yr = reinterpret_cast<uint4*>(y) + (size_t)row * kVecs;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (has(i)) {
      float wf[kN], bf[kN], o[kN];
      unpack16(wv[i], wf);
      unpack16(bv[i], bf);
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float t = (v[i][e] - mean) * rstd;
        o[e] = t * wf[e] + bf[e];
      }
      yr[i * kGroup + lane] = pack16<T>(o);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
add_layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ d,
                      const T* __restrict__ w, const T* __restrict__ b,
                      T* __restrict__ y, T* __restrict__ h, int rows,
                      int width, float eps) {
  extern __shared__ float sums[];  // [kRowsPerBlock][width]
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t off = (size_t)row * width;
  float* s = sums + (threadIdx.x >> 5) * width;
  const float inv_n = 1.f / (float)width;

  // each lane reads back only the columns it wrote: no barrier needed
  float sum = 0.f;
  for (int c = lane; c < width; c += 32) {
    const float v = to_f(x[off + c]) + to_f(d[off + c]);
    s[c] = v;
    y[off + c] = from_f<T>(v);
    sum += v;
  }
  const float mean = warp_sum(sum) * inv_n;
  float sq = 0.f;
  for (int c = lane; c < width; c += 32) {
    const float dv = s[c] - mean;
    sq = fmaf(dv, dv, sq);
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_n + eps);
  for (int c = lane; c < width; c += 32) {
    const float v = (s[c] - mean) * rstd;
    h[off + c] = from_f<T>(v * to_f(w[c]) + to_f(b[c]));
  }
}

template <typename T>
int launch_add(const void* x, const void* d, const void* w, const void* b,
               void* y, void* h, int rows, int width, float eps,
               cudaStream_t stream) {
  const size_t smem = (size_t)kRowsPerBlock * width * sizeof(float);
  cudaFuncSetAttribute(add_layer_norm_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int grid = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  add_layer_norm_kernel<T><<<grid, kRowsPerBlock * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(d),
      static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(y),
      static_cast<T*>(h), rows, width, eps);
  return (int)cudaGetLastError();
}

template <typename T, int kWidth, int kGroup>
int launch_vec(const T* x, const T* w, const T* b, T* y, int rows, float eps,
               cudaStream_t stream) {
  constexpr int kRows = 256 / kGroup;  // rows of a 256-thread block
  int threads = 256, per_block = kRows;
  if ((rows + kRows - 1) / kRows < device_sm_count()) {
    threads = 32;  // too few blocks to fill the card: a warp a block
    per_block = 32 / kGroup;
  }
  const int grid = (rows + per_block - 1) / per_block;
  layer_norm_vec_kernel<T, kWidth, kGroup><<<grid, threads, 0, stream>>>(
      x, w, b, y, rows, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* xp, const void* wp, const void* bp, void* yp,
           int rows, int width, float eps, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xp);
  const T* w = static_cast<const T*>(wp);
  const T* b = static_cast<const T*>(bp);
  T* y = static_cast<T*>(yp);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  // lanes a row: each lane holds 3 vectors where that fills a warp's
  // groups exactly (bf16 192, 384, 768; f32 192, 384), else a warp
  constexpr bool kBf16 = sizeof(T) == 2;
  if (aligned) {
    switch (width) {
      case 192:
        return launch_vec<T, 192, kBf16 ? 8 : 16>(x, w, b, y, rows, eps,
                                                  stream);
      case 384:
        return launch_vec<T, 384, kBf16 ? 16 : 32>(x, w, b, y, rows, eps,
                                                   stream);
      case 576:
        return launch_vec<T, 576, 32>(x, w, b, y, rows, eps, stream);
      case 768:
        return launch_vec<T, 768, 32>(x, w, b, y, rows, eps, stream);
      case 1024:
        return launch_vec<T, 1024, 32>(x, w, b, y, rows, eps, stream);
      default:
        break;
    }
  }
  const int grid = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  layer_norm_kernel<T><<<grid, kRowsPerBlock * 32, 0, stream>>>(
      x, w, b, y, rows, width, eps);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace rtvc

extern "C" int rtvc_layer_norm(const void* x, const void* w, const void* b,
                               void* y, int rows, int width, float eps,
                               int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == rtvc::kBFloat16) {
    return rtvc::launch<__nv_bfloat16>(x, w, b, y, rows, width, eps, s);
  }
  return rtvc::launch<float>(x, w, b, y, rows, width, eps, s);
}

extern "C" int rtvc_add_layer_norm(const void* x, const void* d,
                                   const void* w, const void* b, void* y,
                                   void* h, int rows, int width, float eps,
                                   int dtype, void* stream) {
  // the float32 rows of a block must fit in shared memory
  if ((size_t)rtvc::kRowsPerBlock * width * sizeof(float) > 200 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == rtvc::kBFloat16) {
    return rtvc::launch_add<__nv_bfloat16>(x, d, w, b, y, h, rows, width,
                                           eps, s);
  }
  return rtvc::launch_add<float>(x, d, w, b, y, h, rows, width, eps, s);
}
