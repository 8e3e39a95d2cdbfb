// K2: row LayerNorm, and K6: residual add + LayerNorm.
//
// Replaces the Pallas kernel rtvc_tpu/ops/layernorm.py _pallas_ln:
//   y = (x - mean) * rsqrt(var + eps) * weight + bias   over the last axis,
// with float32 mean and variance (the variance of the centred row, as the
// TPU kernel takes it) and x, weight, bias and y in one dtype.
//
// What bounds it on an H100: bytes. A row is read three times (sum, centred
// sum of squares, normalise) and written once; at the student's widths
// (576) a row is 1-2 KB and stays in L1 between the passes, so device
// memory sees one read and one write. One warp owns one row and reduces
// with shuffles, so no shared memory and no block barrier are needed; any
// width is masked by the lane loop. At the decode step's [B, 576] the
// kernel is one block and latency-bound.
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

namespace rtvc {
namespace {

constexpr int kRowsPerBlock = 8;

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

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int rows,
           int width, float eps, cudaStream_t stream) {
  const int grid = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  layer_norm_kernel<T><<<grid, kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), rows, width, eps);
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
