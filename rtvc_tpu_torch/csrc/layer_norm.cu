// K2: row LayerNorm.
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
