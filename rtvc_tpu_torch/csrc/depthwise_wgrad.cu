// K9: the weight gradient of the stride-1, zero-padded depthwise 3x3 conv.
//
// Replaces the Pallas kernel rtvc_tpu/ops/depthwise.py dw3x3_wgrad_pallas
// (_wgrad_kernel):
//   wgrad[c, ki, kj] = sum_{n, h, w} x[n, c, h + ki - 1, w + kj - 1]
//                                    * dy[n, c, h, w]
// over x and dy [N, C, H, W] (the port's TinyViT runs NCHW), float32 or
// bfloat16, written as float32 [C, 9]. It serves the train step's twelve
// stride-1 depthwise convs: MBConv conv2 at [48, 384, 56, 56] and the
// blocks' local_conv at [48, 192, 28, 28], [48, 384, 14, 14] and
// [48, 576, 7, 7].
//
// What bounds it on an H100: reading x and dy once (the TPU kernel's point:
// nine taps from one pass instead of a batch-grouped conv that reads them
// per tap). One block per channel walks that channel's N planes; thread t
// takes the positions t, t + 256, ... of the flattened (n, h, w), so
// neighbouring threads read neighbouring pixels, and keeps the nine float32
// sums in registers. The nine shifted reads of x hit L1 after the first;
// the zero padding is a bounds check, not a padded copy. The block then
// sums its threads' partial sums in a fixed order (warp shuffles, then one
// shared-memory pass), so the result is the same on every run.

#include "common.cuh"

namespace rtvc {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads) dw3x3_wgrad_kernel(
    const T* x, const T* dy, float* out, int N, int C, int H, int W) {
  const int c = blockIdx.x;
  const int hw = H * W;
  const int count = N * hw;
  float acc[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) acc[t] = 0.f;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int n = i / hw;
    const int p = i - n * hw;
    const int h = p / W;
    const int w = p - h * W;
    const size_t plane = ((size_t)n * C + c) * hw;
    const float g = to_f(dy[plane + p]);
#pragma unroll
    for (int ki = 0; ki < 3; ++ki) {
      const int hh = h + ki - 1;
      if (hh < 0 || hh >= H) continue;
#pragma unroll
      for (int kj = 0; kj < 3; ++kj) {
        const int ww = w + kj - 1;
        if (ww >= 0 && ww < W)
          acc[ki * 3 + kj] =
              fmaf(to_f(x[plane + hh * W + ww]), g, acc[ki * 3 + kj]);
      }
    }
  }
  __shared__ float part[9][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const float v = warp_sum(acc[t]);
    if (lane == 0) part[t][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < 9) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += part[threadIdx.x][k];
    out[(size_t)c * 9 + threadIdx.x] = s;
  }
}

template <typename T>
int launch(const void* x, const void* dy, void* out, int N, int C, int H,
           int W, cudaStream_t stream) {
  dw3x3_wgrad_kernel<T><<<C, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<float*>(out), N, C, H, W);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace rtvc

// x, dy [N, C, H, W] contiguous, float32 or bfloat16; out [C, 9] float32.
extern "C" int rtvc_dw3x3_wgrad(const void* x, const void* dy, void* out,
                                int N, int C, int H, int W, int dtype,
                                void* stream) {
  if (N < 1 || C < 1 || H < 1 || W < 1 ||
      (long long)N * H * W > 0x7fffffffLL - rtvc::kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == rtvc::kBFloat16)
    return rtvc::launch<__nv_bfloat16>(x, dy, out, N, C, H, W, s);
  return rtvc::launch<float>(x, dy, out, N, C, H, W, s);
}
