// K3: weight-only int8 GEMV for decode rows (M <= 32).
//
// Replaces the Pallas kernel rtvc_tpu/ops/int8_gemm.py w8_matmul (kernel
// bodies _w8_kernel / _w8_kernel_nobias):
//   out[M, N] = (x[M, K] . float(wq[K, N])) * sw[N] + bias[N],
// x and out float32 or bfloat16, wq int8, sw and bias float32.
//
// What bounds it on an H100: the bytes of wq. At the student's vocab
// projection (K = 576, N = 31744 after padding) one token reads 18.3 MB of
// int8 weight against 36.6 MB for the bfloat16 product, and x is a few KB.
// The design reads each weight byte once and dequantises it in registers:
// the block stages x in shared memory as float32; its 8 warps split K
// (warp w takes rows w, w + 8, ...), and lane l owns 4 adjacent output
// columns, so a warp reads 128 contiguous bytes of a wq row per load. Each
// thread keeps a [MT][4] float32 accumulator (MT = M rounded up to a power
// of two), the 8 partial sums meet in shared memory, and the epilogue
// applies the scale and bias and writes the output dtype. 128 columns per
// block give 248 blocks at the vocab width, enough to spread the weight
// read over all 132 SMs.

#include "common.cuh"

namespace rtvc {
namespace {

constexpr int kWarps = 8;
constexpr int kTileN = 128;  // 32 lanes x 4 columns

template <int MT>
constexpr size_t smem_floats(int K) {
  return (size_t)MT * K > (size_t)kWarps * MT * kTileN
             ? (size_t)MT * K
             : (size_t)kWarps * MT * kTileN;
}

template <typename T, int MT>
__global__ void __launch_bounds__(kWarps * 32)
w8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                 const float* __restrict__ sw,
                 const float* __restrict__ bias, T* __restrict__ out, int M,
                 int K, int N) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float* xs = smem;  // [MT][K]; rows >= M are zero
  for (int i = threadIdx.x; i < MT * K; i += blockDim.x) {
    xs[i] = i < M * K ? to_f(x[i]) : 0.f;
  }
  __syncthreads();

  const int col = blockIdx.x * kTileN + lane * 4;
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;
  }
  if (col < N) {  // N % 4 == 0, so the whole char4 is in range
#pragma unroll 4
    for (int kk = warp; kk < K; kk += kWarps) {
      const char4 w4 =
          *reinterpret_cast<const char4*>(wq + (size_t)kk * N + col);
      const float w0 = w4.x, w1 = w4.y, w2 = w4.z, w3 = w4.w;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = xs[m * K + kk];
        acc[m][0] = fmaf(xv, w0, acc[m][0]);
        acc[m][1] = fmaf(xv, w1, acc[m][1]);
        acc[m][2] = fmaf(xv, w2, acc[m][2]);
        acc[m][3] = fmaf(xv, w3, acc[m][3]);
      }
    }
  }
  __syncthreads();  // xs is dead: reuse the buffer for the partial sums

  float* red = smem;  // [kWarps][MT][kTileN]
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      red[(warp * MT + m) * kTileN + lane * 4 + c] = acc[m][c];
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < M * kTileN; i += blockDim.x) {
    const int m = i / kTileN;
    const int cc = i - m * kTileN;
    const int n = blockIdx.x * kTileN + cc;
    if (n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(w * MT + m) * kTileN + cc];
    float yv = s * sw[n];
    if (bias != nullptr) yv += bias[n];
    out[(size_t)m * N + n] = from_f<T>(yv);
  }
}

template <typename T, int MT>
int launch_mt(const void* x, const void* wq, const void* sw,
              const void* bias, void* out, int M, int K, int N,
              cudaStream_t stream) {
  const size_t smem = smem_floats<MT>(K) * sizeof(float);
  cudaFuncSetAttribute(w8_matmul_kernel<T, MT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int grid = (N + kTileN - 1) / kTileN;
  w8_matmul_kernel<T, MT><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(sw), static_cast<const float*>(bias),
      static_cast<T*>(out), M, K, N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* wq, const void* sw, const void* bias,
           void* out, int M, int K, int N, cudaStream_t s) {
  if (M <= 1) return launch_mt<T, 1>(x, wq, sw, bias, out, M, K, N, s);
  if (M <= 2) return launch_mt<T, 2>(x, wq, sw, bias, out, M, K, N, s);
  if (M <= 4) return launch_mt<T, 4>(x, wq, sw, bias, out, M, K, N, s);
  if (M <= 8) return launch_mt<T, 8>(x, wq, sw, bias, out, M, K, N, s);
  if (M <= 16) return launch_mt<T, 16>(x, wq, sw, bias, out, M, K, N, s);
  return launch_mt<T, 32>(x, wq, sw, bias, out, M, K, N, s);
}

}  // namespace
}  // namespace rtvc

extern "C" int rtvc_w8_matmul(const void* x, const void* wq, const void* sw,
                              const void* bias, void* out, int M, int K,
                              int N, int dtype, void* stream) {
  if (M < 1 || M > 32 || N % 4 != 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == rtvc::kBFloat16) {
    return rtvc::launch<__nv_bfloat16>(x, wq, sw, bias, out, M, K, N, s);
  }
  return rtvc::launch<float>(x, wq, sw, bias, out, M, K, N, s);
}
