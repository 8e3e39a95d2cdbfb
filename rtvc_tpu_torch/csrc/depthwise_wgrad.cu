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
// per tap). At stage 0 in bf16 that is 231 MB, 69.0 us at 3.35 TB/s; its
// 1.04 G multiply-adds take 15.5 us on the float32 units.
// Design:
// - Many blocks. A block takes one image n and a group of g consecutive
//   channels: for one n that is one contiguous [g, H, W] slab of x and of
//   dy. g is a power of two, at least the smallest that makes the slab a
//   multiple of 16 bytes (a 7 x 7 or 14 x 14 bf16 plane is not: 98 B,
//   392 B), grown while a channel's W columns still fill its share of the
//   256 threads and both slabs fit 48 KB (g = 2, 8, 16, 32 for the four
//   bf16 shapes: 9216, 1152, 1152 and 864 blocks).
// - Both slabs are copied into shared memory as they lie, in 16-byte
//   vector loads, several in flight a thread (element by element where a
//   slab is unaligned: C not a multiple of g, odd planes).
// - Each thread then walks one column of a channel down a strip of rows,
//   holding three rows of three x values in registers (the zero halo as
//   selects, not a padded copy), so a position costs four shared-memory
//   reads (three x, one dy) for its nine multiply-adds. Neighbouring
//   threads take neighbouring columns: no bank conflicts.
// - Deterministic: the threads of a channel sum their nine partial sums in
//   a fixed order (warp shuffles, then shared memory), and a block writes
//   them to a float32 scratch [N, C, 9] (663 KB at stage 0, allocated by
//   the wrapper); a second small kernel sums it over n in order. No float
//   atomics, so every run gives the same bits.

#include "common.cuh"

namespace rtvc {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlabBytes = 48 * 1024;  // both slabs, where g can grow
constexpr int kMaxSmem = 200 * 1024;   // both slabs at g = 1, at most
constexpr int kUnroll = 4;             // vector loads in flight a thread

// x[h][w - 1 .. w + 1] of one channel's plane, zero outside it
template <typename T>
__device__ __forceinline__ void row3(const T* px, int h, int w, int H, int W,
                                     float (&r)[3]) {
  if (h < 0 || h >= H) {
    r[0] = r[1] = r[2] = 0.f;
    return;
  }
  const T* p = px + h * W + w;
  const bool left = w > 0, right = w + 1 < W;
  const float a = to_f(p[left ? -1 : 0]), c = to_f(p[right ? 1 : 0]);
  r[0] = left ? a : 0.f;
  r[1] = to_f(p[0]);
  r[2] = right ? c : 0.f;
}

// one block per (channel group, image): the nine sums of each of its
// channels over this image, into part[n, c, 9]
template <typename T>
__global__ void __launch_bounds__(kThreads) dw3x3_partial_kernel(
    const T* __restrict__ x, const T* __restrict__ dy,
    float* __restrict__ part, int C, int H, int W, int lg) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float red[kWarps][9];
  const int hw = H * W;
  const int g = 1 << lg;
  const int n = blockIdx.y;
  const int c0 = blockIdx.x * g;
  const int gc = min(g, C - c0);  // channels of this group
  const int len = gc * hw;        // elements of each slab
  const size_t start = ((size_t)n * C + c0) * hw;
  T* sx = reinterpret_cast<T*>(smem);
  T* sdy = sx + (size_t)g * hw;  // 16-byte aligned: g * hw * sizeof(T)
  const T* gx = x + start;
  const T* gd = dy + start;

  // ---- copy both slabs as they lie ----
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = ((reinterpret_cast<uintptr_t>(gx) |
                     reinterpret_cast<uintptr_t>(gd)) & 15) == 0 &&
                   len % kVec == 0;
  if (vec) {
    const int nv = len / kVec;
    const uint4* vx = reinterpret_cast<const uint4*>(gx);
    const uint4* vd = reinterpret_cast<const uint4*>(gd);
    uint4* tx = reinterpret_cast<uint4*>(sx);
    uint4* td = reinterpret_cast<uint4*>(sdy);
    for (int i0 = threadIdx.x; i0 < nv; i0 += kUnroll * kThreads) {
      uint4 a[kUnroll], b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        if (i < nv) {
          a[u] = __ldg(vx + i);
          b[u] = __ldg(vd + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        if (i < nv) {
          tx[i] = a[u];
          td[i] = b[u];
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < len; i += kThreads) {
      sx[i] = gx[i];
      sdy[i] = gd[i];
    }
  }
  __syncthreads();

  // ---- a channel's threads walk its columns down strips of rows ----
  const int tpc = kThreads >> lg;  // threads per channel
  const int cl = threadIdx.x / tpc;
  float acc[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) acc[t] = 0.f;
  if (cl < gc) {
    const T* px = sx + cl * hw;
    const T* pd = sdy + cl * hw;
    const int strips = max(1, tpc / W);
    const int rows = (H + strips - 1) / strips;
    for (int item = threadIdx.x % tpc; item < W * strips; item += tpc) {
      const int s = item / W, w = item - s * W;
      const int h0 = s * rows, h1 = min(H, h0 + rows);
      float up[3], mid[3], dn[3];
      row3(px, h0 - 1, w, H, W, up);
      row3(px, h0, w, H, W, mid);
      for (int h = h0; h < h1; ++h) {
        row3(px, h + 1, w, H, W, dn);
        const float gv = to_f(pd[h * W + w]);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          acc[j] = fmaf(up[j], gv, acc[j]);
          acc[3 + j] = fmaf(mid[j], gv, acc[3 + j]);
          acc[6 + j] = fmaf(dn[j], gv, acc[6 + j]);
          up[j] = mid[j];
          mid[j] = dn[j];
        }
      }
    }
  }

  // ---- fixed-order sums over a channel's threads ----
  const int span = min(tpc, 32);
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    for (int o = span / 2; o > 0; o >>= 1)
      acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], o);
  }
  float* dst = part + ((size_t)n * C + c0) * 9;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (tpc <= 32) {
    if (threadIdx.x % tpc == 0 && cl < gc) {
#pragma unroll
      for (int t = 0; t < 9; ++t) dst[cl * 9 + t] = acc[t];
    }
    return;
  }
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < 9; ++t) red[warp][t] = acc[t];
  }
  __syncthreads();
  const int wpc = tpc / 32;  // warps per channel
  if (threadIdx.x < gc * 9) {
    const int c = threadIdx.x / 9, t = threadIdx.x - c * 9;
    float s = 0.f;
    for (int k = 0; k < wpc; ++k) s += red[c * wpc + k][t];
    dst[c * 9 + t] = s;
  }
}

// out[c, t] = sum over n = 0 .. N - 1, in order, of part[n, c, t]
__global__ void __launch_bounds__(kThreads) dw3x3_sum_kernel(
    const float* __restrict__ part, float* __restrict__ out, int N, int C9) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= C9) return;
  float s = 0.f;
  for (int n = 0; n < N; ++n) s += part[(size_t)n * C9 + i];
  out[i] = s;
}

// log2 of the channel group size g for planes of H x W elements of
// `bytes` bytes each (see the note at the top). A plane so large that the
// smallest aligned group does not fit keeps its smaller group, copied
// element by element.
int group_log2(int C, int H, int W, int bytes) {
  const long long plane = (long long)H * W * bytes;
  int lg = 0;
  while ((2 << lg) * W <= kThreads && (2 << lg) * plane * 2 <= kSlabBytes &&
         (1 << lg) < C)
    ++lg;
  int aligned = lg;  // the slab a multiple of 16 bytes
  while (((plane << aligned) & 15) != 0) ++aligned;
  return (2 * plane << aligned) <= kMaxSmem ? aligned : lg;
}

template <typename T>
int launch(const void* x, const void* dy, void* part, void* out, int N,
           int C, int H, int W, cudaStream_t stream) {
  const int lg = group_log2(C, H, W, sizeof(T));
  const long long smem = (2LL * H * W * (long long)sizeof(T)) << lg;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      dw3x3_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((C + (1 << lg) - 1) >> lg, N);
  dw3x3_partial_kernel<T><<<grid, kThreads, (int)smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<float*>(part), C, H, W, lg);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  dw3x3_sum_kernel<<<(C * 9 + kThreads - 1) / kThreads, kThreads, 0,
                     stream>>>(static_cast<const float*>(part),
                               static_cast<float*>(out), N, C * 9);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace rtvc

// x, dy [N, C, H, W] contiguous, float32 or bfloat16; part a float32
// scratch of N * C * 9 values; out [C, 9] float32.
extern "C" int rtvc_dw3x3_wgrad(const void* x, const void* dy, void* part,
                                void* out, int N, int C, int H, int W,
                                int dtype, void* stream) {
  if (N < 1 || C < 1 || H < 1 || W < 1 || N > 65535 ||
      (long long)H * W > (1 << 20)) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == rtvc::kBFloat16)
    return rtvc::launch<__nv_bfloat16>(x, dy, part, out, N, C, H, W, s);
  return rtvc::launch<float>(x, dy, part, out, N, C, H, W, s);
}
