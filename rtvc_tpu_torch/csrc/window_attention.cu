// K1: TinyViT window attention with the learned relative-position bias.
//
// Replaces the Pallas kernel rtvc_tpu/ops/attention.py
// _window_attention_fwd_pallas (kernel body _make_window_kernel):
//   out = softmax(q k^T * scale + bias[h]) v   per (window, head),
// q/k/v [B*nW, H, N, D], bias [H, N, N] float32, out in the input dtype.
//
// What bounds it on an H100: at the caption step's shapes (N = 49 or 196,
// D = 32, a few hundred to a few thousand (window, head) pairs) the work is
// small and the kernel is bound by latency and by the N x N score tile that
// a library path writes to and reads back from device memory. This kernel
// keeps the tile on chip: one block per (group of windows, head, chunk of
// query rows) stages the window's K and V in shared memory as float32 (K
// rows padded to D + 1 floats so the 32 lanes reading 32 different keys hit
// 32 banks), each warp takes query rows of the chunk, holds that row's
// scores in registers (one score per lane per 32 keys), runs the softmax
// with a float32 max and sum, and accumulates P.V in float32 registers.
// Only q, k, v, bias and out touch device memory. The query chunks exist
// for parallelism: at N = 196 and batch 1 there are only 72 (window, head)
// pairs, and one block per pair leaves most SMs idle while each warp walks
// 25 rows; chunks of at most 64 rows give 4x the blocks, at the price of
// staging each window's K and V once per chunk (from L2).
//
// The kernel below serves float32 inputs only: the entry point hands
// bfloat16 calls (D = 32) to the tensor-core kernel of
// window_attention_sm90.cu, which computes the same function.
//
// Numerics follow the TPU kernel: with scores_in_input_dtype (the TinyViT
// mode) the scaled score and the bias are rounded to the input dtype and so
// is their sum; the probabilities are rounded to the value dtype before the
// P.V product.

#include "common.cuh"
#include "window_attention_sm90.cuh"

namespace rtvc {
namespace {

constexpr int kMaxKeys = 256;
constexpr int kSlots = kMaxKeys / 32;  // scores held per lane
constexpr int kMaxHeadDim = 64;
constexpr int kCols = kMaxHeadDim / 32;  // output columns per lane
constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ bias, T* __restrict__ out,
                        int B, int H, int N, int D, int windows_per_block,
                        int rows_per_block, float scale,
                        int scores_in_input_dtype) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sK = smem;            // [N][D + 1]
  float* sV = sK + N * ld;     // [N][D]
  float* sQ = sV + N * D;      // [kWarps][D]
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* q_row = sQ + warp * D;
  const float* bias_h = bias + (size_t)h * N * N;
  const int q_begin = blockIdx.z * rows_per_block;
  const int q_end = min(N, q_begin + rows_per_block);

  for (int wi = 0; wi < windows_per_block; ++wi) {
    const int b = blockIdx.x * windows_per_block + wi;
    if (b >= B) break;
    const size_t base = ((size_t)b * H + h) * N * D;
    __syncthreads();  // the previous window's readers are done with sK/sV
    for (int i = threadIdx.x; i < N * D; i += blockDim.x) {
      const int r = i / D;
      sK[r * ld + (i - r * D)] = to_f(k[base + i]);
      sV[i] = to_f(v[base + i]);
    }
    __syncthreads();

    for (int qi = q_begin + warp; qi < q_end; qi += kWarps) {
      for (int c = lane; c < D; c += 32) {
        q_row[c] = to_f(q[base + (size_t)qi * D + c]);
      }
      __syncwarp();

      float s[kSlots];
      float m = -INFINITY;
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        const int j = t * 32 + lane;
        s[t] = -INFINITY;
        if (j < N) {
          const float* kr = sK + j * ld;
          // four independent chains: the dot is latency-bound, not FMA-bound
          float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
          int c = 0;
          for (; c + 4 <= D; c += 4) {
            d0 = fmaf(q_row[c], kr[c], d0);
            d1 = fmaf(q_row[c + 1], kr[c + 1], d1);
            d2 = fmaf(q_row[c + 2], kr[c + 2], d2);
            d3 = fmaf(q_row[c + 3], kr[c + 3], d3);
          }
          for (; c < D; ++c) d0 = fmaf(q_row[c], kr[c], d0);
          const float dot = (d0 + d1) + (d2 + d3);
          float sc = dot * scale;
          const float bj = bias_h[(size_t)qi * N + j];
          if (scores_in_input_dtype) {
            sc = round_to<T>(round_to<T>(sc) + round_to<T>(bj));
          } else {
            sc += bj;
          }
          s[t] = sc;
          m = fmaxf(m, sc);
        }
      }
      m = warp_max(m);
      float l = 0.f;
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        const float e = (t * 32 + lane < N) ? expf(s[t] - m) : 0.f;
        s[t] = e;
        l += e;
      }
      const float inv = 1.f / warp_sum(l);
#pragma unroll
      for (int t = 0; t < kSlots; ++t) s[t] = round_to<T>(s[t] * inv);

      // out[qi, c] = sum_j p_j v[j, c]: lane owns columns lane + 32 u, and
      // p_j is broadcast from the lane that holds it
      float acc[kCols];
#pragma unroll
      for (int u = 0; u < kCols; ++u) acc[u] = 0.f;
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        if (t * 32 < N) {  // uniform across the warp
          for (int src = 0; src < 32; ++src) {
            const float p = __shfl_sync(0xffffffffu, s[t], src);
            const int j = t * 32 + src;
            if (j < N) {
#pragma unroll
              for (int u = 0; u < kCols; ++u) {
                const int c = lane + 32 * u;
                if (c < D) acc[u] = fmaf(p, sV[j * D + c], acc[u]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int c = lane + 32 * u;
        if (c < D) out[base + (size_t)qi * D + c] = from_f<T>(acc[u]);
      }
      __syncwarp();  // q_row is rewritten for the warp's next query
    }
  }
}

// The float32 grid: query chunks of at most 64 rows, then windows grouped
// so that about 16 blocks land on each SM
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, int B, int H, int N, int D, float scale,
           int scores_in_input_dtype, cudaStream_t stream) {
  const int chunks = (N + 63) / 64;
  const int rows_per_block = (N + chunks - 1) / chunks;
  const int windows_per_block = max(
      1, (int)((long long)B * H * chunks / (16 * device_sm_count())));
  const size_t smem = (size_t)(N * (D + 1) + N * D + kWarps * D) *
                      sizeof(float);
  cudaFuncSetAttribute(window_attention_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((B + windows_per_block - 1) / windows_per_block, H,
                  (N + rows_per_block - 1) / rows_per_block);
  window_attention_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(out), B, H, N, D, windows_per_block, rows_per_block,
      scale, scores_in_input_dtype);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace rtvc

extern "C" int rtvc_window_attention(const void* q, const void* k,
                                     const void* v, const void* bias,
                                     void* out, int B, int H, int N, int D,
                                     float scale, int scores_in_input_dtype,
                                     int dtype, void* stream) {
  if (N < 1 || N > rtvc::kMaxKeys || D > rtvc::kMaxHeadDim) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == rtvc::kBFloat16) {
    // the tensor-core kernel, on its own persistent grid
    if (D != 32) return (int)cudaErrorInvalidValue;
    return rtvc::window_attention_sm90(q, k, v, bias, out, B, H, N,
                                       scale, scores_in_input_dtype, s);
  }
  return rtvc::launch<float>(q, k, v, bias, out, B, H, N, D, scale,
                             scores_in_input_dtype, s);
}
