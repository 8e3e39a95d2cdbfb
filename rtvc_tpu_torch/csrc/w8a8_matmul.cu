// K7: W8A8 GEMM, int8 x int8 -> int32 on the tensor cores.
//
// Replaces the Pallas kernel rtvc_tpu/ops/int8_gemm.py w8a8_matmul (kernel
// bodies _w8a8_kernel / _w8a8_kernel_nobias):
//   out[M, N] = float(xq[M, K] . wq[K, N]) * sx[M] * sw[N] + bias[N],
// xq and wq int8, the sum exact in int32, sx, sw and bias float32, out
// float32 or bfloat16. It runs every Linear of the quantized teacher:
// CLIP's 1024->3072/1024/4096 and 4096->1024 at M = B*6*257, the joint
// layers' 768->2304/768/3072 and 3072->768, and the vocab 768->30522 at
// M = B*40 or the beam's few decode rows.
//
// What bounds it on an H100: int8 tensor-core throughput at the large M,
// the bytes of wq at the decode rows. This first version is the plain
// tiled design: a 128 x 128 output tile per block of 8 warps (2 x 4, each
// warp 64 x 32 of the tile as 4 x 4 mma.sync.m16n8k32 tiles with 64 int32
// accumulators a thread), K in 64-byte steps, two shared-memory stages
// filled by cp.async while the other is multiplied. The mma's A operand is
// row-major and its B operand column-major: both want K contiguous, and
// ldmatrix cannot transpose 8-bit tiles, so wq is read as the [N, K]
// int8 pack that quantize_teacher_ makes once (the Linear weight's own
// layout), never transposed per call. Shared rows are padded from 64 to 80
// bytes, which spreads the 8 rows x 4 words of a fragment load over all 32
// banks. Ragged M and N (N = 30522 is no tile multiple) are zero-filled by
// cp.async's source size and masked in the epilogue, which computes
// ((acc * sx) * sw) + bias in float32 with the rounding of the plain
// version (no fused multiply-add).

#include "common.cuh"

namespace rtvc {
namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;        // bytes of K per stage
constexpr int kLd = kBK + 16;  // padded shared row, bytes
constexpr int kThreads = 256;
constexpr int kStageBytes = (kBM + kBN) * kLd;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// one stage: rows [r0, r0 + 128) of a [rows, K] int8 matrix, K bytes
// [k0, k0 + 64), rows past `rows` and bytes past K zero-filled
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* src,
                                          int rows, int K, int r0, int k0) {
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int c = threadIdx.x + it * kThreads;  // 512 chunks of 16 bytes
    const int r = c >> 2, col = (c & 3) * 16;
    const bool ok = r0 + r < rows && k0 + col < K;
    const int8_t* g = ok ? src + (size_t)(r0 + r) * K + k0 + col : src;
    cp_async16(dst + r * kLd + col, g, ok);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
w8a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
            const int8_t* __restrict__ wq, const float* __restrict__ sw,
            const float* __restrict__ bias, T* __restrict__ out, int M,
            int N, int K) {
  extern __shared__ __align__(16) int8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    }
  }

  const int tiles = (K + kBK - 1) / kBK;
  load_tile(smem, xq, M, K, m0, 0);
  load_tile(smem + kBM * kLd, wq, N, K, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < tiles; ++kt) {
    if (kt + 1 < tiles) {
      int8_t* next = smem + ((kt + 1) & 1) * kStageBytes;
      load_tile(next, xq, M, K, m0, (kt + 1) * kBK);
      load_tile(next + kBM * kLd, wq, N, K, n0, (kt + 1) * kBK);
    }
    cp_async_commit();
    cp_async_wait_one();  // every group but the newest: stage kt is in
    __syncthreads();
    const int8_t* sA = smem + (kt & 1) * kStageBytes;
    const int8_t* sB = sA + kBM * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = sA + (wm + i * 16 + g) * kLd + kk + t * 4;
        af[i][0] = ld32(p);
        af[i][1] = ld32(p + 8 * kLd);
        af[i][2] = ld32(p + 16);
        af[i][3] = ld32(p + 8 * kLd + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = sB + (wn + j * 8 + g) * kLd + kk + t * 4;
        bf[j][0] = ld32(p);
        bf[j][1] = ld32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          asm volatile(
              "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
              : "+r"(acc[i][j][0]), "+r"(acc[i][j][1]), "+r"(acc[i][j][2]),
                "+r"(acc[i][j][3])
              : "r"(af[i][0]), "r"(af[i][1]), "r"(af[i][2]), "r"(af[i][3]),
                "r"(bf[j][0]), "r"(bf[j][1]));
        }
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

  // accumulator e of tile (i, j): row g + 8 * (e >> 1), column 2 t + (e & 1)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int row = m0 + wm + i * 16 + g + 8 * e2;
      if (row >= M) continue;
      const float sxr = sx[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + j * 8 + 2 * t + e;
          if (col >= N) continue;
          float y = __fmul_rn(__fmul_rn((float)acc[i][j][2 * e2 + e], sxr),
                              sw[col]);
          if (bias != nullptr) y = __fadd_rn(y, bias[col]);
          out[(size_t)row * N + col] = from_f<T>(y);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* xq, const void* sx, const void* wq, const void* sw,
           const void* bias, void* out, int M, int N, int K,
           cudaStream_t stream) {
  const int smem = 2 * kStageBytes;
  cudaFuncSetAttribute(w8a8_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  w8a8_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const int8_t*>(wq), static_cast<const float*>(sw),
      static_cast<const float*>(bias), static_cast<T*>(out), M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace rtvc

// xq [M, K] and wq [N, K] int8, both K-contiguous with K % 16 == 0 and
// 16-byte aligned; sx [M], sw [N], bias [N] (or null) float32;
// out [M, N] float32 (dtype 0) or bfloat16 (dtype 1).
extern "C" int rtvc_w8a8_matmul(const void* xq, const void* sx,
                                const void* wq, const void* sw,
                                const void* bias, void* out, int M, int N,
                                int K, int dtype, void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16 != 0 || (M + 127) / 128 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == rtvc::kBFloat16) {
    return rtvc::launch<__nv_bfloat16>(xq, sx, wq, sw, bias, out, M, N, K, s);
  }
  return rtvc::launch<float>(xq, sx, wq, sw, bias, out, M, N, K, s);
}
