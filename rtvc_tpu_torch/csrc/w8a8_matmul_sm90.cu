// K7: W8A8 GEMM, int8 x int8 -> int32 on Hopper's tensor cores (wgmma).
//
// Replaces the Pallas kernel rtvc_tpu/ops/int8_gemm.py w8a8_matmul (kernel
// bodies _w8a8_kernel / _w8a8_kernel_nobias):
//   out[M, N] = ((float(xq[M, K] . wq[K, N]) * sx[M]) * sw[N]) + bias[N],
// xq and wq int8, the sum exact in int32, sx, sw and bias float32, out
// float32 or bfloat16. It runs every Linear of the quantized teacher:
// CLIP's 1024->3072 (qkv), 1024->1024, 1024->4096 (c_fc) and 4096->1024 at
// M = B*6*257, the joint layers' 768->2304/768/3072 and 3072->768, and the
// vocab 768->30522 at M = B*40 or the beam's few decode rows.
//
// What bounds it on an H100: int8 tensor-core operations at the teacher's
// large M. CLIP's qkv at batch 8, [12336, 1024 -> 3072], is 77.6 G
// operations, 39.2 us at 1979 TOP/s, against 91.5 MB of operands and bf16
// output (27.3 us at 3.35 TB/s). The vocab at M = 320 is bound by the 23.4
// MB of wq and 19.5 MB of output (12.97 us). The mma.sync kernel this
// replaces ran at 13.8% of the first bound: a warp's mma.sync cannot reach
// the int8 rate; only wgmma can.
// Design:
// - Block tile 128 x 256 outputs: two consumer warpgroups of 64 rows, each
//   issuing wgmma m64n256k32 s8.s8 -> s32 with both operands K-major in
//   shared memory (8-bit wgmma takes no transpose: xq [M, K] is A, and wq
//   is read as the [N, K] pack quantize_teacher_ makes once, the Linear
//   weight's own layout, never transposed per call). 128 int32
//   accumulators a thread: one block per SM.
// - One producer warp keeps a 4-deep ring of K slices in flight: each
//   stage holds 128 bytes of K of the A tile (128 rows) and of the B tile
//   (256 rows), 48 KB, loaded by TMA through 2-d uint8 tensor maps with
//   the 128-byte swizzle, the row geometry of K4's bf16 64 x 64 tiles, so
//   sw128_desc and tile_descs<2> of flash_attention_sm90.cuh give the
//   descriptors (a k32 step is 32 B). TMA zero-fills rows past M and N
//   (N = 30522 is no tile multiple) and bytes past K (K = 16, 144): zeros
//   add nothing to an integer sum.
// - Full/empty mbarriers per stage. A consumer issues a stage's four
//   products, commits them and waits only for the previous stage's group
//   (wgmma.wait_group 1), then frees that stage: one product group is
//   always in flight, and nothing but wgmma touches the accumulators in
//   the main loop, so ptxas keeps the products asynchronous.
// - Persistent blocks, one per SM, walk the output tiles; the producer
//   runs on into the next tile's slices during a tile's epilogue. On an
//   H100 the main loop alone took 49 us at CLIP's qkv, the epilogue as a
//   second pass from registers 67 us more, half of it the scattered 4-byte
//   stores of the accumulator fragment (PERF.md section 6).
// - Epilogue: ((acc * sx) * sw) + bias in float32 with __fmul_rn /
//   __fadd_rn (no fused multiply-add), the plain version's rounding order,
//   so the result is bit-exact against it; sx, sw and bias of the tile are
//   read during its main loop and kept in shared memory. Each warp writes
//   its 16 rows in 128-byte row pieces through 2 KB of shared memory
//   (16-byte pieces XOR-swizzled by row: no bank conflicts), then stores
//   whole rows: 16-byte stores where a row of out is a 16-byte multiple, a
//   warp per row in 4-byte words elsewhere (the vocab's N = 30522), rows
//   and columns past M and N masked.
// Not done: a TMA store, clusters sharing B tiles by multicast, an
// epilogue overlapping the next tile's products (PERF.md section 7).

#include <algorithm>

#include "common.cuh"
#include "flash_attention_sm90.cuh"  // mbarriers, encode_tiled, descriptors
#include "window_attention_sm90.cuh"  // device_sm_count

namespace rtvc {
namespace {

constexpr int kBM = 128;  // rows per block: two consumer warpgroups of 64
constexpr int kBN = 256;  // columns per block
constexpr int kBK = 128;  // bytes (int8 values) of K per stage
constexpr int kStages = 4;
constexpr int kThreads = 288;  // two consumer warpgroups + a producer warp
constexpr uint32_t kTileA = kBM * kBK;
constexpr uint32_t kTileB = kBN * kBK;
constexpr uint32_t kStage = kTileA + kTileB;
constexpr int kAcc = kBN / 2;  // int32 accumulators a consumer thread

// 2-d TMA load of one box into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wait until at most the newest committed product group is in flight
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

__device__ __forceinline__ void fence_acc(int (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define RTVC_R4(d, i) \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define RTVC_R16(d, i) \
  RTVC_R4(d, i), RTVC_R4(d, i + 4), RTVC_R4(d, i + 8), RTVC_R4(d, i + 12)
#define RTVC_R64(d, i) \
  RTVC_R16(d, i), RTVC_R16(d, i + 16), RTVC_R16(d, i + 32), RTVC_R16(d, i + 48)

#define RTVC_S64                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63"
#define RTVC_S128_TAIL                                                      \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "  \
  "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "  \
  "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "  \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, " \
  "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"

// d += A B, m64 n256 k32, s8 x s8 -> s32, A and B K-major in shared
// memory (scale-d set: the accumulators start at zero)
__device__ __forceinline__ void wgmma_s8(int (&d)[kAcc], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{" RTVC_S64 ", " RTVC_S128_TAIL "}, %128, %129, p;\n}\n"
      : RTVC_R64(d, 0), RTVC_R64(d, 64)
      : "l"(da), "l"(db), "r"(1));
}

struct Args {
  const float* sx;
  const float* sw;
  const float* bias;  // or null
  void* out;
  int M, N, K;
};

constexpr int kStaging = 2048;  // bytes of shared memory a consumer warp

// byte `byte` of row `row` in a warp's staging rows of 128 bytes, whose
// 16-byte pieces are XOR-swizzled by row: the eight rows a store of the
// accumulator fragment touches land on distinct banks
__device__ __forceinline__ int swizzled(int row, int byte) {
  return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

template <typename T>
__device__ __forceinline__ void put_pair(uint8_t* dst, float y0, float y1) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(y0, y1);
  }
}

// the 256 consumer threads meet here (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Persistent: each block walks the output tiles blockIdx.x, blockIdx.x +
// gridDim.x, ... (M tiles fastest, so the blocks in flight share B tiles).
// The producer runs on into the next tile's K slices while the consumers
// do a tile's epilogue.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    w8a8_sm90_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  // the epilogue's sw, bias and sx of a tile, by the parity of its turn
  __shared__ float ep[2][2 * kBN + kBM];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t staging = base + kStages * kStage;  // kStaging a warp
  const uint32_t full0 = staging + 8 * kStaging;      // then empty[]
  const uint32_t empty0 = full0 + 8 * kStages;
  const int mt = (a.M + kBM - 1) / kBM;
  const int ntiles = mt * ((a.N + kBN - 1) / kBN);
  const int ktiles = (a.K + kBK - 1) / kBK;
  // warp-uniform to ptxas (see flash_attention_sm90.cu)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    // ---- producer: the ring of K slices, across the block's tiles ----
    if (lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int m0 = (tile % mt) * kBM, n0 = (tile / mt) * kBN;
        for (int t = 0; t < ktiles; ++t, ++it) {
          const int s = it % kStages;
          const uint32_t st = base + s * kStage;
          mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(full0 + 8 * s, kStage);
          tma_load_2d(st, &ta, full0 + 8 * s, t * kBK, m0);
          tma_load_2d(st + kTileA, &tb, full0 + 8 * s, t * kBK, n0);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: rows m0 + 64 wg + [0, 64) of each tile ----
  const int wg = warp / 4;
  const int ct = threadIdx.x;  // 0 .. 255
  T* out = static_cast<T*>(a.out);
  constexpr int kChunkCols = 128 / sizeof(T);
  const bool vec16 = (a.N * (int)sizeof(T)) % 16 == 0;
  uint8_t* stg = smem_raw + (staging - smem_u32(smem_raw)) + warp * kStaging;
  int it = 0, turn = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++turn) {
    const int m0 = (tile % mt) * kBM, n0 = (tile / mt) * kBN;
    // this tile's scales and bias: read now, kept in shared memory after
    // the products (their latency hides under the main loop)
    float psw = 0.f, pb = 0.f, psx = 0.f;
    if (ct < kBN && n0 + ct < a.N) {
      psw = a.sw[n0 + ct];
      if (a.bias != nullptr) pb = a.bias[n0 + ct];
    }
    if (ct < kBM && m0 + ct < a.M) psx = a.sx[m0 + ct];

    int acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0;
    for (int t = 0; t < ktiles; ++t, ++it) {
      const int s = it % kStages;
      const uint32_t st = base + s * kStage;
      mbar_wait(full0 + 8 * s, (it / kStages) & 1);
      uint64_t da[4], db[4];
      tile_descs<2>(da, st + wg * 64 * kBK);
      tile_descs<2>(db, st + kTileA);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_s8(acc, da[kk], db[kk]);
      wgmma_commit();
      wgmma_wait_one();
      fence_acc(acc);
      // the previous slice's products are done: hand its stage back
      if (t > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % kStages));
    }
    wgmma_wait();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % kStages));

    // two buffers: a consumer that writes this tile's while another still
    // reads the last tile's touches the other one
    float* e = ep[turn & 1];
    if (ct < kBN) {
      e[ct] = psw;
      e[kBN + ct] = pb;
    }
    if (ct < kBM) e[2 * kBN + ct] = psx;
    consumers_sync();

    // The warp's 16 rows go out in chunks of 128-byte row pieces (64 bf16
    // or 32 float32 columns) through its own 2 KB of shared memory, so
    // each global store instruction writes whole rows: accumulator
    // 4 j + 2 k + c is row lane / 4 + 8 k of the warp's 16, column
    // 8 j + 2 (lane % 4) + c of the tile.
    const int r0 = 64 * wg + 16 * (warp % 4);
    const float sx0 = e[2 * kBN + r0 + lane / 4];
    const float sx1 = e[2 * kBN + r0 + lane / 4 + 8];
#pragma unroll
    for (int ch = 0; ch < kBN / kChunkCols; ++ch) {
#pragma unroll
      for (int jj = 0; jj < kChunkCols / 8; ++jj) {
        const int j = ch * (kChunkCols / 8) + jj;
        const int cl = 8 * j + 2 * (lane % 4);
        const float2 w = *reinterpret_cast<const float2*>(e + cl);
        const float2 b = *reinterpret_cast<const float2*>(e + kBN + cl);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float sxr = k ? sx1 : sx0;
          float y0 = __fmul_rn(__fmul_rn((float)acc[4 * j + 2 * k], sxr), w.x);
          float y1 =
              __fmul_rn(__fmul_rn((float)acc[4 * j + 2 * k + 1], sxr), w.y);
          if (a.bias != nullptr) {
            y0 = __fadd_rn(y0, b.x);
            y1 = __fadd_rn(y1, b.y);
          }
          const int row = lane / 4 + 8 * k;
          const int byte = (8 * jj + 2 * (lane % 4)) * (int)sizeof(T);
          put_pair<T>(stg + swizzled(row, byte), y0, y1);
        }
      }
      __syncwarp();
      const int c0 = n0 + ch * kChunkCols;
      if (vec16) {
        // 16 rows x 8 pieces of 16 bytes: a quarter warp per row
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int row = 4 * p + lane / 8, piece = lane % 8;
          const int grow = m0 + r0 + row;
          const int gcol = c0 + piece * (16 / (int)sizeof(T));
          const uint4 v = *reinterpret_cast<const uint4*>(
              stg + swizzled(row, 16 * piece));
          if (grow < a.M && gcol < a.N)
            *reinterpret_cast<uint4*>(out + (size_t)grow * a.N + gcol) = v;
        }
      } else {
        // rows of out that are no 16-byte multiple (the vocab's N = 30522):
        // a warp per row, 4 bytes a lane, halves where N is odd
        constexpr int kPer = 4 / sizeof(T);  // columns a word
#pragma unroll 4
        for (int row = 0; row < 16; ++row) {
          const int grow = m0 + r0 + row;
          const int gcol = c0 + kPer * lane;
          const uint32_t v =
              *reinterpret_cast<const uint32_t*>(stg + swizzled(row, 4 * lane));
          if (grow >= a.M || gcol >= a.N) continue;
          T* dst = out + (size_t)grow * a.N + gcol;
          if (a.N % 2 == 0 || kPer == 1) {
            *reinterpret_cast<uint32_t*>(dst) = v;
          } else {
            reinterpret_cast<uint16_t*>(dst)[0] = (uint16_t)v;
            if (gcol + 1 < a.N)
              reinterpret_cast<uint16_t*>(dst)[1] = (uint16_t)(v >> 16);
          }
        }
      }
      __syncwarp();
    }
  }
}

// A 2-d map over a [rows, K] int8 matrix (K contiguous), boxes of `box`
// rows x 128 bytes, 128-byte swizzle, zero fill out of bounds
bool make_map_2d(CUtensorMap* map, const void* ptr, int rows, int K,
                 int box) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t boxes[2] = {(cuuint32_t)kBK, (cuuint32_t)box};
  const cuuint32_t unit[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<void*>(ptr), dims, strides, boxes, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch(const CUtensorMap& ta, const CUtensorMap& tb, const Args& a,
           cudaStream_t stream) {
  const int smem = kStages * kStage + 8 * kStaging + 16 * kStages + 1024;
  auto kernel = w8a8_sm90_kernel<T>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const long long tiles =
      (long long)((a.M + kBM - 1) / kBM) * ((a.N + kBN - 1) / kBN);
  const int grid = (int)std::min<long long>(tiles, device_sm_count());
  kernel<<<grid, kThreads, smem, stream>>>(ta, tb, a);
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
  if (M < 1 || N < 1 || K < 16 || K % 16 != 0 ||
      (long long)((M + 127) / 128) * ((N + rtvc::kBN - 1) / rtvc::kBN) >
          0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (rtvc::encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap ta, tb;
  if (!rtvc::make_map_2d(&ta, xq, M, K, rtvc::kBM) ||
      !rtvc::make_map_2d(&tb, wq, N, K, rtvc::kBN)) {
    return (int)cudaErrorInvalidValue;
  }
  const rtvc::Args a{static_cast<const float*>(sx),
                     static_cast<const float*>(sw),
                     static_cast<const float*>(bias), out, M, N, K};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == rtvc::kBFloat16) {
    return rtvc::launch<__nv_bfloat16>(ta, tb, a, s);
  }
  return rtvc::launch<float>(ta, tb, a, s);
}
