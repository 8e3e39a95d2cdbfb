// K3: weight-only int8 GEMV for decode rows (M <= 32).
//
// Replaces the Pallas kernel rtvc_tpu/ops/int8_gemm.py w8_matmul (kernel
// bodies _w8_kernel / _w8_kernel_nobias):
//   out[M, N] = (x[M, K] . float(wq[K, N])) * sw[N] + bias[N],
// x and out float32 or bfloat16, wq int8, sw and bias float32. The kernel
// reads wq K-contiguous, from its [N, K] pack (quantization.
// quantize_vocab_head makes it once; the wrapper hands the kernel the pack
// behind the [K, N] view).
//
// What bounds it on an H100: the bytes of the pack. At the student's vocab
// projection (K = 576, N = 31744 after padding) one token reads 18.3 MB of
// int8 weight, and x and out are a few KB: 5.69 us at 3.35 TB/s for 8 rows.
// Design: stream the weight at the card's bandwidth, give every SM the same
// share of it and hide the products under the stream:
// - one persistent block of 16 warps per SM; a warp owns a tile of 16 pack
//   rows (output columns), tile t going to block t mod grid, so the SMs'
//   shares differ by at most one tile (15 or 16 of the vocab's 1984);
// - a warp's tile (16 rows x up to 576 k: 9 KB, contiguous in the pack)
//   comes as a bulk copy into the warp's own shared memory, completing on
//   the warp's own mbarrier. One thread issues the first kAhead warps'
//   copies before anything waits (before x is staged and before the
//   block's one barrier); each warp, once its tile has landed, issues the
//   copy of the warp kAhead after it. So a block keeps 54 KB in flight,
//   about what the card's bandwidth needs at its latency, and the tiles
//   land in turn while the stream runs: the products of the early warps
//   hide under the later warps' copies. (With every copy issued at once,
//   all tiles land at the end of the stream and the products trail it.)
// - bfloat16 x: the product runs on the tensor cores, mma.sync m16n8k16
//   (bf16 in, f32 sums) with the weight as operand A (16 columns x 16 k)
//   and x^T as operand B (16 k x 8 rows; M <= 8 fills one n-tile, M <= 32
//   four). A lane reads 16 bytes of one pack row, its A fragments for four
//   k-steps: the k order is permuted the same way in A and B, which leaves
//   the sum unchanged. Int8 -> bf16 is exact (|q| <= 127 fits bf16's
//   significand): the low 7 bits of q go into the mantissa of the bf16
//   128, and a bf16 add of -128 (-256 where q's sign bit is set) leaves q,
//   four instructions per two weights. The products are exact and the
//   sums float32, as the FMA path computes them, up to the order of the
//   sums;
// - float32 x (up to 8 rows a launch): the same copies and tiles, the
//   products as float32 FMAs on the CUDA cores (rounding x to bf16 would
//   change the function); 8 lanes split k and each holds 4 pack rows, so
//   one shared-memory load of x feeds 16 FMAs a row of x, and the 8 lanes'
//   sums meet by shuffles.
// The epilogue applies sw, then the bias, each rounded as the plain version
// rounds them, and writes the output dtype. What is left above the byte
// bound (python -m rtvc_tpu_torch.profile_w8 cuts the kernel apart): the
// launch, barriers, staging of x and epilogue, and the products of the
// tiles that land last.

#include "common.cuh"
#include "flash_attention_sm90.cuh"   // mbarriers
#include "window_attention_sm90.cuh"  // device_sm_count

namespace rtvc {
namespace {

constexpr int kWarps = 16;    // one block a SM
constexpr int kChunkK = 64;   // k of one mma chunk: 4 lanes x 16 bytes
constexpr int kGroupK = 576;  // k a warp copies at once: 9 KB a tile
constexpr int kTileN = 16;    // pack rows (output columns) a warp tile
constexpr int kAhead = 6;     // warps' tile copies a block keeps in flight

// 1-d bulk copy of `bytes` (a multiple of 16) into shared memory,
// completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One thread: copy k in [k0, k0 + kg) of the tile's pack rows below N into
// `buf` [16][kg] (bytes), completing on `bar`: one copy where the rows are
// whole (kg = K, contiguous in the pack), else one a row.
__device__ __forceinline__ void copy_tile(int8_t* buf, uint32_t bar,
                                          const int8_t* __restrict__ pack,
                                          int tile, int k0, int kg, int N,
                                          int K) {
  const int n0 = tile * kTileN;
  const int rows = N - n0 < kTileN ? N - n0 : kTileN;
  mbar_expect_tx(bar, (uint32_t)(rows * kg));
  if (kg == K) {
    bulk_copy(buf, pack + (size_t)n0 * K, (uint32_t)(rows * K), bar);
  } else {
    for (int r = 0; r < rows; ++r) {
      bulk_copy(buf + r * kg, pack + (size_t)(n0 + r) * K + k0, (uint32_t)kg,
                bar);
    }
  }
}

// int8 x 2 -> bf16 x 2: `t` holds the two bytes in the low halves' low
// bytes and 0x43 above each (bf16 0x43nn = 128 + the byte's low 7 bits,
// its bit 7 landing in the exponent's lowest bit); q = that - 128, or
// - 256 where bit 7 (q's sign) is set; the add is exact
__device__ __forceinline__ uint32_t i8x2_to_bf16(uint32_t t) {
  const uint32_t v = t & 0xff7fff7fu;                // 128 + (q & 127)
  const uint32_t o = (t & 0x00800080u) | 0xc300c300u;  // -128 or -256
  uint32_t q;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(q) : "r"(v), "r"(o));
  return q;
}

// int8 x 4 (bytes q0..q3 of `w`) -> (bf16x2 {q0, q1}, bf16x2 {q2, q3})
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  lo = i8x2_to_bf16(__byte_perm(w, 0x4343u, 0x5150));
  hi = i8x2_to_bf16(__byte_perm(w, 0x4343u, 0x5352));
}

__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + j))
           - 8388736.f;
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float epilogue(float acc, const float* sw,
                                          const float* bias, int n) {
  const float y = __fmul_rn(acc, __ldg(sw + n));
  return bias != nullptr ? __fadd_rn(y, __ldg(bias + n)) : y;
}

// Stage x [M, K] (row stride ldx) in shared memory as T, rows
// [rows_s][pitch] with pitch the chunks' k plus 16 bytes (the rows 4 banks
// apart), zero past M and K. K % 16 == 0: every row is whole 16-byte
// vectors.
template <typename T>
__device__ __forceinline__ void stage_x(const T* __restrict__ x, int ldx,
                                        T* xs, int M, int K, int rows_s,
                                        int pitch) {
  constexpr int kE = 16 / sizeof(T);
  const int vecs = pitch / kE - 1;  // the chunks' vectors a row
  for (int i = threadIdx.x; i < rows_s * vecs; i += blockDim.x) {
    const int r = i / vecs, k = (i - r * vecs) * kE;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < M && k < K) {
      v = __ldg(reinterpret_cast<const uint4*>(x + (size_t)r * ldx + k));
    }
    *reinterpret_cast<uint4*>(xs + r * pitch + k) = v;
  }
}

// shared memory a warp's tile takes: 16 rows of kGroupK bytes, and 64
// bytes of slack that a chunk past the group's k may read (its x is zero)
constexpr int kTileBytes = kTileN * kGroupK + 64;

// The block's shared memory: each warp's tile, x staged as T
// [rows_s][pitch], then each warp's mbarrier.
template <typename T>
struct Smem {
  int8_t* tiles;
  T* xs;
  uint32_t bars;
  __device__ Smem(unsigned char* smem, int rows_s, int pitch)
      : tiles(reinterpret_cast<int8_t*>(smem)),
        xs(reinterpret_cast<T*>(smem + kWarps * kTileBytes)),
        bars(smem_u32(smem + kWarps * kTileBytes
                      + rows_s * pitch * (int)sizeof(T))) {}
  __device__ int8_t* tile(int w) const { return tiles + w * kTileBytes; }
  __device__ uint32_t bar(int w) const { return bars + 8 * w; }
};

// warp w's first copy: its first tile's first k group
template <typename T>
__device__ __forceinline__ void first_copy(const Smem<T>& sm, int w,
                                           const int8_t* __restrict__ pack,
                                           int tiles, int N, int K) {
  const int tile = w * gridDim.x + blockIdx.x;
  if (w < kWarps && tile < tiles) {
    copy_tile(sm.tile(w), sm.bar(w), pack, tile, 0,
              K < kGroupK ? K : kGroupK, N, K);
  }
}

// thread 0: every warp's barrier, then the first kAhead warps' copies
template <typename T>
__device__ __forceinline__ void start_copies(const Smem<T>& sm,
                                             const int8_t* __restrict__ pack,
                                             int tiles, int N, int K) {
  if (threadIdx.x != 0) return;
  for (int w = 0; w < kWarps; ++w) mbar_init(sm.bar(w), 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  for (int w = 0; w < kAhead; ++w) first_copy(sm, w, pack, tiles, N, K);
}

constexpr size_t smem_bytes(int rows_s, int pitch_bytes) {
  return (size_t)kWarps * kTileBytes + (size_t)rows_s * pitch_bytes
         + 8 * kWarps;
}

// bf16 x on the tensor cores. Lane (g, t) = (lane / 4, lane % 4) reads pack
// rows g and g + 8 of its tile at k = 64 c + 16 t of chunk c; in k-step s
// its A and B fragments take k = 64 c + 16 t + 4 s + {0, 1, 2, 3} for the
// mma's k-slots {2t, 2t + 1, 2t + 8, 2t + 9}.
template <int NT>
__global__ void __launch_bounds__(kWarps * 32, 1)
w8_matmul_tc_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ pack,
                    const float* __restrict__ sw,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int chunks = (K + kChunkK - 1) / kChunkK;
  const int pitch = chunks * kChunkK + 8;  // bf16 a staged row of x
  const int tiles = (N + kTileN - 1) / kTileN;
  const int step = gridDim.x * kWarps;
  const Smem<__nv_bfloat16> sm(smem, 8 * NT, pitch);
  int8_t* buf = sm.tile(warp);

  int kg = K < kGroupK ? K : kGroupK;
  start_copies(sm, pack, tiles, N, K);
  stage_x(x, K, sm.xs, M, K, 8 * NT, pitch);
  __syncthreads();
  const __nv_bfloat16* xs = sm.xs;

  int tile = warp * gridDim.x + blockIdx.x, k0 = 0;
  uint32_t phase = 0;
  bool chain = true;  // the first landed copy starts warp + kAhead's
  // two sums, even and odd chunks, halve the chain of dependent products
  float acc[2][NT][4] = {};
  while (tile < tiles) {
    mbar_wait(sm.bar(warp), phase);
    if (chain && lane == 0) first_copy(sm, warp + kAhead, pack, tiles, N, K);
    chain = false;
    phase ^= 1;
#pragma unroll 2
    for (int c = 0; c * kChunkK < kg; ++c) {
      const uint4 wa = *reinterpret_cast<const uint4*>(
          buf + g * kg + c * kChunkK + 16 * t);
      const uint4 wb = *reinterpret_cast<const uint4*>(
          buf + (g + 8) * kg + c * kChunkK + 16 * t);
      uint4 xb[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint4* row = reinterpret_cast<const uint4*>(
            xs + (nt * 8 + g) * pitch + k0 + c * kChunkK + 16 * t);
        xb[nt][0] = row[0];
        xb[nt][1] = row[1];
      }
      const uint32_t qa[4] = {wa.x, wa.y, wa.z, wa.w};
      const uint32_t qb[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t a0, a1, a2, a3;
        i8x4_to_bf16(qa[s], a0, a2);  // row g
        i8x4_to_bf16(qb[s], a1, a3);  // row g + 8
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint4& v = xb[nt][s >> 1];
          const uint32_t b0 = (s & 1) ? v.z : v.x;
          const uint32_t b1 = (s & 1) ? v.w : v.y;
          mma_bf16(acc[c & 1][nt], a0, a1, a2, a3, b0, b1);
        }
      }
    }
    __syncwarp();  // the buffer is read: the next copy may overwrite it
    k0 += kg;
    if (k0 >= K) {  // the tile's sums are whole: write them
      const int n0 = tile * kTileN + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = n0 + (e >> 1) * 8, m = nt * 8 + 2 * t + (e & 1);
          if (n < N && m < M) {
            out[(size_t)m * N + n] = __float2bfloat16(
                epilogue(acc[0][nt][e] + acc[1][nt][e], sw, bias, n));
          }
          acc[0][nt][e] = acc[1][nt][e] = 0.f;
        }
      }
      tile += step;
      k0 = 0;
    }
    kg = K - k0 < kGroupK ? K - k0 : kGroupK;
    if (tile < tiles && lane == 0) {
      copy_tile(buf, sm.bar(warp), pack, tile, k0, kg, N, K);
    }
  }
}

// float32 x [M <= 8, K] on the CUDA cores. Lane (q, t) = (lane / 8,
// lane % 8) holds pack rows q, q + 4, q + 8, q + 12 of its tile and takes
// k = 32 j + 4 t + {0, 1, 2, 3} of each 32-k step j.
template <int MT>
__global__ void __launch_bounds__(kWarps * 32, 1)
w8_matmul_f32_kernel(const float* __restrict__ x, int ldx,
                     const int8_t* __restrict__ pack,
                     const float* __restrict__ sw,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int ldo, int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane >> 3, t = lane & 7;
  const int chunks = (K + kChunkK - 1) / kChunkK;
  const int pitch = chunks * kChunkK + 4;  // float32 a staged row of x
  const int tiles = (N + kTileN - 1) / kTileN;
  const int step = gridDim.x * kWarps;
  const Smem<float> sm(smem, MT, pitch);
  int8_t* buf = sm.tile(warp);

  int kg = K < kGroupK ? K : kGroupK;
  start_copies(sm, pack, tiles, N, K);
  stage_x(x, ldx, sm.xs, M, K, MT, pitch);
  __syncthreads();
  const float* xs = sm.xs;

  int tile = warp * gridDim.x + blockIdx.x, k0 = 0;
  uint32_t phase = 0;
  bool chain = true;
  float acc[4][MT] = {};
  while (tile < tiles) {
    mbar_wait(sm.bar(warp), phase);
    if (chain && lane == 0) first_copy(sm, warp + kAhead, pack, tiles, N, K);
    chain = false;
    phase ^= 1;
    // lanes q = 2, 3 start a 32-k step later: their rows lie 32 words
    // from rows q - 2's, which puts the four rows a load reads in four
    // different groups of 8 banks
    const int steps = (kg + 31) / 32;
#pragma unroll 2
    for (int j = 0; j < steps; ++j) {
      int jr = j + (q >> 1);
      if (jr >= steps) jr -= steps;
      const int k = jr * 32 + 4 * t;  // within the group
      float w[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // past the group's k (its last 32-k step may be half full) the
        // bytes are the next row's or slack; x is zero there
        i8x4_to_f32(*reinterpret_cast<const uint32_t*>(
                        buf + (q + 4 * r) * kg + k), w[r]);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float4 xv =
            *reinterpret_cast<const float4*>(xs + m * pitch + k0 + k);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][m] = fmaf(xv.x, w[r][0], acc[r][m]);
          acc[r][m] = fmaf(xv.y, w[r][1], acc[r][m]);
          acc[r][m] = fmaf(xv.z, w[r][2], acc[r][m]);
          acc[r][m] = fmaf(xv.w, w[r][3], acc[r][m]);
        }
      }
    }
    __syncwarp();
    k0 += kg;
    if (k0 >= K) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = tile * kTileN + q + 4 * r;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float v = acc[r][m];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          if (m == t && n < N && m < M) {
            out[(size_t)m * ldo + n] = epilogue(v, sw, bias, n);
          }
          acc[r][m] = 0.f;
        }
      }
      tile += step;
      k0 = 0;
    }
    kg = K - k0 < kGroupK ? K - k0 : kGroupK;
    if (tile < tiles && lane == 0) {
      copy_tile(buf, sm.bar(warp), pack, tile, k0, kg, N, K);
    }
  }
}

int grid_for(int N) {
  const int tiles = (N + kTileN - 1) / kTileN;
  return tiles < device_sm_count() ? tiles : device_sm_count();
}

template <int NT>
int launch_tc(const void* x, const void* pack, const void* sw,
              const void* bias, void* out, int M, int K, int N,
              cudaStream_t stream) {
  const int chunks = (K + kChunkK - 1) / kChunkK;
  const size_t smem = smem_bytes(8 * NT, (chunks * kChunkK + 8) * 2);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(w8_matmul_tc_kernel<NT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  w8_matmul_tc_kernel<NT><<<grid_for(N), kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(pack),
      static_cast<const float*>(sw), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), M, K, N);
  return (int)cudaGetLastError();
}

// rows [m0, m0 + rows) of x and out, rows <= 8
template <int MT>
int launch_f32(const float* x, const void* pack, const void* sw,
               const void* bias, float* out, int rows, int K, int N,
               cudaStream_t stream) {
  const int chunks = (K + kChunkK - 1) / kChunkK;
  const size_t smem = smem_bytes(MT, (chunks * kChunkK + 4) * 4);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(w8_matmul_f32_kernel<MT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  w8_matmul_f32_kernel<MT><<<grid_for(N), kWarps * 32, smem, stream>>>(
      x, K, static_cast<const int8_t*>(pack), static_cast<const float*>(sw),
      static_cast<const float*>(bias), out, N, rows, K, N);
  return (int)cudaGetLastError();
}

int launch_f32_rows(const float* x, const void* pack, const void* sw,
                    const void* bias, float* out, int rows, int K, int N,
                    cudaStream_t s) {
  if (rows <= 1) return launch_f32<1>(x, pack, sw, bias, out, rows, K, N, s);
  if (rows <= 2) return launch_f32<2>(x, pack, sw, bias, out, rows, K, N, s);
  if (rows <= 4) return launch_f32<4>(x, pack, sw, bias, out, rows, K, N, s);
  return launch_f32<8>(x, pack, sw, bias, out, rows, K, N, s);
}

}  // namespace
}  // namespace rtvc

// pack: the [N, K] int8 pack, K-contiguous; K % 16 == 0, x and pack 16-byte
// aligned (the wrapper checks). float32 x runs 8 rows a launch.
extern "C" int rtvc_w8_matmul(const void* x, const void* pack,
                              const void* sw, const void* bias, void* out,
                              int M, int K, int N, int dtype, void* stream) {
  if (M < 1 || M > 32 || K < 16 || K % 16 != 0 || N < 1) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  using namespace rtvc;
  if (dtype == kBFloat16) {
    if (M <= 8) return launch_tc<1>(x, pack, sw, bias, out, M, K, N, s);
    if (M <= 16) return launch_tc<2>(x, pack, sw, bias, out, M, K, N, s);
    return launch_tc<4>(x, pack, sw, bias, out, M, K, N, s);
  }
  for (int m0 = 0; m0 < M; m0 += 8) {
    const int rows = M - m0 < 8 ? M - m0 : 8;
    const int err = launch_f32_rows(
        static_cast<const float*>(x) + (size_t)m0 * K, pack, sw, bias,
        static_cast<float*>(out) + (size_t)m0 * N, rows, K, N, s);
    if (err != 0) return err;
  }
  return 0;
}
